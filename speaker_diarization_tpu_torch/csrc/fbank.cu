// K1 and K1': the spectral front-end kernel, one launch per batch of waveforms.
//
// Replaces speaker_diarization_tpu/kernels/fbank_pallas.py:_frontend_kernel,
// which serves two entries, and so does this kernel:
//
// - K1, kaldi fbank (entry fbank_pallas; here sdt_fbank_f32). Per frame of
//   `win` samples taken every `shift` samples (snip_edges framing):
//     scale -> DC removal -> preemphasis (first sample x0*(1-p)) -> hamming
//     window -> |FFT_n_fft|^2 (bins 0..n_fft/2) -> kaldi mel -> ln(max(., eps))
// - K1', the EEND log-mel (entry logmel_pallas; here sdt_logmel_f32). Frame t
//   is the n_fft samples from t*shift - n_fft/2 (centered framing; samples
//   outside the audio read as zeros, so no padded copy is made):
//     periodic hann of frame_size center-padded to n_fft -> |FFT_n_fft|^2
//     -> slaney mel -> log10(max(., 1e-10))
//   with no scaling, DC removal or preemphasis.
// Mean-norm over time stays outside the kernel, as in the JAX package.
//
// What bounds it on the H100: at the TS-VAD shape (64 x 64000 samples, 16
// kHz, 80 mels) the kernel must read 16.4 MB of audio and write 8.2 MB of
// fbank, about 7.3 us at 3.35 TB/s; at the EEND shape (32 x 400000 samples,
// 8 kHz, 23 mels, 5000 frames each) 51.2 MB and 14.7 MB, about 20 us. The
// arithmetic (a real-input FFT per frame, the window, the mel bands) is 0.39
// and about 1.0 GFLOP of fp32, 6 and 15 us on CUDA cores: the function is
// bound by bytes, and what stands between a kernel and that bound is the
// work each frame does on chip. The first design spent it on a complex
// radix-2 FFT of the real frame through shared memory (about 92 KB of
// shared-memory traffic a frame at n_fft 512, 2-way bank conflicts in the
// early stages, a warp barrier per stage), and on a CTA per 8 frames, each
// staging the window, twiddles and mel table again (more L2 reads than the
// function's own bytes), loading its audio before any math.
//
// Design:
// - A real FFT as a half-length complex one: z[n] = x[2n] + i x[2n+1],
//   M = n_fft/2 points, then the split post-pass X[k] = (Z[k] + conj Z[M-k])/2
//   + W_N^k (Z[k] - conj Z[M-k])/(2i), k = 0..M, one pair of mirrored bins
//   (k, M-k) at a time.
// - Registers first: a frame takes P = M/16 threads, each holding 16 complex
//   points (thread t: z[t + P r], r < 16). Stockham passes of radix 16 (and
//   a last radix of 4, 8, 16, or 2x16 then 2 or 4: kernels/fbank.fft_radices) run
//   in registers; between two passes the points cross one exchange buffer
//   of complex values in shared memory, padded one in 16 so that a pass's
//   stores and loads are free of bank conflicts. After the last pass thread
//   t holds Z[t + P w], w < 16, and Z[M-k] comes from lane (P - t) mod P by
//   shuffle: one shared-memory round trip a frame instead of log2(n_fft).
//   At n_fft 2048 a frame takes P = 64 threads, two warps, which a shuffle
//   cannot join: there the frame's threads meet at a named barrier of their
//   own instead of __syncwarp, and the partner values and the DC sum's two
//   halves cross the frame's exchange buffer (frame_sync, exchange_partners).
// - Twiddles are tables computed on the host in float64 (W_N^k, k < M;
//   W_M^a = W_N^2a, negated past M), never __sinf/__cosf: near-floor bins do
//   not survive that error under the log.
// - Persistent CTAs: the grid is planned in Python (kernels/fbank.launch_plan:
//   up to three CTAs a SM by shared memory, two at n_fft 2048, each a
//   contiguous run of tiles of 8192/n_fft frames, one a frame slot) and
//   checked here. A CTA stages the
//   window, twiddles and the mel table once, and each tile's sample span,
//   overlapping frames read once, by cp.async (16-byte copies where the span
//   is aligned) into a double buffer: the next tile's audio loads while this
//   one is transformed.
// - Power, banded mel and log straight from the spectrum: the tile's power
//   rows stay in shared memory; a lane takes one frame and a warp one or a
//   few filters, summed over each filter's non-zero weights only (broadcast
//   weights, rows on distinct banks); the tile's (frames x n_mels) rows,
//   contiguous in the output, are written by one coalesced copy.
// - fp32 throughout: no TF32 and no bf16 tensor cores (the TPU kernel's bf16
//   hi/lo DFT misses its own bar at 8 kHz / 80 mels, the recipe's front end).
//   The log is log2 on the special-function unit (about 2 ulp), times ln 2
//   or log10 2.
// With all of that the kernel is bound by its own instruction issue, not by
// bytes: the audio's staging overlaps the transform, and what is left is the
// FFT's, the post-pass's and the mel bands' arithmetic, shared-memory traffic
// and indexing (PERF.md).

#include <climits>
#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kPoints = 16;    // complex points a thread holds
constexpr int kMinCtasPerSm = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemLimit = 232448;  // bytes one block may use on sm_90
constexpr float kInt16Scale = 32768.f;  // kaldi's samples are int16 values

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }
// exchange-buffer index: one complex value of padding after every 16
__host__ __device__ constexpr int xpad(int i) { return i + (i >> 4); }
// radix of the last pass over M points: 16s first (kernels/fbank.fft_radices)
__host__ __device__ constexpr int last_radix(int M) {
  int ns = 1;
  while (ns * kPoints < M) ns *= kPoints;
  return M / ns;
}

// Row stride of a tile's power spectra [frame][bin]: odd, so that the mel
// stage's lanes (one frame each) read 32 banks, and = P + 1 mod 32, so that
// the post-pass's stores (P lanes a frame on consecutive bins, 32/P frames a
// warp; at P = 64 a warp stores 32 consecutive bins of one frame) nearly
// never share a bank.
__host__ __device__ constexpr int pow_stride(int M) {
  int s = M + 1;
  while (s % 32 != (M / kPoints + 1) % 32) ++s;
  return s;
}

// float offsets into one CTA's dynamic shared memory (kernels/fbank.smem_bytes);
// F = 4096 / M frames a tile, one a slot. After the FFT passes the exchange
// region holds the tile's power spectra (pow), then its mel rows (mel).
struct Layout {
  int span, window, wm, wn, melw, mels, x, pow, mel, total;
};

__host__ __device__ inline Layout make_layout(int F, int frame_len, int shift, int n_fft, int n_mels,
                                              int mel_len) {
  const int half = n_fft / 2;
  const int exch = align4(kThreads * kPoints / half * xpad(half));
  Layout L;
  L.span = align4((F - 1) * shift + frame_len);  // two of them, from offset 0
  L.window = 2 * L.span;
  L.wm = L.window + align4(n_fft);
  L.wn = L.wm + 2 * half;
  L.melw = L.wn + 2 * half;
  L.mels = L.melw + align4(n_mels * mel_len);
  L.x = L.mels + align4(2 * n_mels);
  L.pow = L.x;
  L.mel = L.pow + align4(F * pow_stride(half));
  const int tail = L.mel - L.x + align4(F * n_mels);
  L.total = L.x + (tail > 2 * exch ? tail : 2 * exch);
  return L;
}

size_t smem_bytes(int F, int frame_len, int shift, int n_fft, int n_mels, int mel_len) {
  return sizeof(float) * (size_t)make_layout(F, frame_len, shift, n_fft, n_mels, mel_len).total;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// W16^e = exp(-2 pi i e / 16), e < 8
__device__ __forceinline__ float w16r(int e) {
  switch (e) {
    case 0: return 1.f;
    case 1: return 0.923879532511286756f;
    case 2: return 0.707106781186547524f;
    case 3: return 0.382683432365089772f;
    case 4: return 0.f;
    case 5: return -0.382683432365089772f;
    case 6: return -0.707106781186547524f;
    default: return -0.923879532511286756f;
  }
}
__device__ __forceinline__ float w16i(int e) {
  switch (e) {
    case 0: return 0.f;
    case 1: return -0.382683432365089772f;
    case 2: return -0.707106781186547524f;
    case 3: return -0.923879532511286756f;
    case 4: return -1.f;
    case 5: return -0.923879532511286756f;
    case 6: return -0.707106781186547524f;
    default: return -0.382683432365089772f;
  }
}

// Every thread of a frame has reached this point, and its shared-memory
// accesses before it are seen by the frame's threads after it: __syncwarp
// where a frame lies in one warp (P <= 32); else a named barrier over the
// frame's P threads, one per frame slot f (ids 1 .. kThreads / P; 0 is
// __syncthreads').
template <int P>
__device__ __forceinline__ void frame_sync(int f) {
  static_assert(P <= 32 || (P % 32 == 0 && kThreads / P < 16), "a frame is one warp or whole warps");
  if constexpr (P <= 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(f + 1), "n"(P) : "memory");
  }
}

// in-register DFT of R points, natural order in and out (radix-2 decimation
// in time; the products by 1 and -i are left out)
template <int R>
__device__ __forceinline__ void dft(float* re, float* im) {
  if constexpr (R > 1) {
    float er[R / 2], ei[R / 2], orr[R / 2], oi[R / 2];
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      er[i] = re[2 * i];
      ei[i] = im[2 * i];
      orr[i] = re[2 * i + 1];
      oi[i] = im[2 * i + 1];
    }
    dft<R / 2>(er, ei);
    dft<R / 2>(orr, oi);
#pragma unroll
    for (int k = 0; k < R / 2; ++k) {
      const int e = k * (16 / R);
      float tr, ti;
      if (e == 0) {
        tr = orr[k];
        ti = oi[k];
      } else if (e == 4) {
        tr = oi[k];
        ti = -orr[k];
      } else {
        tr = orr[k] * w16r(e) - oi[k] * w16i(e);
        ti = orr[k] * w16i(e) + oi[k] * w16r(e);
      }
      re[k] = er[k] + tr;
      im[k] = ei[k] + ti;
      re[k + R / 2] = er[k] - tr;
      im[k + R / 2] = ei[k] - ti;
    }
  }
}

// The Stockham passes after the first, over the M points of one frame whose
// first pass (radix 16, sub-transforms of NS = 1) left its output in the
// exchange buffer xc. Thread t runs butterflies j = t + P u, u < 16/R:
// inputs j + (M/R) q, twiddle W_M^((j mod NS) q M/(NS R)), outputs
// (j/NS) NS R + j mod NS + NS q. The last pass keeps its output in registers.
template <int M, int NS>
__device__ __forceinline__ void later_passes(float (&re)[kPoints], float (&im)[kPoints], float2* xc, const float2* wm,
                                             int t, int f) {
  constexpr int P = M / kPoints;
  constexpr int R = M / NS < kPoints ? M / NS : kPoints;
  constexpr int NB = kPoints / R;
#pragma unroll
  for (int u = 0; u < NB; ++u) {
    const int j = t + P * u;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const float2 v = xc[xpad(j + (M / R) * q)];
      re[u * R + q] = v.x;
      im[u * R + q] = v.y;
    }
  }
#pragma unroll
  for (int u = 0; u < NB; ++u) {
    const int j = t + P * u;
#pragma unroll
    for (int q = 1; q < R; ++q) {
      const int w = (j % NS) * q * (M / (NS * R));
      const float vr = re[u * R + q], vi = im[u * R + q];
      const float2 tw = wm[w];
      re[u * R + q] = vr * tw.x - vi * tw.y;
      im[u * R + q] = vr * tw.y + vi * tw.x;
    }
    dft<R>(re + u * R, im + u * R);
  }
  if constexpr (NS * R < M) {
    frame_sync<P>(f);  // every thread of the frame has read its inputs
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int j = t + P * u;
      const int dst = (j / NS) * NS * R + j % NS;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        xc[xpad(dst + NS * q)] = make_float2(re[u * R + q], im[u * R + q]);
      }
    }
    frame_sync<P>(f);
    later_passes<M, NS * R>(re, im, xc, wm, t, f);
  }
}

// register of thread t that holds Z[t + P w] after the last pass
template <int M>
__device__ __forceinline__ constexpr int reg_of(int w) {
  return (w % (kPoints / last_radix(M))) * last_radix(M) + w / (kPoints / last_radix(M));
}

// 2 X[k] = E - V and 2 X[M-k] = conj(E + V), with E = Z[k] + conj Z[M-k],
// D = Z[k] - conj Z[M-k], V = i W_N^k D: their squared magnitudes (4 |X|^2)
// into pw[k] and pw[M-k]
template <int M>
__device__ __forceinline__ void mirrored_pair(float ar, float ai, float pr, float pi, float* pw, const float2* wn,
                                              int k) {
  const float er = ar + pr, ei = ai - pi;
  const float dr = ar - pr, di = ai + pi;
  const float2 w = wn[k];
  const float wr = w.x, wi = w.y;
  const float vr = -(wr * di + wi * dr), vi = wr * dr - wi * di;
  pw[k] = (er - vr) * (er - vr) + (ei - vi) * (ei - vi);
  pw[M - k] = (er + vr) * (er + vr) + (ei + vi) * (ei + vi);  // the same bin where k = M/2
}

// Z[M-k] for thread t's bins k = t + P w, w < 8, at P > 32 (a frame of
// several warps): thread (P - t) mod P holds it in register reg_of(15 - w)
// (thread 0 holds its own partners). Each thread puts those 8 values into
// the slot's exchange buffer, which the last pass has finished reading, and
// reads its partner's, before the barrier after which the buffer holds the
// tile's power spectra.
template <int M>
__device__ __forceinline__ void exchange_partners(const float (&re)[kPoints], const float (&im)[kPoints],
                                                  float (&pr)[kPoints / 2], float (&pi)[kPoints / 2], float2* xc,
                                                  int t, int f) {
  constexpr int P = M / kPoints;
  const int src = (P - t) & (P - 1);
  frame_sync<P>(f);  // every thread of the frame has read the last pass's inputs
#pragma unroll
  for (int w = 0; w < kPoints / 2; ++w)
    xc[xpad(P * w + t)] = make_float2(re[reg_of<M>(15 - w)], im[reg_of<M>(15 - w)]);
  frame_sync<P>(f);
#pragma unroll
  for (int w = 0; w < kPoints / 2; ++w) {
    const float2 v = xc[xpad(P * w + src)];
    pr[w] = v.x;
    pi[w] = v.y;
    if (t == 0) {
      pr[w] = re[reg_of<M>((16 - w) & 15)];
      pi[w] = im[reg_of<M>((16 - w) & 15)];
    }
  }
}

// 4 |X[k]|^2 into pw[k], k = 0..M: the split post-pass, one pair of mirrored
// bins at a time. Thread t takes k = t + P w, w < 8, with Z[M-k] from lane
// (P - t) mod P (thread 0 holds its own partners); its partner's w >= 8
// bins are its mirrors, and k = M/2, its own mirror, is thread 0's w = 8.
// At P > 32 exchange_partners has already put the partners into pr, pi.
template <int M>
__device__ __forceinline__ void power_spectrum(const float (&re)[kPoints], const float (&im)[kPoints],
                                               float (&pr)[kPoints / 2], float (&pi)[kPoints / 2], float* pw,
                                               const float2* wn, int t) {
  constexpr int P = M / kPoints;
  if constexpr (P <= 32) {
    const int src = (P - t) & (P - 1);
#pragma unroll
    for (int w = 0; w < kPoints / 2; ++w) {
      pr[w] = __shfl_sync(kFull, re[reg_of<M>(15 - w)], src, P);
      pi[w] = __shfl_sync(kFull, im[reg_of<M>(15 - w)], src, P);
      if (t == 0) {
        pr[w] = re[reg_of<M>((16 - w) & 15)];
        pi[w] = im[reg_of<M>((16 - w) & 15)];
      }
    }
  }
#pragma unroll
  for (int w = 0; w < kPoints / 2; ++w)
    mirrored_pair<M>(re[reg_of<M>(w)], im[reg_of<M>(w)], pr[w], pi[w], pw, wn, t + P * w);
  if (t == 0) {
    const float ar = re[reg_of<M>(8)], ai = im[reg_of<M>(8)];
    mirrored_pair<M>(ar, ai, ar, ai, pw, wn, M / 2);
  }
}

// KALDI: K1 (frames of frame_len samples from t*shift, scaled to int16, DC
// removed, preemphasized; natural log, floor FLT_EPSILON); else K1' (frames
// of n_fft samples from t*shift - n_fft/2; log10, floor 1e-10)
// n_fft 2048's tile takes more than a third of an SM's shared memory: two
// CTAs an SM, so its instances may use more registers
template <int M, bool KALDI>
__global__ void __launch_bounds__(kThreads, M > 512 ? 2 : kMinCtasPerSm)
fbank_kernel(const float* __restrict__ x, float* __restrict__ out, const float* __restrict__ window,
             const float* __restrict__ tw_re, const float* __restrict__ tw_im, const float* __restrict__ mel_w,
             const int* __restrict__ mel_start, const int* __restrict__ mel_band, int N, int T, int frame_len,
             int shift, int n_mels, int mel_len, int F, int tiles_per_wave, int n_tiles, float preemph) {
  constexpr int P = M / kPoints;  // threads of a frame
  constexpr int n_fft = 2 * M;
  constexpr int kSlots = kThreads / P;  // frames a CTA transforms at once: F
  constexpr int pad = KALDI ? 0 : M;
  if constexpr (!KALDI) frame_len = n_fft;
  extern __shared__ __align__(16) float smem[];
  const Layout L = make_layout(F, frame_len, shift, n_fft, n_mels, mel_len);
  float* s_win = smem + L.window;
  float2* wm = reinterpret_cast<float2*>(smem + L.wm);  // W_M^a
  float2* wn = reinterpret_cast<float2*>(smem + L.wn);  // W_N^k, k < M
  float* s_melw = smem + L.melw;
  int* s_mels = reinterpret_cast<int*>(smem + L.mels);  // first non-zero bin of filter m
  int* s_mlen = s_mels + n_mels;                          // its count of non-zero bins

  // this CTA's contiguous run of tiles (FbankPlan.cta_tiles)
  const int per = n_tiles / (int)gridDim.x, rem = n_tiles % (int)gridDim.x;
  const int first = (int)blockIdx.x * per + min((int)blockIdx.x, rem);
  const int last = first + per + ((int)blockIdx.x < rem ? 1 : 0);
  if (first >= last) return;

  // sample i of a tile's span is audio sample t0*shift - pad + i of its
  // waveform; outside the audio, i < lo or i >= hi, it reads as zero
  // (centered frames at both ends; the kaldi entry never reads outside).
  // Where the span's start lies on 16 bytes, as with every waveform length
  // a multiple of 4, its inside goes by 16-byte copies.
  auto stage = [&](int tile, float* dst) {
    const int b = tile / tiles_per_wave, t0 = (tile % tiles_per_wave) * F;
    const int span = (min(F, T - t0) - 1) * shift + frame_len;
    const int base = t0 * shift - pad;
    const int lo = max(0, -base), hi = min(span, N - base);
    const float* src = x + (size_t)b * N + base;  // src[i] for lo <= i < hi
    for (int i = threadIdx.x; i < lo; i += kThreads) dst[i] = 0.f;
    for (int i = hi + threadIdx.x; i < span; i += kThreads) dst[i] = 0.f;
    int vlo = hi, vhi = hi;  // the 16-byte part [vlo, vhi)
    if ((((size_t)b * N + base) & 3) == 0) {
      vlo = min((lo + 3) & ~3, hi);
      vhi = max(vlo, hi & ~3);
      for (int c = (vlo >> 2) + threadIdx.x; c < (vhi >> 2); c += kThreads)
        cp_async16(dst + 4 * c, src + 4 * c);
    }
    for (int i = lo + threadIdx.x; i < vlo; i += kThreads) cp_async4(dst + i, src + i);
    for (int i = vhi + threadIdx.x; i < hi; i += kThreads) cp_async4(dst + i, src + i);
    cp_async_commit();
  };
  stage(first, smem);

  // the tables, once per CTA, while the first tile loads
  for (int i = threadIdx.x; i < n_fft; i += kThreads) s_win[i] = i < frame_len ? window[i] : 0.f;
  for (int a = threadIdx.x; a < M; a += kThreads) {
    const int k = 2 * a;  // W_M^a = W_N^2a, and W_N^k = -W_N^(k-M)
    wm[a] = k < M ? make_float2(tw_re[k], tw_im[k]) : make_float2(-tw_re[k - M], -tw_im[k - M]);
    wn[a] = make_float2(tw_re[a], tw_im[a]);
  }
  // filter m's non-zero weights are mel_w[m][q0 + q], q < n (mel_band[m] =
  // (q0, n)): kept as [q][m] from q0 on, so a frame's lanes read consecutive
  // banks, and scaled by 1/4 (exact) for the power's 4 |X|^2
  for (int i = threadIdx.x; i < n_mels * mel_len; i += kThreads) {
    const int m = i / mel_len, q = i - m * mel_len - mel_band[2 * m];
    if (q >= 0) s_melw[q * n_mels + m] = 0.25f * mel_w[i];
  }
  for (int m = threadIdx.x; m < n_mels; m += kThreads) {
    s_mels[m] = mel_start[m] + mel_band[2 * m];
    s_mlen[m] = mel_band[2 * m + 1];
  }

  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & (P - 1);
  const int f = threadIdx.x / P;  // the slot's frame of every tile
  float2* xc = reinterpret_cast<float2*>(smem + L.x) + f * xpad(M);  // the slot's exchange buffer
  float* s_pow = smem + L.pow;
  float* s_out = smem + L.mel;
  constexpr int PS = pow_stride(M);
  const bool pairs = (shift & 1) == 0;  // frames start at even offsets: sample pairs are float2s

  for (int tile = first; tile < last; ++tile) {
    const float* cur = smem + ((tile - first) & 1) * L.span;
    if (tile + 1 < last) {
      stage(tile + 1, smem + ((tile + 1 - first) & 1) * L.span);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int b = tile / tiles_per_wave, t0 = (tile % tiles_per_wave) * F;
    const int nf = min(F, T - t0);
    // a warp whose frames all lie past the tile's end skips the transform
    // (at P = 64 both warps of a frame skip it or neither)
    const bool busy = warp * 32 / P < nf;
    const bool active = f < nf;
    const float* fr = cur + f * shift;  // f < F: reads stay inside the buffer
    float re[kPoints], im[kPoints], pr[kPoints / 2], pi[kPoints / 2];
    if (busy) {
      // pass 1's inputs: z[t + P r] = (x[2n], x[2n+1]) at n = t + P r
#pragma unroll
      for (int r = 0; r < kPoints; ++r) {
        const int p = 2 * (t + P * r);
        float a = 0.f, c = 0.f;
        if (active && (!KALDI || p < frame_len)) {
          if (pairs) {
            const float2 v = *reinterpret_cast<const float2*>(fr + p);
            a = v.x;
            c = v.y;
          } else {
            a = fr[p];
            c = fr[p + 1];
          }
          if (KALDI && p + 1 >= frame_len) c = 0.f;
        }
        re[r] = a;
        im[r] = c;
      }
      if constexpr (KALDI) {
        float sum = 0.f;
#pragma unroll
        for (int r = 0; r < kPoints; ++r) {
          re[r] *= kInt16Scale;
          im[r] *= kInt16Scale;
          sum += re[r] + im[r];
        }
        if constexpr (P <= 32) {
#pragma unroll
          for (int o = P / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o, P);
        } else {
          // each warp's half, then the two halves in order through the last
          // float2 of the slot's exchange buffer, which no pass writes
          static_assert(P == 64, "a frame of two warps");
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
          float* halves = reinterpret_cast<float*>(xc + xpad(M) - 1);
          if ((t & 31) == 0) halves[t >> 5] = sum;
          frame_sync<P>(f);
          sum = halves[0] + halves[1];
        }
        const float mean = sum / (float)frame_len;
#pragma unroll
        for (int r = 0; r < kPoints; ++r) {
          const int p = 2 * (t + P * r);
          float a = re[r] - mean, c = im[r] - mean;
          if (preemph != 0.f) {
            c -= preemph * a;
            const float prev = (active && p > 0 && p < frame_len) ? fr[p - 1] * kInt16Scale - mean : 0.f;
            a = p == 0 ? a * (1.f - preemph) : a - preemph * prev;
          }
          re[r] = a;
          im[r] = c;
        }
      }
#pragma unroll
      for (int r = 0; r < kPoints; ++r) {
        const float2 w = *reinterpret_cast<const float2*>(s_win + 2 * (t + P * r));  // zeros past frame_len
        re[r] *= w.x;
        im[r] *= w.y;
      }

      // pass 1: radix 16 in registers (NS = 1: no twiddles), out to 16 t + q
      dft<kPoints>(re, im);
#pragma unroll
      for (int q = 0; q < kPoints; ++q) {
        xc[xpad(kPoints * t + q)] = make_float2(re[q], im[q]);
      }
      frame_sync<P>(f);
      later_passes<M, kPoints>(re, im, xc, wm, t, f);
      if constexpr (P > 32) exchange_partners<M>(re, im, pr, pi, xc, t, f);
    }
    __syncthreads();  // every slot has read its exchange buffer: it now takes the tile's power
    if (busy) power_spectrum<M>(re, im, pr, pi, s_pow + f * PS, wn, t);  // rows past nf are never read
    __syncthreads();

    // mel bands over each filter's non-zero weights, in two chains; floor
    // and log. Lane i of the CTA takes frame i mod F and filters i / F +
    // (256 / F) j: a warp reads one or a few filters' weights (broadcast) for
    // up to 32 frames whose power rows start on distinct banks.
    {
      const int fm = threadIdx.x % kSlots;
      if (fm < nf) {
        const float* pw = s_pow + fm * PS;
        for (int m = threadIdx.x / kSlots; m < n_mels; m += kThreads / kSlots) {
          const float* p = pw + s_mels[m];
          const float* wm = s_melw + m;
          const int n = s_mlen[m];
          float a0 = 0.f, a1 = 0.f;
          int q = 0;
          for (; q + 1 < n; q += 2) {
            a0 = fmaf(wm[q * n_mels], p[q], a0);
            a1 = fmaf(wm[(q + 1) * n_mels], p[q + 1], a1);
          }
          if (q < n) a0 = fmaf(wm[q * n_mels], p[q], a0);
          // log via log2 (MUFU.LG2: ~2 ulp of log2, far below the bars)
          const float l2 = __log2f(fmaxf(a0 + a1, KALDI ? FLT_EPSILON : 1e-10f));
          s_out[fm * n_mels + m] = l2 * (KALDI ? 0.693147180559945309f : 0.301029995663981195f);
        }
      }
    }
    __syncthreads();
    // the tile's rows are contiguous in out: one coalesced copy
    float* ot = out + ((size_t)b * T + t0) * n_mels;
    for (int i = threadIdx.x; i < nf * n_mels; i += kThreads) ot[i] = s_out[i];
    __syncthreads();  // before the next stage and pass 1 overwrite this buffer and s_out
  }
}

template <int M, bool KALDI>
int run(const float* x, float* out, const float* window, const float* tw_re, const float* tw_im,
        const float* mel_w, const int* mel_start, const int* mel_band, int N, int T, int frame_len, int shift,
        int n_mels, int mel_len, int grid, int F, int tiles_per_wave, int n_tiles, int smem, float preemph,
        cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(fbank_kernel<M, KALDI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fbank_kernel<M, KALDI><<<grid, kThreads, smem, stream>>>(x, out, window, tw_re, tw_im, mel_w, mel_start,
                                                           mel_band, N, T, frame_len, shift, n_mels, mel_len, F,
                                                           tiles_per_wave, n_tiles, preemph);
  return (int)cudaGetLastError();
}

// The launch plan (kernels/fbank.launch_plan: grid, frames per tile, shared
// memory) is checked, not trusted: anything else is refused before a launch.
template <bool KALDI>
int launch(const void* x, void* out, const void* window, const void* tw_re, const void* tw_im, const void* mel_w,
           const void* mel_start, const void* mel_band, int B, int N, int T, int frame_len, int shift, int n_fft,
           int n_mels, int mel_len, float preemph, int grid, int F, int smem,
           void* stream) {
  if (n_fft != 128 && n_fft != 256 && n_fft != 512 && n_fft != 1024 && n_fft != 2048)
    return (int)cudaErrorInvalidValue;
  const int slots = kThreads * kPoints / (n_fft / 2);
  if (B < 1 || N < 1 || T < 1 || F != slots || grid < 1 || shift < 1 || frame_len < 1 ||
      frame_len > n_fft || n_mels < 1 || mel_len < 1 || mel_len > n_fft / 2 + 1)
    return (int)cudaErrorInvalidValue;
  if ((size_t)smem != smem_bytes(F, frame_len, shift, n_fft, n_mels, mel_len) || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const int tiles_per_wave = (T + F - 1) / F;
  const long long n_tiles = (long long)B * tiles_per_wave;
  if (n_tiles > INT_MAX || grid > n_tiles) return (int)cudaErrorInvalidValue;
  const auto* xf = (const float*)x;
  auto* of = (float*)out;
  const auto *wf = (const float*)window, *tr = (const float*)tw_re, *ti = (const float*)tw_im;
  const auto* mw = (const float*)mel_w;
  const auto *ms = (const int*)mel_start, *mb = (const int*)mel_band;
  const auto st = (cudaStream_t)stream;
  const int nt = (int)n_tiles;
#define SDT_RUN(M)                                                                                                   \
  run<M, KALDI>(xf, of, wf, tr, ti, mw, ms, mb, N, T, frame_len, shift, n_mels, mel_len, grid, F, tiles_per_wave, nt, \
                smem, preemph, st)
  switch (n_fft) {
    case 128: return SDT_RUN(64);
    case 256: return SDT_RUN(128);
    case 512: return SDT_RUN(256);
    case 1024: return SDT_RUN(512);
    case 2048: return SDT_RUN(1024);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SDT_RUN
}

}  // namespace

extern "C" {

const char* sdt_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

size_t sdt_fbank_smem_bytes(int frames_per_tile, int frame_len, int shift, int n_fft, int n_mels, int mel_len) {
  return smem_bytes(frames_per_tile, frame_len, shift, n_fft, n_mels, mel_len);
}

// K1: kaldi fbank, snip_edges frames of `win` samples, natural log
int sdt_fbank_f32(const void* x, void* out, const void* window, const void* tw_re, const void* tw_im,
                  const void* mel_w, const void* mel_start, const void* mel_band, int B, int N, int T, int win,
                  int shift, int n_fft, int n_mels, int mel_len, float preemph, int grid,
                  int frames_per_tile, int smem, void* stream) {
  return launch<true>(x, out, window, tw_re, tw_im, mel_w, mel_start, mel_band, B, N, T, win, shift, n_fft, n_mels,
                      mel_len, preemph, grid, frames_per_tile, smem, stream);
}

// K1': EEND log-mel, centered n_fft frames (window already center-padded to
// n_fft), T = count_frames(N, shift) passed in, log10 with a 1e-10 floor
int sdt_logmel_f32(const void* x, void* out, const void* window, const void* tw_re, const void* tw_im,
                   const void* mel_w, const void* mel_start, const void* mel_band, int B, int N, int T, int shift,
                   int n_fft, int n_mels, int mel_len, int grid, int frames_per_tile, int smem, void* stream) {
  return launch<false>(x, out, window, tw_re, tw_im, mel_w, mel_start, mel_band, B, N, T, n_fft, shift, n_fft,
                       n_mels, mel_len, 0.f, grid, frames_per_tile, smem, stream);
}

}  // extern "C"
