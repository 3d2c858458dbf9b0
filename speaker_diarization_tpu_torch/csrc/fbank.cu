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
// arithmetic the function needs (a real-input FFT per frame) is 0.39 and
// about 1.0 GFLOP of fp32, 6 and 15 us on CUDA cores, so both entries are
// bound by bytes. This kernel's complex radix-2 FFT of the real frame does
// about twice that arithmetic.
// Design: the TPU kernel's DFT-as-matmul with bf16 hi/lo splits existed to
// feed the MXU; here the spectrum is an fp32 radix-2 FFT in shared memory,
// some 15x fewer operations than the dense DFT and fully fp32 (no TF32, which
// would blow up near-floor mel bins under the log). One block takes 8
// consecutive frames of one waveform: it loads their overlapping samples
// once into shared memory, then each warp transforms one frame with only
// warp-level synchronisation. The mel projection uses each filter's
// non-zero band only (a few dozen bins at most; slaney filters widen with
// frequency), held in shared memory.

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int kFramesPerBlock = 8;  // one warp per frame
constexpr int kThreads = kFramesPerBlock * 32;

__global__ void __launch_bounds__(kThreads)
fbank_kernel(const float* __restrict__ x, float* __restrict__ out,
             const float* __restrict__ window, const float* __restrict__ tw_re,
             const float* __restrict__ tw_im, const float* __restrict__ mel_w,
             const int* __restrict__ mel_start, int N, int T, int win, int shift,
             int n_fft, int log2n, int n_mels, int mel_len, float scale,
             float preemph, int remove_dc, int pad, float floor_val, int log10_out) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFramesPerBlock;
  const int nf = min(kFramesPerBlock, T - t0);
  const int span = (nf - 1) * shift + win;
  const int half = n_fft / 2;

  float* raw = smem;                                       // (kFramesPerBlock-1)*shift + win
  float* s_win = raw + (kFramesPerBlock - 1) * shift + win;  // win
  float* s_twr = s_win + win;                              // half
  float* s_twi = s_twr + half;                             // half
  float* s_mel = s_twi + half;                             // n_mels * mel_len
  int* s_mst = reinterpret_cast<int*>(s_mel + n_mels * mel_len);  // n_mels
  float* cbuf = reinterpret_cast<float*>(s_mst + n_mels);  // kFramesPerBlock * 2 * n_fft

  // sample i of the block's span is audio sample t0*shift - pad + i; the
  // kaldi entry (pad 0) never reads outside the audio, the centered one does
  const float* xb = x + (size_t)b * N;
  const long long base = (long long)t0 * shift - pad;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const long long idx = base + i;
    raw[i] = (idx >= 0 && idx < N) ? xb[idx] * scale : 0.f;
  }
  for (int i = threadIdx.x; i < win; i += kThreads) s_win[i] = window[i];
  for (int i = threadIdx.x; i < half; i += kThreads) {
    s_twr[i] = tw_re[i];
    s_twi[i] = tw_im[i];
  }
  for (int i = threadIdx.x; i < n_mels * mel_len; i += kThreads) s_mel[i] = mel_w[i];
  for (int i = threadIdx.x; i < n_mels; i += kThreads) s_mst[i] = mel_start[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= nf) return;  // only warp-level synchronisation below

  const float* fr = raw + warp * shift;
  float* re = cbuf + warp * 2 * n_fft;
  float* im = re + n_fft;

  float mean = 0.f;
  if (remove_dc) {
    float s = 0.f;
    for (int n = lane; n < win; n += 32) s += fr[n];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    mean = s / (float)win;
  }
  // preprocessed, windowed frame, zero-padded to n_fft, stored bit-reversed
  for (int n = lane; n < n_fft; n += 32) {
    float v = 0.f;
    if (n < win) {
      const float d = fr[n] - mean;
      v = (n == 0) ? d * (1.f - preemph) : d - preemph * (fr[n - 1] - mean);
      v *= s_win[n];
    }
    const int r = (int)(__brev((unsigned)n) >> (32 - log2n));
    re[r] = v;
    im[r] = 0.f;
  }
  __syncwarp();

  // iterative radix-2 decimation-in-time FFT; twiddle(pos, span m) = tw[pos * n_fft/m]
  for (int s = 1; s <= log2n; ++s) {
    const int hm = 1 << (s - 1);
    const int stride = n_fft >> s;
    for (int j = lane; j < half; j += 32) {
      const int pos = j & (hm - 1);
      const int i1 = ((j >> (s - 1)) << s) + pos;
      const int i2 = i1 + hm;
      const float wr = s_twr[pos * stride], wi = s_twi[pos * stride];
      const float xr = re[i2], xi = im[i2];
      const float tr = wr * xr - wi * xi;
      const float ti = wr * xi + wi * xr;
      const float ar = re[i1], ai = im[i1];
      re[i2] = ar - tr;
      im[i2] = ai - ti;
      re[i1] = ar + tr;
      im[i1] = ai + ti;
    }
    __syncwarp();
  }
  for (int k = lane; k <= half; k += 32) re[k] = re[k] * re[k] + im[k] * im[k];
  __syncwarp();

  float* ob = out + ((size_t)b * T + t0 + warp) * n_mels;
  for (int m = lane; m < n_mels; m += 32) {
    const float* w = s_mel + m * mel_len;
    const float* p = re + s_mst[m];
    float acc = 0.f;
    for (int q = 0; q < mel_len; ++q) acc += w[q] * p[q];
    acc = fmaxf(acc, floor_val);
    ob[m] = log10_out ? log10f(acc) : logf(acc);
  }
}

}  // namespace

extern "C" {

const char* sdt_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

size_t sdt_fbank_smem_bytes(int win, int shift, int n_fft, int n_mels, int mel_len) {
  return sizeof(float) * ((size_t)(kFramesPerBlock - 1) * shift + win + win + n_fft +
                          (size_t)n_mels * mel_len + n_mels + (size_t)kFramesPerBlock * 2 * n_fft);
}

static int launch(const void* x, void* out, const void* window, const void* tw_re,
                  const void* tw_im, const void* mel_w, const void* mel_start, int B, int N,
                  int T, int win, int shift, int n_fft, int log2n, int n_mels, int mel_len,
                  float scale, float preemph, int remove_dc, int pad, float floor_val,
                  int log10_out, void* stream) {
  const size_t smem = sdt_fbank_smem_bytes(win, shift, n_fft, n_mels, mel_len);
  cudaError_t err = cudaFuncSetAttribute(fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kFramesPerBlock - 1) / kFramesPerBlock, B);
  fbank_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, (const float*)window, (const float*)tw_re,
      (const float*)tw_im, (const float*)mel_w, (const int*)mel_start, N, T, win, shift, n_fft,
      log2n, n_mels, mel_len, scale, preemph, remove_dc, pad, floor_val, log10_out);
  return (int)cudaGetLastError();
}

// K1: kaldi fbank, snip_edges frames of `win` samples, natural log
int sdt_fbank_f32(const void* x, void* out, const void* window, const void* tw_re,
                  const void* tw_im, const void* mel_w, const void* mel_start, int B, int N,
                  int T, int win, int shift, int n_fft, int log2n, int n_mels, int mel_len,
                  float scale, float preemph, int remove_dc, void* stream) {
  return launch(x, out, window, tw_re, tw_im, mel_w, mel_start, B, N, T, win, shift, n_fft, log2n,
                n_mels, mel_len, scale, preemph, remove_dc, 0, FLT_EPSILON, 0, stream);
}

// K1': EEND log-mel, centered n_fft frames (window already center-padded to
// n_fft), T = count_frames(N, shift) passed in, log10 with a 1e-10 floor
int sdt_logmel_f32(const void* x, void* out, const void* window, const void* tw_re,
                   const void* tw_im, const void* mel_w, const void* mel_start, int B, int N,
                   int T, int shift, int n_fft, int log2n, int n_mels, int mel_len, void* stream) {
  return launch(x, out, window, tw_re, tw_im, mel_w, mel_start, B, N, T, n_fft, shift, n_fft, log2n,
                n_mels, mel_len, 1.f, 0.f, 0, n_fft / 2, 1e-10f, 1, stream);
}

}  // extern "C"
