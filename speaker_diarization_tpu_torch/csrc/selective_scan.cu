// K3a/K3b/K3c: the Mamba S6 selective scan, forward and backward.
//
// Replaces speaker_diarization_tpu/kernels/selective_scan_pallas.py:
//   K3a  _scan_kernel               (entry selective_scan_pallas)
//   K3b  _scan_kernel_with_states   (entry _pallas_fwd_with_states)
//   K3c  _scan_bwd_kernel           (entry _pallas_bwd)
// For x, dt (B, T, D), A (D, N), Bm, Cm (B, T, N), Dp (D,), all fp32:
//   h_t = exp(dt_t (x) A) . h_{t-1} + Bm_t (x) (dt_t x_t),   h_{-1} = 0
//   y_t = Cm_t . h_t + Dp . x_t
// K3b also stores the state at the start of every chunk of kChunk steps,
// h0 (B * n_chunks, N, D) (the JAX layout); K3c takes h0 and dy and returns
// dx, ddt, dA, dB, dC, dD.
//
// exp: every decay is exp2f(dt * A2) with A2 = A * log2(e) pre-scaled once per
// thread (ex2 on the special-function units, at most 2 ulp); the pre-scaling
// adds a relative error of about |dt A| * 6e-8 to each decay. The plain twins
// use torch.exp, so kernel and twin differ by a few ulp per step.
//
// What bounds it on the H100: at the main-path shape (B = 256, T = 100,
// D = 768, N = 64) K3a must move about 249 MB (x, dt, y and Bm, Cm), 0.074 ms
// at 3.35 TB/s, but needs B*T*D*N = 1.26e9 exponentials, about 0.30 ms at the
// SFUs' 16 per SM per clock: it is bound by operations, the exponentials.
//
// Design. The TPU kernel walked a (batch, time-chunk) grid in order and
// carried the (N, D) state in VMEM between grid steps; CUDA blocks run in no
// order, so here the time loop runs inside the block:
// - K3a/K3b: a block owns (one batch row, 128 channels) for the whole T; each
//   thread holds the N states of its channel and N pre-scaled decays in
//   registers. Bm_t and Cm_t of a tile of 32 steps are staged in shared
//   memory, read by every thread of the block as broadcasts (float4). x and dt
//   are read with neighbouring threads on neighbouring channels. The main
//   shape gives 256 x 6 blocks for 132 SMs.
// - K3c: a warp owns one channel, its lanes split the N states (two per lane
//   at N = 64); a block holds 16 channels of one batch row. Chunks are walked
//   in reverse: each chunk's states and decays are recomputed from h0 into
//   registers (kChunk steps, fully unrolled), then the adjoint runs backward:
//     dh_t  = Cm_t (x) g_t + a_{t+1} . dh_{t+1}
//     dC_t  = sum_d g_t,d h_t,.,d          dB_t = sum_d dh_t,.,d (dt x)_t,d
//     dadot = dh_t . a_t . h_{t-1}         ddt_t,d = sum_n dadot A + (sum_n Bm dh) x
//     dx_t  = dt_t (sum_n Bm dh) + Dp g_t   dA += dadot dt,  dD += g x
//   Sums over n are warp shuffles. Sums over d: the block's 16 warps meet in
//   shared memory every kSub steps and one thread per (step, n) adds them in
//   a fixed order, writing one partial per 16-channel tile; dA and dD are
//   per-(batch row) partials. A second pass (sum_rows_kernel) adds the
//   partials in a fixed order, so no atomics: the result does not change
//   from run to run (the TPU kernel's "zero on grid step (0, 0), accumulate
//   across the grid" needs an ordered grid and is not copied).

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kFwdThreads = 128;  // K3a/K3b: channels per block
constexpr int kTimeTile = 32;     // K3a/K3b: steps of Bm, Cm staged in shared memory
constexpr int kChunk = 16;        // K3b/K3c: steps per saved state
constexpr int kBwdWarps = 16;     // K3c: channels per block, one warp each
constexpr int kSub = 8;           // K3c: steps between the block's dB/dC exchanges

template <int N, bool kStates>
__global__ void __launch_bounds__(kFwdThreads)
scan_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ Dp,
                float* __restrict__ y, float* __restrict__ h0, int T, int D, int n_chunks) {
  static_assert(N % 4 == 0, "N must be a multiple of 4");
  __shared__ __align__(16) float sB[kTimeTile][N];
  __shared__ __align__(16) float sC[kTimeTile][N];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kFwdThreads + threadIdx.x;
  const bool active = d < D;
  float a2[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = active ? A[(size_t)d * N + n] * kLog2e : 0.f;
    h[n] = 0.f;
  }
  const float skip = active ? Dp[d] : 0.f;
  const size_t row = (size_t)b * T;
  for (int t0 = 0; t0 < T; t0 += kTimeTile) {
    const int nt = min(kTimeTile, T - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < nt * N; i += kFwdThreads) {
      const int s = i / N, n = i - s * N;
      sB[s][n] = Bm[(row + t0 + s) * N + n];
      sC[s][n] = Cm[(row + t0 + s) * N + n];
    }
    __syncthreads();
    if (!active) continue;
    for (int s = 0; s < nt; ++s) {
      const int t = t0 + s;
      if (kStates && t % kChunk == 0) {
        float* hc = h0 + ((size_t)b * n_chunks + t / kChunk) * N * D + d;
#pragma unroll
        for (int n = 0; n < N; ++n) hc[(size_t)n * D] = h[n];
      }
      const size_t off = (row + t) * D + d;
      const float xv = x[off], dv = dt[off];
      const float dtx = dv * xv;
      const float4* b4 = reinterpret_cast<const float4*>(sB[s]);
      const float4* c4 = reinterpret_cast<const float4*>(sC[s]);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 bq = b4[q], cq = c4[q];
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
        const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int n = 4 * q + k;
          h[n] = exp2f(dv * a2[n]) * h[n] + bv[k] * dtx;
          acc += cv[k] * h[n];
        }
      }
      y[off] = acc + skip * xv;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int N>
__global__ void __launch_bounds__(kBwdWarps * 32)
scan_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ Dp,
                const float* __restrict__ h0, const float* __restrict__ g,
                float* __restrict__ dx, float* __restrict__ ddt,
                float* __restrict__ dB_part, float* __restrict__ dC_part,
                float* __restrict__ dA_part, float* __restrict__ dD_part,
                int T, int D, int n_chunks) {
  constexpr int NPL = (N + 31) / 32;  // states per lane
  extern __shared__ float smem[];
  float* sdB = smem;                           // [kBwdWarps][kSub][N]
  float* sdC = smem + kBwdWarps * kSub * N;    // [kBwdWarps][kSub][N]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, n_batch = gridDim.y;
  const int tile = blockIdx.x;
  const int d = tile * kBwdWarps + warp;
  const bool active = d < D;
  const size_t row = (size_t)b * T;

  bool has[NPL];
  float Av[NPL], A2[NPL], dh[NPL], dA[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int n = lane + 32 * j;
    has[j] = active && n < N;
    Av[j] = has[j] ? A[(size_t)d * N + n] : 0.f;
    A2[j] = Av[j] * kLog2e;
    dh[j] = 0.f;
    dA[j] = 0.f;
  }
  const float skip = active ? Dp[d] : 0.f;
  float dD = 0.f;

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int tc = c * kChunk;
    // replay the chunk from its initial state; steps past T have dt = 0 and
    // Bm = 0, so they leave the state as it is (decay 1, no input)
    float hent[NPL], hs[kChunk][NPL], as[kChunk][NPL];
#pragma unroll
    for (int j = 0; j < NPL; ++j)
      hent[j] = has[j] ? h0[((size_t)b * n_chunks + c) * N * D + (size_t)(lane + 32 * j) * D + d] : 0.f;
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const int t = tc + s;
      const bool live = active && t < T;
      float dv = 0.f, xv = 0.f;
      if (live) {
        dv = dt[(row + t) * D + d];
        xv = x[(row + t) * D + d];
      }
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const float bn = (live && has[j]) ? Bm[(row + t) * N + lane + 32 * j] : 0.f;
        const float a = exp2f(dv * A2[j]);
        const float hp = s > 0 ? hs[s - 1][j] : hent[j];
        hs[s][j] = a * hp + bn * (dv * xv);
        as[s][j] = a;
      }
    }
    // the adjoint, backward through the chunk, kSub steps at a time
#pragma unroll
    for (int sb = kChunk / kSub - 1; sb >= 0; --sb) {
#pragma unroll
      for (int k = kSub - 1; k >= 0; --k) {
        const int s = sb * kSub + k;
        const int t = tc + s;
        const bool live = active && t < T;
        float dv = 0.f, xv = 0.f, gv = 0.f;
        if (live) {
          const size_t off = (row + t) * D + d;
          dv = dt[off];
          xv = x[off];
          gv = g[off];
        }
        float sum_adot = 0.f, sum_bdh = 0.f;
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          const int n = lane + 32 * j;
          float bn = 0.f, cn = 0.f;
          if (live && has[j]) {
            bn = Bm[(row + t) * N + n];
            cn = Cm[(row + t) * N + n];
          }
          dh[j] += cn * gv;
          const float hp = s > 0 ? hs[s - 1][j] : hent[j];
          const float adot = dh[j] * as[s][j] * hp;
          sum_adot += adot * Av[j];
          sum_bdh += bn * dh[j];
          dA[j] += adot * dv;
          if (n < N) {
            sdB[(warp * kSub + k) * N + n] = dh[j] * (dv * xv);
            sdC[(warp * kSub + k) * N + n] = gv * hs[s][j];
          }
          dh[j] *= as[s][j];
        }
        sum_adot = warp_sum(sum_adot);
        sum_bdh = warp_sum(sum_bdh);
        if (live && lane == 0) {
          const size_t off = (row + t) * D + d;
          ddt[off] = sum_adot + sum_bdh * xv;
          dx[off] = sum_bdh * dv + skip * gv;
        }
        dD += gv * xv;
      }
      __syncthreads();
      // this tile's partial of dB and dC for the kSub steps, warps in order
      for (int i = threadIdx.x; i < kSub * N; i += kBwdWarps * 32) {
        const int k = i / N, n = i - k * N;
        const int t = tc + sb * kSub + k;
        if (t < T) {
          float vb = 0.f, vc = 0.f;
          for (int w = 0; w < kBwdWarps; ++w) {
            vb += sdB[(w * kSub + k) * N + n];
            vc += sdC[(w * kSub + k) * N + n];
          }
          const size_t o = (((size_t)tile * n_batch + b) * T + t) * N + n;
          dB_part[o] = vb;
          dC_part[o] = vc;
        }
      }
      __syncthreads();
    }
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < NPL; ++j)
      if (has[j]) dA_part[((size_t)b * D + d) * N + lane + 32 * j] = dA[j];
    if (lane == 0) dD_part[(size_t)b * D + d] = dD;
  }
}

// dst[m] = sum_p src[p, m], p in order: the second pass over the partials.
__global__ void sum_rows_kernel(const float* __restrict__ src, float* __restrict__ dst, int P,
                                size_t M) {
  const size_t m = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float acc = 0.f;
  for (int p = 0; p < P; ++p) acc += src[(size_t)p * M + m];
  dst[m] = acc;
}

cudaError_t sum_rows(const float* src, float* dst, int P, size_t M, cudaStream_t stream) {
  if (M == 0) return cudaSuccess;
  const int threads = 256;
  sum_rows_kernel<<<(unsigned)((M + threads - 1) / threads), threads, 0, stream>>>(src, dst, P, M);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_fwd(const float* x, const float* dt, const float* A, const float* Bm,
                       const float* Cm, const float* Dp, float* y, float* h0, int batch, int T,
                       int D, cudaStream_t stream) {
  const dim3 grid((D + kFwdThreads - 1) / kFwdThreads, batch);
  const int n_chunks = (T + kChunk - 1) / kChunk;
  if (h0 != nullptr)
    scan_fwd_kernel<N, true><<<grid, kFwdThreads, 0, stream>>>(x, dt, A, Bm, Cm, Dp, y, h0, T, D, n_chunks);
  else
    scan_fwd_kernel<N, false><<<grid, kFwdThreads, 0, stream>>>(x, dt, A, Bm, Cm, Dp, y, h0, T, D, n_chunks);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_bwd(const float* x, const float* dt, const float* A, const float* Bm,
                       const float* Cm, const float* Dp, const float* h0, const float* g,
                       float* dx, float* ddt, float* dA, float* dB, float* dC, float* dD,
                       float* dA_part, float* dD_part, float* dB_part, float* dC_part, int batch,
                       int T, int D, cudaStream_t stream) {
  const int tiles = (D + kBwdWarps - 1) / kBwdWarps;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  const size_t smem = sizeof(float) * 2 * kBwdWarps * kSub * N;
  cudaError_t err = cudaFuncSetAttribute(scan_bwd_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  scan_bwd_kernel<N><<<dim3(tiles, batch), kBwdWarps * 32, smem, stream>>>(
      x, dt, A, Bm, Cm, Dp, h0, g, dx, ddt, dB_part, dC_part, dA_part, dD_part, T, D, n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t btn = (size_t)batch * T * N;
  if ((err = sum_rows(dB_part, dB, tiles, btn, stream)) != cudaSuccess) return err;
  if ((err = sum_rows(dC_part, dC, tiles, btn, stream)) != cudaSuccess) return err;
  if ((err = sum_rows(dA_part, dA, batch, (size_t)D * N, stream)) != cudaSuccess) return err;
  return sum_rows(dD_part, dD, batch, (size_t)D, stream);
}

}  // namespace

extern "C" {

const char* sdt_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int sdt_selective_scan_chunk() { return kChunk; }

int sdt_selective_scan_bwd_tiles(int D) { return (D + kBwdWarps - 1) / kBwdWarps; }

// K3a (h0 == NULL) and K3b (h0 of (batch * ceil(T / kChunk), N, D)).
int sdt_selective_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                           const void* Cm, const void* Dp, void* y, void* h0, int batch, int T,
                           int D, int N, void* stream) {
  const float *px = (const float*)x, *pdt = (const float*)dt, *pA = (const float*)A,
              *pB = (const float*)Bm, *pC = (const float*)Cm, *pD = (const float*)Dp;
  cudaStream_t s = (cudaStream_t)stream;
  switch (N) {
    case 8: return (int)launch_fwd<8>(px, pdt, pA, pB, pC, pD, (float*)y, (float*)h0, batch, T, D, s);
    case 16: return (int)launch_fwd<16>(px, pdt, pA, pB, pC, pD, (float*)y, (float*)h0, batch, T, D, s);
    case 32: return (int)launch_fwd<32>(px, pdt, pA, pB, pC, pD, (float*)y, (float*)h0, batch, T, D, s);
    case 64: return (int)launch_fwd<64>(px, pdt, pA, pB, pC, pD, (float*)y, (float*)h0, batch, T, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K3c. dA_part (batch, D, N), dD_part (batch, D) and dB_part, dC_part
// (tiles, batch, T, N) are scratch for the per-block partials.
int sdt_selective_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                           const void* Cm, const void* Dp, const void* h0, const void* g, void* dx,
                           void* ddt, void* dA, void* dB, void* dC, void* dD, void* dA_part,
                           void* dD_part, void* dB_part, void* dC_part, int batch, int T, int D,
                           int N, void* stream) {
#define SDT_BWD(NN)                                                                            \
  launch_bwd<NN>((const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,         \
                 (const float*)Cm, (const float*)Dp, (const float*)h0, (const float*)g,        \
                 (float*)dx, (float*)ddt, (float*)dA, (float*)dB, (float*)dC, (float*)dD,      \
                 (float*)dA_part, (float*)dD_part, (float*)dB_part, (float*)dC_part, batch, T, \
                 D, (cudaStream_t)stream)
  switch (N) {
    case 8: return (int)SDT_BWD(8);
    case 16: return (int)SDT_BWD(16);
    case 32: return (int)SDT_BWD(32);
    case 64: return (int)SDT_BWD(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SDT_BWD
}

}  // extern "C"
