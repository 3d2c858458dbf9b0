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
// exp: every decay is 2^(dt * A2) with A2 = A * log2(e) pre-scaled once per
// thread (ex2.approx.ftz on the special-function units, at most 2 ulp; a
// decay below 2^-126 becomes 0); the pre-scaling adds a relative error of
// about |dt A| * 6e-8 to each decay. The plain twins use torch.exp, so
// kernel and twin differ by a few ulp per step.
//
// What bounds it on the H100: at the main-path shape (B = 256, T = 100,
// D = 768, N = 64) K3a must move about 249 MB (x, dt, y and Bm, Cm), 0.074 ms
// at 3.35 TB/s, but needs B*T*D*N = 1.26e9 exponentials, about 0.30 ms at the
// SFUs' 16 per SM per clock: it is bound by operations, the exponentials.
// An element (t, d, n) costs one MUFU.EX2, which takes a warp scheduler 8
// clocks for a warp, so the issue of its other instructions hides behind it
// only while they stay fewer than 8: an FMUL (dt A2), an FMUL (Bm dt x), an
// FFMA (h), an FFMA (y) and half an LDS.128 are 5.5.
//
// Design. The TPU kernel walked a (batch, time-chunk) grid in order and
// carried the (N, D) state in VMEM between grid steps; CUDA blocks run in no
// order, so here the time loop runs inside the block:
// - K3a/K3b: a block of 128 threads owns one batch row and 32 channels for
//   the whole T (FwdLayout): kFwdSplit = 4 neighbouring threads share a
//   channel, each holding 16 of its states and their pre-scaled decays in
//   registers (96 registers, 5 blocks and 20 warps an SM; one thread holding
//   all 64 took 168 registers, 12 warps, and spilled once its steps were
//   unrolled), and y adds the four shares by two xor shuffles a step. The
//   time loop walks tiles of kChunk steps: a tile's x and dt of the block's
//   channels and its rows of Bm and Cm are copied into shared memory by
//   cp.async (16-byte copies where aligned, zeros past T and D), the next
//   tile's into a second stage while this one runs, so the step loop reads
//   only shared memory (Bm, Cm as float4 broadcasts) and registers. A full
//   tile's 16 steps are unrolled; the ragged last tile runs a loop. K3b
//   stores h0 once a tile, at its start, outside the step loop. The rounding
//   points are explicit (fmaf, __fmul_rn), so K3a and K3b, one template,
//   give the same y bit for bit. The main shape gives 24 x 256 blocks.
// - K3c: a warp owns two neighbouring channels (kBwdCW), its lanes split the
//   N states (two per lane at N = 64, so a lane holds 2 x 2); a block of 12
//   warps holds 24 channels of one batch row, one tile of D (32 tiles at
//   D = 768). Chunks are walked in reverse. The block copies a chunk's inputs
//   into shared memory with cp.async (x, dt and dy of its channels over the
//   chunk's kChunk steps, Bm and Cm, the chunk's h0 slice), the next chunk's
//   into a second stage while this one runs, so the replay and the adjoint
//   read only shared memory and registers. Each chunk's states are
//   recomputed from h0 into registers (kChunk steps, fully unrolled), then
//   the adjoint runs backward, recomputing each decay:
//     dh_t  = Cm_t (x) g_t + a_{t+1} . dh_{t+1}
//     dC_t  = sum_d g_t,d h_t,.,d          dB_t = sum_d dh_t,.,d (dt x)_t,d
//     dadot = dh_t . a_t . h_{t-1}         ddt_t,d = sum_n dadot A + (sum_n Bm dh) x
//     dx_t  = dt_t (sum_n Bm dh) + Dp g_t   dA += dadot dt,  dD += g x
//   Sums over n are off the adjoint's chain: a lane's partial sums of dadot A
//   and Bm dh enter a reduce-scatter over the warp level by level as the
//   steps come (16 + 8 + 4 + 2 + 1 shuffles a chunk and channel, against 10
//   a step on the chain before), which leaves step s's two sums in lanes s
//   and 16 + s; lane s puts ddt and dx into a tile that the block stores
//   coalesced. Sums over d: a lane adds its two channels' dB and dC
//   terms, each warp writes the chunk's sums into shared memory (96 KB at
//   N = 64), and after one barrier a chunk each thread adds the 12 warps in
//   order for four (step, n), writing one partial per tile; dA and dD are
//   per-(batch row) partials. A second pass (sum_rows_kernel) adds the
//   partials in a fixed order. Every sum has a fixed order and there are no
//   atomics, so the result does not change from run to run (the TPU
//   kernel's "zero on grid step (0, 0), accumulate across the grid" needs an
//   ordered grid and is not copied).
// chip_smoke.py times the previous K3a/K3b (a thread per channel, x and dt
// read from device memory at every step, exp2f, the h0 test in the step
// loop) and K3c (one warp per channel reading device memory at every step,
// two warp sums a step on the chain, an exchange every 8 steps, 48 tiles)
// beside these, built from build/prev/selective_scan.cu where that holds the
// file as of e35add6.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kFwdThreads = 128;  // K3a/K3b: threads per block
constexpr int kFwdSplit = 4;      // K3a/K3b: threads per channel (at most), each holding a share of its states
constexpr int kFwdBlocksPerSm = 5;  // K3a/K3b: blocks an SM holds (a register cap of 102)
constexpr int kChunk = 16;        // K3a/K3b: steps per staged tile; K3b/K3c: steps per saved state
constexpr int kBwdWarps = 12;     // K3c: warps per block (168 registers a thread)
constexpr int kBwdCW = 2;         // K3c: channels per warp
constexpr int kBwdCh = kBwdWarps * kBwdCW;  // K3c: channels per block, one tile of D

// 4-byte cp.async into shared memory; `ok` false fills the word with 0
// (src is then not read, but must be a valid address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
// the same for 16 bytes (dst and src 16-byte aligned)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

// 2^v on the special-function unit (ex2.approx.ftz: at most 2 ulp; a decay
// below 2^-126 becomes 0), for every decay.
__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// K3a/K3b's layout at d_state N. kFwdSplit threads share a channel, each
// holding N / kFwdSplit of its states (fewer threads where N / 4 is
// smaller: a thread holds whole groups of four states), so kFwdThreads /
// split channels a block. Shared memory, in floats: two stages of one
// tile's inputs, x and dt [kChunk][channels], Bm and Cm [kChunk][N].
template <int N>
struct FwdLayout {
  static constexpr int kSplit = N / 4 < kFwdSplit ? N / 4 : kFwdSplit;  // threads a channel
  static constexpr int kStates = N / kSplit;                             // states a thread
  static constexpr int kChans = kFwdThreads / kSplit;                    // channels a block
  static constexpr int kCh = kChunk * kChans;
  static constexpr int kX = 0, kDt = kCh;
  static constexpr int kB = 2 * kCh, kC = kB + kChunk * N;
  static constexpr int kStage = kC + kChunk * N;
  static constexpr int kTotal = 2 * kStage;
  static_assert(N % 4 == 0 && kStates % 4 == 0 && kChans % 4 == 0 && kStage % 4 == 0, "16-byte copies");
  // the state a thread holds at index i: groups of four dealt to the
  // channel's threads in turn, so that their float4 reads of a row of Bm
  // or Cm fall on distinct banks
  static __host__ __device__ constexpr int state(int i, int j) { return 4 * ((i / 4) * kSplit + j) + i % 4; }
};

// Copy the tile of steps t0 .. t0 + kChunk - 1 into `buf`: x and dt of the
// block's channels d0 .. d0 + kChans - 1, and the tile's rows of Bm and Cm
// (zeros past T and past D), as one cp.async group of the caller's. vx:
// D % 4 == 0 and x, dt 16-byte aligned, so a row's channels go by 16-byte
// copies, each wholly inside D or past it; vbc: Bm and Cm 16-byte aligned.
template <int N>
__device__ __forceinline__ void stage_fwd_tile(float* buf, const float* x, const float* dt, const float* Bm,
                                               const float* Cm, int b, int t0, int T, int D, int d0, bool vx,
                                               bool vbc) {
  using L = FwdLayout<N>;
  const size_t row = (size_t)b * T;
  if (vx) {
    constexpr int Q = L::kChans / 4;  // float4s of a row
    for (int i = threadIdx.x; i < 2 * kChunk * Q; i += kFwdThreads) {
      const int a = i / (kChunk * Q), r = i - a * kChunk * Q, s = r / Q, dd = d0 + 4 * (r - s * Q);
      const float* src = a == 0 ? x : dt;
      const bool ok = t0 + s < T && dd < D;
      cp_async16(buf + 4 * i, ok ? src + (row + t0 + s) * D + dd : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < 2 * L::kCh; i += kFwdThreads) {
      const int a = i / L::kCh, r = i - a * L::kCh, s = r / L::kChans, dd = d0 + r - s * L::kChans;
      const float* src = a == 0 ? x : dt;
      const bool ok = t0 + s < T && dd < D;
      cp_async4(buf + i, ok ? src + (row + t0 + s) * D + dd : src, ok);
    }
  }
  // the tile's rows of Bm (then of Cm) are kChunk * N consecutive floats
  if (vbc) {
    for (int i = threadIdx.x; i < 2 * kChunk * N / 4; i += kFwdThreads) {
      const int a = i / (kChunk * N / 4), r = 4 * i - a * kChunk * N;
      const float* src = a == 0 ? Bm : Cm;
      const bool ok = t0 + r / N < T;
      cp_async16(buf + L::kB + 4 * i, ok ? src + (row + t0) * N + r : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < 2 * kChunk * N; i += kFwdThreads) {
      const int a = i / (kChunk * N), r = i - a * kChunk * N;
      const float* src = a == 0 ? Bm : Cm;
      const bool ok = t0 + r / N < T;
      cp_async4(buf + L::kB + i, ok ? src + (row + t0) * N + r : src, ok);
    }
  }
}

// Step s of a channel's scan from the staged tile, on thread j's share of
// its states: sx, sdt the channel's x and dt (stride kChans), sB, sC the
// tile's rows. Returns y, the same bits in each of the channel's threads
// (their shares added by xor shuffles: each sum's two terms in either
// order). The rounding points are fixed (explicit fmaf and __fmul_rn), so
// that K3a and K3b give the same bits.
template <int N>
__device__ __forceinline__ float fwd_step(float (&h)[FwdLayout<N>::kStates], const float (&a2)[FwdLayout<N>::kStates],
                                          const float* sx, const float* sdt, const float* sB, const float* sC,
                                          float skip, int j, int s) {
  using L = FwdLayout<N>;
  const float xv = sx[s * L::kChans], dv = sdt[s * L::kChans];
  const float dtx = __fmul_rn(dv, xv);
  float acc = 0.f;
#pragma unroll
  for (int g = 0; g < L::kStates / 4; ++g) {
    const float4 bq = *reinterpret_cast<const float4*>(sB + s * N + L::state(4 * g, j));
    const float4 cq = *reinterpret_cast<const float4*>(sC + s * N + L::state(4 * g, j));
    const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
    const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * g + k;
      h[i] = fmaf(ex2_approx(__fmul_rn(dv, a2[i])), h[i], __fmul_rn(bv[k], dtx));
      acc = fmaf(cv[k], h[i], acc);
    }
  }
#pragma unroll
  for (int o = 1; o < L::kSplit; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return fmaf(skip, xv, acc);
}

template <int N, bool kStates>
__global__ void __launch_bounds__(kFwdThreads, kFwdBlocksPerSm)
scan_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ Dp,
                float* __restrict__ y, float* __restrict__ h0, int T, int D, int n_chunks) {
  using L = FwdLayout<N>;
  constexpr int M = L::kStates;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int ch = threadIdx.x / L::kSplit, j = threadIdx.x % L::kSplit;  // the thread's channel and share
  const int d0 = blockIdx.x * L::kChans, d = d0 + ch;
  const bool active = d < D;
  const bool vx = (D & 3) == 0 && ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(dt)) & 15) == 0;
  const bool vbc = ((reinterpret_cast<size_t>(Bm) | reinterpret_cast<size_t>(Cm)) & 15) == 0;
  float a2[M], h[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    a2[i] = active ? A[(size_t)d * N + L::state(i, j)] * kLog2e : 0.f;
    h[i] = 0.f;
  }
  const float skip = active ? Dp[d] : 0.f;
  const size_t row = (size_t)b * T;
  stage_fwd_tile<N>(smem, x, dt, Bm, Cm, b, 0, T, D, d0, vx, vbc);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk;
    if (kStates && active) {  // the state before step t0: chunk c's initial state
      float* hc = h0 + ((size_t)b * n_chunks + c) * N * D + d;
#pragma unroll
      for (int i = 0; i < M; ++i) hc[(size_t)L::state(i, j) * D] = h[i];
    }
    cp_async_wait<0>();
    // tile c is in shared memory for every thread, and every thread has
    // finished tile c - 1, whose stage the next copy overwrites
    __syncthreads();
    if (c + 1 < n_chunks)
      stage_fwd_tile<N>(smem + ((c + 1) & 1) * L::kStage, x, dt, Bm, Cm, b, t0 + kChunk, T, D, d0, vx, vbc);
    cp_async_commit();
    // a channel past D runs on the staged zeros (its threads' shuffles need
    // the whole warp) and stores nothing
    const bool store = active && j == 0;
    const float* buf = smem + (c & 1) * L::kStage;
    const float* sx = buf + L::kX + ch;
    const float* sdt = buf + L::kDt + ch;
    float* yc = y + (row + t0) * D + d;
    if (t0 + kChunk <= T) {  // a full tile: a fixed count of steps, unrolled
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        const float v = fwd_step<N>(h, a2, sx, sdt, buf + L::kB, buf + L::kC, skip, j, s);
        if (store) yc[(size_t)s * D] = v;
      }
    } else {  // the ragged last tile
      for (int s = 0; s < T - t0; ++s) {
        const float v = fwd_step<N>(h, a2, sx, sdt, buf + L::kB, buf + L::kC, skip, j, s);
        if (store) yc[(size_t)s * D] = v;
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// K consecutive floats p[0 .. K) of a lane, one 64-bit access at K = 2.
template <int K>
__device__ __forceinline__ void load_lane(const float* p, float (&v)[K]) {
  if constexpr (K == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x;
    v[1] = u.y;
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = p[j];
  }
}
template <int K>
__device__ __forceinline__ void store_lane(float* p, const float (&v)[K]) {
  if constexpr (K == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) p[j] = v[j];
  }
}

// One step of a reduce-scatter over the warp: of the pair (lo, hi) a lane
// keeps the value its bit W selects and adds its partner's copy of it.
template <int W>
__device__ __forceinline__ float rs_pair(float lo, float hi, int lane) {
  const bool up = lane & W;
  return (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, W);
}

// K3c's shared memory, in floats: two stages of one chunk's inputs, then the
// chunk's per-warp dB/dC terms and the ddt/dx tile.
template <int N>
struct BwdSmem {
  static constexpr int kHP = kBwdCh + 1;                    // padded row of the staged h0
  static constexpr int kCh = kChunk * kBwdCh;               // one [kChunk][kBwdCh] array
  static constexpr int kX = 0, kDt = kCh, kG = 2 * kCh;     // x, dt, dy of the block's channels
  static constexpr int kB = 3 * kCh, kC = kB + kChunk * N;  // Bm, Cm [kChunk][N]
  static constexpr int kH = kC + kChunk * N;                // h0 [N][kHP]
  static constexpr int kStage = kH + N * kHP;
  static constexpr int kdB = 2 * kStage;                    // [kBwdWarps][kChunk][N]
  static constexpr int kdC = kdB + kBwdWarps * kChunk * N;  // [kBwdWarps][kChunk][N]
  static constexpr int kOut = kdC + kBwdWarps * kChunk * N; // [2][kChunk][kBwdCh]: ddt, dx
  static constexpr int kTotal = kOut + 2 * kCh;
  static_assert(kStage % 2 == 0 && kdB % 4 == 0 && kdC % 4 == 0, "64-bit and 128-bit shared accesses");
};

// Copy chunk c's inputs for channels d0 .. d0 + kBwdCh - 1 into `buf`
// (zeros past T and past D), as one cp.async group of the caller's.
template <int N>
__device__ __forceinline__ void stage_chunk(float* buf, const float* x, const float* dt, const float* g,
                                            const float* Bm, const float* Cm, const float* h0, int b, int c,
                                            int T, int D, int n_chunks, int d0) {
  using L = BwdSmem<N>;
  const int tc = c * kChunk;
  const size_t row = (size_t)b * T;
  for (int i = threadIdx.x; i < 3 * L::kCh; i += kBwdWarps * 32) {
    const int a = i / L::kCh, r = i - a * L::kCh, s = r / kBwdCh, dd = d0 + r - s * kBwdCh;
    const float* src = a == 0 ? x : (a == 1 ? dt : g);
    const bool ok = tc + s < T && dd < D;
    cp_async4(buf + i, ok ? src + (row + tc + s) * D + dd : src, ok);
  }
  for (int i = threadIdx.x; i < 2 * kChunk * N; i += kBwdWarps * 32) {
    const int a = i / (kChunk * N), r = i - a * kChunk * N;
    const float* src = a == 0 ? Bm : Cm;
    const bool ok = tc + r / N < T;
    cp_async4(buf + L::kB + i, ok ? src + (row + tc) * N + r : src, ok);
  }
  const float* hc = h0 + ((size_t)b * n_chunks + c) * N * D;
  for (int i = threadIdx.x; i < N * kBwdCh; i += kBwdWarps * 32) {
    const int n = i / kBwdCh, w = i - n * kBwdCh;
    const bool ok = d0 + w < D;
    cp_async4(buf + L::kH + n * L::kHP + w, ok ? hc + (size_t)n * D + d0 + w : hc, ok);
  }
}

template <int N>
__global__ void __launch_bounds__(kBwdWarps * 32, 1)
scan_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ Dp,
                const float* __restrict__ h0, const float* __restrict__ g,
                float* __restrict__ dx, float* __restrict__ ddt,
                float* __restrict__ dB_part, float* __restrict__ dC_part,
                float* __restrict__ dA_part, float* __restrict__ dD_part,
                int T, int D, int n_chunks) {
  using L = BwdSmem<N>;
  constexpr int CW = kBwdCW;
  constexpr int NPL = (N + 31) / 32;  // states per lane: n0 .. n0 + NPL - 1
  static_assert(NPL <= 2 && N % NPL == 0, "N is 8, 16, 32 or 64");
  static_assert(kChunk == 16, "the reduce-scatter gives each lane one of the chunk's 2 x 16 sums");
  extern __shared__ __align__(16) float smem[];
  float* sdB = smem + L::kdB;
  float* sdC = smem + L::kdC;
  float* sout = smem + L::kOut;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, n_batch = gridDim.y;
  const int tile = blockIdx.x;
  const int d0 = tile * kBwdCh, w0 = warp * CW;  // the warp's channels: d0 + w0 .. d0 + w0 + CW - 1
  const size_t row = (size_t)b * T;
  const int n0 = lane * NPL;
  const bool has = n0 < N;  // lanes past N (N < 32) hold zeros

  float Av[CW][NPL], A2[CW][NPL], dh[CW][NPL], dA[CW][NPL], skip[CW], dD[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    const int d = d0 + w0 + c;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      Av[c][j] = d < D && has ? A[(size_t)d * N + n0 + j] : 0.f;
      A2[c][j] = Av[c][j] * kLog2e;
      dh[c][j] = 0.f;
      dA[c][j] = 0.f;
    }
    skip[c] = d < D ? Dp[d] : 0.f;
    dD[c] = 0.f;  // lane s < kChunk: sum of dy x over step s of every chunk
  }

  stage_chunk<N>(smem + ((n_chunks - 1) & 1) * L::kStage, x, dt, g, Bm, Cm, h0, b, n_chunks - 1, T, D,
                 n_chunks, d0);
  cp_async_commit();
  for (int ck = n_chunks - 1; ck >= 0; --ck) {
    const int tc = ck * kChunk;
    // prefetch the chunk walked next into the other stage (read by chunk
    // ck + 1, which every thread finished before the last barrier)
    if (ck > 0)
      stage_chunk<N>(smem + ((ck - 1) & 1) * L::kStage, x, dt, g, Bm, Cm, h0, b, ck - 1, T, D, n_chunks, d0);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* buf = smem + (ck & 1) * L::kStage;
    const float* sx = buf + L::kX + w0;
    const float* sdt = buf + L::kDt + w0;
    const float* sg = buf + L::kG + w0;
    const float* sB = buf + L::kB;
    const float* sC = buf + L::kC;

    // replay the chunk from its initial state: hs[s + 1] after step s; steps
    // past T have dt = 0 and Bm = 0 (staged zeros), so they keep the state
    // (decay 1, no input). The adjoint recomputes each decay (the same
    // instruction on the same inputs): registers hold the states, not both.
    float hs[kChunk + 1][CW][NPL];
#pragma unroll
    for (int c = 0; c < CW; ++c)
#pragma unroll
      for (int j = 0; j < NPL; ++j) hs[0][c][j] = has ? buf[L::kH + (n0 + j) * L::kHP + w0 + c] : 0.f;
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      float dv[CW], xv[CW], bn[NPL] = {};
      load_lane<CW>(sdt + s * kBwdCh, dv);
      load_lane<CW>(sx + s * kBwdCh, xv);
      if (has) load_lane<NPL>(sB + s * N + n0, bn);
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float dtx = dv[c] * xv[c];
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          hs[s + 1][c][j] = ex2_approx(dv[c] * A2[c][j]) * hs[s][c][j] + bn[j] * dtx;
        }
      }
    }
    // the adjoint, backward through the chunk. A lane adds its channels'
    // dB and dC terms, and passes its partial sums over its states of dadot
    // A and Bm dh into a reduce-scatter over the warp, level by level as its
    // inputs come: level 16 pairs the step's two sums, level W < 16 pairs
    // steps s and s + W once both have passed level 2W. After step 0 lane l
    // holds in v[c][0] step (l % 16)'s whole sum of dadot A (l < 16) or of
    // Bm dh (l >= 16)
    float v[CW][kChunk];
#pragma unroll
    for (int s = kChunk - 1; s >= 0; --s) {
      float gv[CW], dv[CW], xv[CW], bn[NPL] = {}, cn[NPL] = {}, tdb[NPL], tdc[NPL];
      load_lane<CW>(sg + s * kBwdCh, gv);
      load_lane<CW>(sdt + s * kBwdCh, dv);
      load_lane<CW>(sx + s * kBwdCh, xv);
      if (has) {
        load_lane<NPL>(sB + s * N + n0, bn);
        load_lane<NPL>(sC + s * N + n0, cn);
      }
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float dtx = dv[c] * xv[c];
        float sum_adot = 0.f, sum_bdh = 0.f;
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          const float a = ex2_approx(dv[c] * A2[c][j]);
          dh[c][j] += cn[j] * gv[c];
          const float adot = dh[c][j] * a * hs[s][c][j];
          sum_adot += adot * Av[c][j];
          sum_bdh += bn[j] * dh[c][j];
          dA[c][j] += adot * dv[c];
          const float eb = dh[c][j] * dtx, ec = gv[c] * hs[s + 1][c][j];
          tdb[j] = c == 0 ? eb : tdb[j] + eb;
          tdc[j] = c == 0 ? ec : tdc[j] + ec;
          dh[c][j] *= a;
        }
        float r = rs_pair<16>(sum_adot, sum_bdh, lane);
        if (s < 8) r = rs_pair<8>(r, v[c][(s + 8) % kChunk], lane);
        if (s < 4) r = rs_pair<4>(r, v[c][(s + 4) % kChunk], lane);
        if (s < 2) r = rs_pair<2>(r, v[c][(s + 2) % kChunk], lane);
        if (s < 1) r = rs_pair<1>(r, v[c][(s + 1) % kChunk], lane);
        v[c][s] = r;
      }
      if (has) {
        store_lane<NPL>(sdB + (warp * kChunk + s) * N + n0, tdb);
        store_lane<NPL>(sdC + (warp * kChunk + s) * N + n0, tdc);
      }
    }
    float bdh[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) bdh[c] = __shfl_down_sync(0xffffffffu, v[c][0], kChunk);
    if (lane < kChunk) {  // lane s: step s's ddt and dx into the tile
      float gv[CW], dv[CW], xv[CW], o_dt[CW], o_x[CW];
      load_lane<CW>(sg + lane * kBwdCh, gv);
      load_lane<CW>(sdt + lane * kBwdCh, dv);
      load_lane<CW>(sx + lane * kBwdCh, xv);
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        o_dt[c] = v[c][0] + bdh[c] * xv[c];
        o_x[c] = bdh[c] * dv[c] + skip[c] * gv[c];
        dD[c] += gv[c] * xv[c];
      }
      store_lane<CW>(sout + lane * kBwdCh + w0, o_dt);
      store_lane<CW>(sout + L::kCh + lane * kBwdCh + w0, o_x);
    }
    __syncthreads();
    // this tile's partial of dB and dC for the chunk, warps in order, four
    // states a thread
    for (int i = threadIdx.x; i < 2 * kChunk * N / 4; i += kBwdWarps * 32) {
      const int a = i / (kChunk * N / 4), q = 4 * i - a * kChunk * N, s = q / N;
      if (tc + s < T) {
        const float* src = (a == 0 ? sdB : sdC) + q;
        float4 acc = *reinterpret_cast<const float4*>(src);
#pragma unroll
        for (int w = 1; w < kBwdWarps; ++w) {
          const float4 u = *reinterpret_cast<const float4*>(src + w * kChunk * N);
          acc.x += u.x;
          acc.y += u.y;
          acc.z += u.z;
          acc.w += u.w;
        }
        float* part = a == 0 ? dB_part : dC_part;
        *reinterpret_cast<float4*>(part + (((size_t)tile * n_batch + b) * T + tc) * N + q) = acc;
      }
    }
    for (int i = threadIdx.x; i < 2 * L::kCh; i += kBwdWarps * 32) {
      const int a = i / L::kCh, r = i - a * L::kCh, s = r / kBwdCh, dd = d0 + r - s * kBwdCh;
      if (tc + s < T && dd < D) (a == 0 ? ddt : dx)[(row + tc + s) * D + dd] = sout[i];
    }
  }
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    const int d = d0 + w0 + c;
    const float sum = warp_sum(dD[c]);
    if (d < D) {
      if (has) store_lane<NPL>(dA_part + ((size_t)b * D + d) * N + n0, dA[c]);
      if (lane == 0) dD_part[(size_t)b * D + d] = sum;
    }
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
  const dim3 grid((D + FwdLayout<N>::kChans - 1) / FwdLayout<N>::kChans, batch);
  const int n_chunks = (T + kChunk - 1) / kChunk;
  const size_t smem = sizeof(float) * FwdLayout<N>::kTotal;
  auto* kernel = h0 != nullptr ? scan_fwd_kernel<N, true> : scan_fwd_kernel<N, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kFwdThreads, smem, stream>>>(x, dt, A, Bm, Cm, Dp, y, h0, T, D, n_chunks);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_bwd(const float* x, const float* dt, const float* A, const float* Bm,
                       const float* Cm, const float* Dp, const float* h0, const float* g,
                       float* dx, float* ddt, float* dA, float* dB, float* dC, float* dD,
                       float* dA_part, float* dD_part, float* dB_part, float* dC_part, int batch,
                       int T, int D, cudaStream_t stream) {
  const int tiles = (D + kBwdCh - 1) / kBwdCh;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  const size_t smem = sizeof(float) * BwdSmem<N>::kTotal;
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

int sdt_selective_scan_bwd_tiles(int D) { return (D + kBwdCh - 1) / kBwdCh; }

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
