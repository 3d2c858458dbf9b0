// K4: the whole CAM++ FCM head in one launch.
//
// Replaces speaker_diarization_tpu/kernels/fcm_pallas.py:_fcm_kernel (entry
// fcm_pallas). Computes what kernels/fcm.fcm_folded_torch computes, for a
// (B, T, 80) fbank in the compute dtype:
//   conv1 3x3 (1 -> 32) + BN + ReLU                          F = 80
//   layer1: BasicResBlock(stride 2, 1x1 shortcut), BasicResBlock   F = 40
//   layer2: the same                                          F = 20
//   conv2 3x3, stride (2, 1) + BN + ReLU                     F = 10
// and writes (B, T, 320) channel-major (index c * 10 + f) directly, where the
// TPU kernel wrote (B, 10, T, 32) and transposed afterwards. Every 3x3 conv
// zero-fills its own input outside [0, T) in time and outside [0, F) in
// frequency; a stride-2 conv's output row f reads rows 2f-1, 2f, 2f+1 and
// its 1x1 shortcut row 2f. Rounding points are the JAX kernel's: operands in
// the compute dtype, fp32 products and sums, BN scale and bias applied in
// fp32 to the accumulator, the unit's result cast to the dtype; a residual
// adds the rounded conv output to the fp32 shortcut (stride 2) or to the
// dtype block input (stride 1) in fp32 and casts after the ReLU.
//
// What bounds it on the H100: 2,388,480 MACs per frame per item, 121.7 GFLOP
// at the TS-VAD shape (B = 64, T = 398), 0.123 ms at the bf16 tensor-core
// peak, against ~20 MB of compulsory traffic (6 us): bound by operations.
// One item's (80, T, 32) activation at T = 398 is 2 MB in bf16, far beyond
// one block's 227 KB of shared memory (the TPU kept it in VMEM), so a block
// owns one item and one window of frames, with a halo of 10 frames on each
// side (one per time-tapped conv) recomputed by the neighbouring windows:
// after conv k the window's frames [k, W - k) are exact. The activations
// between units live in the block's own slice of a global scratch (P: 80
// rows, Q and R: 40 rows each, a row being W frames x 32 channels), written
// and re-read by the same block behind barriers, so no block waits for
// another and any B and T run. An intermediate frame outside [0, T) is
// written as 0, not computed, so the next conv sees the zero padding the
// JAX code gives it. The first design (now the fp32 instance) ran bf16 at
// 25x its bound, and halving its row reads did not move it: each output row
// of each conv cost two barriers, a small (16 x 288) x (288 x 32) product
// per warp, a round trip of the accumulators through shared memory and a
// scratch write that the next conv read back.
//
// bf16 design (fcm_tc_kernel): a block of 8 warps owns a 256-frame window
// (236 output frames; 128 blocks at the TS-VAD shape, one wave on 132 SMs),
// warp w the frames 32w .. 32w+31, so that each weight fragment loaded from
// shared memory serves two 16-frame A fragments (a third fewer ldmatrix
// loads than 16 warps of 16 frames; on the H100 the two took the same
// time, so shared-memory reads do not bind it either). Each
// BasicResBlock's two 3x3 convs run
// fused (unit<RES_SC|RES_ID>): conv A's output rows (h1) never leave shared
// memory, where a ring of four rows holds them, and conv B consumes each as
// soon as its three rows are there. One barrier per interval covers conv B's
// output row i - 2, conv A's row i, and the residual of row i (the block
// input row, or its 1x1 shortcut, taken from the middle input row and held
// in registers for two intervals): about 300 mma.sync (m16n8k16 bf16, fp32
// accumulators) per warp per barrier, against 72 before. The input rows sit
// in a ring of five rows and the next interval's rows (one at stride 1, two
// at stride 2) arrive by cp.async while the current ones are multiplied.
// Every epilogue (BN, ReLU, the residual, the zero frames, the rounding)
// runs on the accumulator fragments in registers and writes bf16 pairs to
// the h1 ring, the scratch or the output. Rows and weights are staged as
// 64-byte rows with the 16-byte chunks XOR-swizzled, so the ldmatrix loads
// of 8 consecutive frames hit distinct banks. conv1 (one input channel, 9
// taps) runs as fp32 FMAs. On the H100 (64, 398) takes 1.03 ms, 8x the
// bound, against 3.07 ms before: neither the products, nor the bytes, nor
// (above) the shared-memory reads bind it; the barrier of each of the ~140
// intervals a block walks, with its epilogue's scattered stores, remains.
//
// fp32 instance (fcm_kernel<float>, the first design): a block of 8 warps owns
// a 128-frame window (108 output frames); each conv unit walks its output
// rows with its input rows staged in shared memory (a ring of three slots
// with a zero frame at each end, the next row loaded into registers
// meanwhile), 16 frames x 32 channels per warp as fp32 FMAs on CUDA cores
// (the tensor cores have no full-fp32 mode), and writes each row to the
// scratch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "sm90_mma.cuh"

namespace {

constexpr int C = 32;             // FCM channels
constexpr int NF = 80;            // fbank bins
constexpr int HALO = 10;          // one frame per time-tapped conv
constexpr int W = 128;            // window frames per block
constexpr int TT = W - 2 * HALO;  // output frames per block
constexpr int THREADS = 256;      // 8 warps; warp w owns window frames 16w .. 16w+15
constexpr int WP = W + 2;         // a staged row: the window and a zero frame at each end
constexpr int ROW = W * C;        // elements of one frequency row of the scratch
constexpr int SLAB = (80 + 40 + 40) * ROW;  // scratch elements per block: P, Q, R
constexpr int XS = NF + 2;        // conv1's staged fbank: frequency with a zero bin at each end
constexpr int UNITS = 12;         // conv1, 4 blocks x 2 convs, 2 shortcuts, conv2

enum Mode { RELU = 0, RES_ID = 1, RES_SC = 2 };

struct Params {
  const void* w[UNITS];    // 3x3 convs: (3 Cin, 3 Cout) tap-folded, [(df, ci), (dt, co)]; shortcuts (Cin, Cout)
  const float* sb[UNITS];  // (2, 32): folded-BN scale, bias
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f<T>(from_f<T>(v)); }

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

template <typename T>
struct Layout {  // byte offsets into dynamic shared memory
  static constexpr size_t rows_b = 3 * WP * C * sizeof(T);
  static constexpr size_t xs_b = (size_t)(W + 2) * XS * sizeof(float);  // conv1 only, aliases rows
  static constexpr size_t rows = 0;
  static constexpr size_t scrow = align128(rows_b > xs_b ? rows_b : xs_b);
  static constexpr size_t wsm = scrow + align128((size_t)W * C * sizeof(T));
  static constexpr size_t wsc = wsm + align128((size_t)9 * C * C * sizeof(T));
  static constexpr size_t sb = wsc + align128((size_t)C * C * sizeof(T));
  static constexpr size_t acc = sb + align128(4 * C * sizeof(float));
  static constexpr size_t total = acc + (size_t)(THREADS / 32) * 2 * 16 * C * sizeof(float);
};

template <typename T>
struct Smem {
  T* rows;      // 3 staged input rows, (WP, C) each
  T* scrow;     // the residual's input row, (W, C): the block input (its row 2f for a shortcut)
  T* wsm;       // the unit's 3x3 weights, [tap = 3 df + dt][ci][co]
  T* wsc;       // the shortcut's weights, [ci][co]
  float* sb;    // scale, bias, shortcut scale, shortcut bias (32 each)
  float* acc;   // per warp: conv accumulators (16, 32), then shortcut accumulators (16, 32)
  float* xs;    // conv1's staged fbank, (W + 2, XS) fp32
};

// conv1: one input channel, 9 taps, as FMAs; writes P (80 rows).
template <typename T>
__device__ void conv1(const T* __restrict__ xb, const T* __restrict__ Wg, const float* __restrict__ sbg,
                      T* P, const Smem<T>& sm, int t_lo, int Tlen) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll 8  // independent loads in flight, not one round trip each
  for (int i = tid; i < (W + 2) * XS; i += THREADS) {
    const int jj = i / XS, ff = i - jj * XS;
    const int t = t_lo + jj - 1, f = ff - 1;
    sm.xs[i] = (t >= 0 && t < Tlen && f >= 0 && f < NF) ? to_f<T>(xb[(size_t)t * NF + f]) : 0.f;
  }
  float w[9];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) w[tap] = to_f<T>(Wg[(tap / 3) * 3 * C + (tap % 3) * C + lane]);
  const float s = sbg[lane], b = sbg[C + lane];
  __syncthreads();
  for (int p = warp; p < NF * W; p += THREADS / 32) {
    const int f = p / W, j = p - f * W;
    const int t = t_lo + j;
    float v = 0.f;
    if (t >= 0 && t < Tlen) {
      float a = 0.f;
#pragma unroll
      for (int df = 0; df < 3; ++df)
#pragma unroll
        for (int dt = 0; dt < 3; ++dt) a += sm.xs[(j + dt) * XS + f + df] * w[df * 3 + dt];
      v = rnd<T>(fmaxf(a * s + b, 0.f));
    }
    P[(size_t)f * ROW + j * C + lane] = from_f<T>(v);
  }
}

// Rows of the scratch move to shared memory through registers, one output
// row ahead: a thread holds NV 16-byte vectors of each row the next output
// row adds while the warps compute the current one. The input rows sit in a
// ring of three slots, row fi in slot (fi + 1) % 3 (row -1 is the zero row
// above row 0), so output row fo's tap df reads slot (stride fo + df) % 3 and
// each output row stages only its new rows: all three for the first, then
// one (stride 1) or two (stride 2). The residual's row goes to scrow.
template <typename T>
struct RowPrefetch {
  static constexpr int EPV = 16 / sizeof(T);           // elements per vector
  static constexpr int NV = ROW / EPV / THREADS;        // vectors per thread per row
  uint4 v[4][NV];
  int first, count;  // the input rows held: first .. first + count - 1

  template <int MODE>
  __device__ __forceinline__ void load(const T* in, int Fin, int stride, const T* res, int fo) {
    first = fo == 0 ? -1 : (stride == 1 ? fo + 1 : 2 * fo);
    count = fo == 0 ? 3 : stride;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int fi = first + r;
      const bool ok = r < count && fi >= 0 && fi < Fin;
#pragma unroll
      for (int k = 0; k < NV; ++k)
        v[r][k] = ok ? reinterpret_cast<const uint4*>(in + (size_t)fi * ROW)[threadIdx.x + k * THREADS]
                     : make_uint4(0, 0, 0, 0);
    }
    if (MODE != RELU) {  // the block input at row fo (RES_ID) or at row 2 fo (RES_SC)
      const T* src = res + (size_t)(MODE == RES_SC ? 2 * fo : fo) * ROW;
#pragma unroll
      for (int k = 0; k < NV; ++k) v[3][k] = reinterpret_cast<const uint4*>(src)[threadIdx.x + k * THREADS];
    }
  }

  template <int MODE>
  __device__ __forceinline__ void store(T* rows, T* scrow) const {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (r < count) {
        T* dst = rows + (((first + r + 1) % 3) * WP + 1) * C;
#pragma unroll
        for (int k = 0; k < NV; ++k) reinterpret_cast<uint4*>(dst)[threadIdx.x + k * THREADS] = v[r][k];
      }
    }
    if (MODE != RELU) {
#pragma unroll
      for (int k = 0; k < NV; ++k) reinterpret_cast<uint4*>(scrow)[threadIdx.x + k * THREADS] = v[3][k];
    }
  }
};

// One 3x3 conv (stride 1 or 2 in frequency) + folded BN, with the epilogue of
// its mode: ReLU; or a residual add (+ ReLU) of the block input `res` (RES_ID,
// same rows as the output) or of res's 1x1 conv at rows 2f (RES_SC, res
// having twice the output's rows). FINAL
// writes the head's output tile into out (B, T, 320); otherwise dst, a
// scratch buffer of Fin / stride rows.
template <typename T, int MODE, bool FINAL>
__device__ void conv_unit(const T* in, int Fin, int stride, T* dst, const T* res,
                          const T* __restrict__ Wg, const float* __restrict__ sbg,
                          const T* __restrict__ Wscg, const float* __restrict__ sbscg,
                          T* __restrict__ out_item, const Smem<T>& sm, int t_lo, int Tlen) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();  // the previous unit's scratch writes are visible; shared memory is free
#pragma unroll 12  // independent loads in flight, not one round trip each
  for (int i = tid; i < 9 * C * C; i += THREADS) {
    const int tap = i / (C * C), ci = (i / C) % C, co = i % C;
    sm.wsm[i] = Wg[((tap / 3) * C + ci) * 3 * C + (tap % 3) * C + co];
  }
  if (MODE == RES_SC)
    for (int i = tid; i < C * C; i += THREADS) sm.wsc[i] = Wscg[i];
  if (tid < 2 * C) sm.sb[tid] = sbg[tid];
  if (MODE == RES_SC && tid < 2 * C) sm.sb[2 * C + tid] = sbscg[tid];
  for (int i = tid; i < 3 * 2 * C; i += THREADS) {  // the zero frame at each end of the staged rows
    const int r = i / (2 * C), e = (i / C) % 2, c = i % C;
    sm.rows[(r * WP + (e ? W + 1 : 0)) * C + c] = from_f<T>(0.f);
  }
  const int Fout = Fin / stride;
  const int j0 = warp * 16;
  const bool live = t_lo + j0 + 15 >= 0 && t_lo + j0 < Tlen;  // some frame of the warp's chunk is in [0, T)
  float* accw = sm.acc + warp * 2 * 16 * C;
  float* accs = accw + 16 * C;
  RowPrefetch<T> pre;
  pre.template load<MODE>(in, Fin, stride, res, 0);
  for (int fo = 0; fo < Fout; ++fo) {
    __syncthreads();  // the previous row's staged inputs are consumed
    pre.template store<MODE>(sm.rows, sm.scrow);
    __syncthreads();
    if (fo + 1 < Fout) pre.template load<MODE>(in, Fin, stride, res, fo + 1);
    if (live) {
      // fp32: lane = output channel, 16 frames per lane; inputs read as
      // float4 over 4 channels (a broadcast: every lane reads the same address)
      float acc[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) acc[q] = 0.f;
      for (int tap = 0; tap < 9; ++tap) {
        const float* ab =
            reinterpret_cast<const float*>(sm.rows) + (((stride * fo + tap / 3) % 3) * WP + j0 + tap % 3) * C;
        const float* wb = reinterpret_cast<const float*>(sm.wsm) + tap * C * C + lane;
#pragma unroll 2
        for (int c4 = 0; c4 < C; c4 += 4) {
          const float w0 = wb[c4 * C], w1 = wb[(c4 + 1) * C], w2 = wb[(c4 + 2) * C], w3 = wb[(c4 + 3) * C];
#pragma unroll
          for (int q = 0; q < 16; ++q) {
            const float4 xv = *reinterpret_cast<const float4*>(ab + q * C + c4);
            acc[q] += xv.x * w0 + xv.y * w1 + xv.z * w2 + xv.w * w3;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 16; ++q) accw[q * C + lane] = acc[q];
      if (MODE == RES_SC) {
#pragma unroll
        for (int q = 0; q < 16; ++q) acc[q] = 0.f;
        const float* ab = reinterpret_cast<const float*>(sm.scrow) + j0 * C;
        const float* wb = reinterpret_cast<const float*>(sm.wsc) + lane;
        for (int c4 = 0; c4 < C; c4 += 4) {
          const float w0 = wb[c4 * C], w1 = wb[(c4 + 1) * C], w2 = wb[(c4 + 2) * C], w3 = wb[(c4 + 3) * C];
#pragma unroll
          for (int q = 0; q < 16; ++q) {
            const float4 xv = *reinterpret_cast<const float4*>(ab + q * C + c4);
            acc[q] += xv.x * w0 + xv.y * w1 + xv.z * w2 + xv.w * w3;
          }
        }
#pragma unroll
        for (int q = 0; q < 16; ++q) accs[q * C + lane] = acc[q];
      }
      __syncwarp();
    }
    // epilogue: lane = output channel
    const float s = sm.sb[lane], b = sm.sb[C + lane];
    for (int q = 0; q < 16; ++q) {
      const int j = j0 + q, t = t_lo + j;
      const bool in_range = t >= 0 && t < Tlen;
      float v = 0.f;
      if (in_range) {
        v = accw[q * C + lane] * s + b;
        if (MODE == RELU) {
          v = rnd<T>(fmaxf(v, 0.f));
        } else {
          const float sc = MODE == RES_SC ? accs[q * C + lane] * sm.sb[2 * C + lane] + sm.sb[3 * C + lane]
                                          : to_f<T>(sm.scrow[j * C + lane]);
          v = rnd<T>(fmaxf(rnd<T>(v) + sc, 0.f));
        }
      }
      if (FINAL) {
        if (in_range && j >= HALO && j < HALO + TT) out_item[(size_t)t * (C * 10) + lane * 10 + fo] = from_f<T>(v);
      } else {
        dst[(size_t)fo * ROW + j * C + lane] = from_f<T>(v);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
fcm_kernel(const T* __restrict__ x, T* __restrict__ out, Params prm, T* scratch, int Tlen, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Layout<T>;
  Smem<T> sm;
  sm.rows = reinterpret_cast<T*>(smem + L::rows);
  sm.xs = reinterpret_cast<float*>(smem + L::rows);
  sm.scrow = reinterpret_cast<T*>(smem + L::scrow);
  sm.wsm = reinterpret_cast<T*>(smem + L::wsm);
  sm.wsc = reinterpret_cast<T*>(smem + L::wsc);
  sm.sb = reinterpret_cast<float*>(smem + L::sb);
  sm.acc = reinterpret_cast<float*>(smem + L::acc);

  const int item = blockIdx.x / n_tiles, tile = blockIdx.x - item * n_tiles;
  const int t_lo = tile * TT - HALO;  // the global frame of window frame 0
  T* P = scratch + (size_t)blockIdx.x * SLAB;
  T* Q = P + 80 * ROW;
  T* R = Q + 40 * ROW;
  T* oi = out + (size_t)item * Tlen * (C * 10);
  auto w = [&](int u) { return reinterpret_cast<const T*>(prm.w[u]); };

  conv1<T>(x + (size_t)item * Tlen * NF, w(0), prm.sb[0], P, sm, t_lo, Tlen);
  // layer1_0 (stride 2): P (80) -> Q (40) -> R (40), shortcut from P
  conv_unit<T, RELU, false>(P, 80, 2, Q, nullptr, w(1), prm.sb[1], nullptr, nullptr, oi, sm, t_lo, Tlen);
  conv_unit<T, RES_SC, false>(Q, 40, 1, R, P, w(2), prm.sb[2], w(3), prm.sb[3], oi, sm, t_lo, Tlen);
  // layer1_1: R -> Q -> P, identity shortcut R
  conv_unit<T, RELU, false>(R, 40, 1, Q, nullptr, w(4), prm.sb[4], nullptr, nullptr, oi, sm, t_lo, Tlen);
  conv_unit<T, RES_ID, false>(Q, 40, 1, P, R, w(5), prm.sb[5], nullptr, nullptr, oi, sm, t_lo, Tlen);
  // layer2_0 (stride 2): P (40) -> Q (20) -> R (20), shortcut from P
  conv_unit<T, RELU, false>(P, 40, 2, Q, nullptr, w(6), prm.sb[6], nullptr, nullptr, oi, sm, t_lo, Tlen);
  conv_unit<T, RES_SC, false>(Q, 20, 1, R, P, w(7), prm.sb[7], w(8), prm.sb[8], oi, sm, t_lo, Tlen);
  // layer2_1: R -> Q -> P, identity shortcut R
  conv_unit<T, RELU, false>(R, 20, 1, Q, nullptr, w(9), prm.sb[9], nullptr, nullptr, oi, sm, t_lo, Tlen);
  conv_unit<T, RES_ID, false>(Q, 20, 1, P, R, w(10), prm.sb[10], nullptr, nullptr, oi, sm, t_lo, Tlen);
  // conv2 (stride 2): P (20) -> the output tile, 10 rows
  conv_unit<T, RELU, true>(P, 20, 2, nullptr, nullptr, w(11), prm.sb[11], nullptr, nullptr, oi, sm, t_lo, Tlen);
}

template <typename T>
int launch(const void* x, void* out, const void* const* w, const void* const* sb, void* scratch, int B,
           int Tlen, void* stream) {
  Params prm;
  for (int u = 0; u < UNITS; ++u) {
    prm.w[u] = w[u];
    prm.sb[u] = static_cast<const float*>(sb[u]);
  }
  const int n_tiles = (Tlen + TT - 1) / TT;
  const size_t smem = Layout<T>::total;
  cudaError_t err = cudaFuncSetAttribute(fcm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fcm_kernel<T><<<B * n_tiles, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, (T*)out, prm, (T*)scratch, Tlen, n_tiles);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16: fused residual blocks on the tensor cores
// ---------------------------------------------------------------------------

namespace k4tc {

using bf16 = __nv_bfloat16;
constexpr int W = 256;                // window frames per block
constexpr int TT = W - 2 * HALO;      // output frames per block
constexpr int THREADS = 256;          // 8 warps; warp w owns window frames 32w .. 32w+31
constexpr int MI = 2;                 // m16 tiles (16 frames each) per warp
constexpr int WP = W + 2;             // a staged row: the window and a zero frame at each end
constexpr int ROW = W * C;            // elements of one frequency row of the scratch
constexpr int SLAB = (80 + 40 + 40) * ROW;
constexpr int ROWB = WP * C * 2;      // bytes of a staged row: 64 per frame, 16-byte chunks swizzled
constexpr int NIN = 5;                // input ring: the 3 rows a conv reads and the 2 on their way
constexpr int NH = 4;                 // h1 ring: the 3 rows conv B reads and the one conv A writes
constexpr int TAPB = C * C * 2;       // bytes of one tap's (32 x 32) weights

enum Mode { RES_SC = 0, RES_ID = 1, FINAL = 2 };

struct Layout {  // byte offsets into dynamic shared memory
  static constexpr size_t in = 0;
  static constexpr size_t h1 = in + (size_t)NIN * ROWB;
  static constexpr size_t wa = h1 + (size_t)NH * ROWB;
  static constexpr size_t wb = wa + 9 * TAPB;
  static constexpr size_t ws = wb + 9 * TAPB;
  static constexpr size_t sb = ws + TAPB;  // scale, bias of conv A, conv B, the shortcut: 6 x 32 fp32
  static constexpr size_t total = sb + 6 * C * sizeof(float);
  static constexpr size_t xs_b = (size_t)(W + 2) * XS * sizeof(float);  // conv1's fbank, aliases the rings
  static_assert(xs_b <= wa, "conv1's staged fbank overlaps the weights");
};

// byte offset of (row p, 16-byte chunk q) in a tile of 64-byte rows; the
// chunk index is XORed with (p / 2) % 4, so the 8 rows of an ldmatrix phase
// (any 8 consecutive rows) fall on distinct banks
__device__ __forceinline__ int swz(int p, int q) { return p * 64 + ((q ^ ((p >> 1) & 3)) << 4); }

// conv1: one input channel, 9 taps, as FMAs; writes P (80 rows)
__device__ void conv1(const bf16* __restrict__ xb, const bf16* __restrict__ Wg, const float* __restrict__ sbg,
                      bf16* P, float* xs, int t_lo, int Tlen) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll 8
  for (int i = tid; i < (W + 2) * XS; i += THREADS) {
    const int jj = i / XS, ff = i - jj * XS;
    const int t = t_lo + jj - 1, f = ff - 1;
    xs[i] = (t >= 0 && t < Tlen && f >= 0 && f < NF) ? __bfloat162float(xb[(size_t)t * NF + f]) : 0.f;
  }
  float w[9];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) w[tap] = __bfloat162float(Wg[(tap / 3) * 3 * C + (tap % 3) * C + lane]);
  const float s = sbg[lane], b = sbg[C + lane];
  __syncthreads();
  for (int p = warp; p < NF * W; p += THREADS / 32) {
    const int f = p / W, j = p - f * W;
    const int t = t_lo + j;
    float v = 0.f;
    if (t >= 0 && t < Tlen) {
      float a = 0.f;
#pragma unroll
      for (int df = 0; df < 3; ++df)
#pragma unroll
        for (int dt = 0; dt < 3; ++dt) a += xs[(j + dt) * XS + f + df] * w[df * 3 + dt];
      v = sm90::bf16_round(fmaxf(a * s + b, 0.f));
    }
    P[(size_t)f * ROW + j * C + lane] = __float2bfloat16_rn(v);
  }
}

// 3x3 weights [(df, ci), (dt, co)] (global) -> 9 swizzled (ci, co) taps
__device__ __forceinline__ void load_taps(unsigned char* dst, const bf16* Wg) {
  for (int i = threadIdx.x; i < 9 * C * 4; i += THREADS) {
    const int tap = i / (C * 4), ci = (i / 4) % C, q = i % 4;
    sm90::cp_async16(dst + tap * TAPB + swz(ci, q), Wg + ((tap / 3) * C + ci) * 3 * C + (tap % 3) * C + q * 8, true);
  }
}

// the input row fi (zeros outside [0, Fin)) into its ring slot (fi + 1) % NIN
__device__ __forceinline__ void stage_row(unsigned char* ring, const bf16* in, int fi, int Fin) {
  unsigned char* dst = ring + (size_t)((fi + 1 + NIN) % NIN) * ROWB;
  const bool ok = fi >= 0 && fi < Fin;
  const bf16* src = in + (size_t)(ok ? fi : 0) * ROW;
  for (int i = threadIdx.x; i < W * 4; i += THREADS) {
    const int j = i >> 2, q = i & 3;
    sm90::cp_async16(dst + swz(j + 1, q), src + j * C + q * 8, ok);
  }
}

// accumulators of a warp's 32 frames x 32 channels: [m tile][n tile][fragment]
using Acc = float[MI][4][4];

// acc += the 3x3 conv of the 32 window frames j0 .. j0+31: rows[df] are the
// staged rows f-1, f, f+1 (frame p of a staged row is window frame p - 1);
// each weight fragment serves both m tiles
__device__ __forceinline__ void conv3(Acc& acc, const unsigned char* const (&rows)[3], const unsigned char* w,
                                      int j0, int lane) {
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, hi = lane >> 4;
#pragma unroll
  for (int df = 0; df < 3; ++df)
#pragma unroll
    for (int dt = 0; dt < 3; ++dt)
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        uint32_t af[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) sm90::ldsm_a(af[mi], rows[df] + swz(j0 + 16 * mi + dt + lr, kc * 2 + hi));
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          uint32_t bfr[4];
          sm90::ldsm_bt(bfr, w + (df * 3 + dt) * TAPB + swz(kc * 16 + lr, nj * 2 + hi));
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            sm90::mma_bf16(acc[mi][2 * nj], af[mi], bfr[0], bfr[1]);
            sm90::mma_bf16(acc[mi][2 * nj + 1], af[mi], bfr[2], bfr[3]);
          }
        }
      }
}

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;
}

// One BasicResBlock (RES_SC: stride 2 in frequency with a 1x1 shortcut;
// RES_ID: stride 1, identity shortcut), its two 3x3 convs fused; or, FINAL,
// the head's last conv (stride 2, BN, ReLU) into the output tile.
// Interval i (one barrier each): conv B makes output row i - 2 from the h1
// rows i - 3 .. i - 1 of the h1 ring and the residual of row i - 2 held in
// registers since interval i - 2; conv A makes h1 row i from the input rows
// s i - 1 .. s i + 1 of the input ring and the residual of row i from the
// middle one (the block input row i, or row 2 i through the shortcut); the
// input rows of interval i + 1 are on their way by cp.async meanwhile.
template <int MODE>
__device__ void unit(const bf16* in, int Fin, bf16* dst, const bf16* wA, const float* sbA, const bf16* wB,
                     const float* sbB, const bf16* wS, const float* sbS, bf16* out_item, unsigned char* sm,
                     int t_lo, int Tlen) {
  using L = Layout;
  constexpr int S = MODE == RES_ID ? 1 : 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c4 = lane & 3;
  const int Fout = Fin / S, j0 = warp * 16 * MI;
  const bool live = t_lo + j0 + 16 * MI - 1 >= 0 && t_lo + j0 < Tlen;
  unsigned char* ring = sm + L::in;
  unsigned char* h1 = sm + L::h1;
  float* sb = reinterpret_cast<float*>(sm + L::sb);

  __syncthreads();  // the previous unit's scratch writes are visible; shared memory is free
  load_taps(sm + L::wa, wA);
  if (MODE != FINAL) load_taps(sm + L::wb, wB);
  if (MODE == RES_SC)
    for (int i = tid; i < C * 4; i += THREADS) sm90::cp_async16(sm + L::ws + swz(i >> 2, i & 3), wS + i * 8, true);
  if (tid < 2 * C) {
    sb[tid] = sbA[tid];
    if (MODE != FINAL) sb[2 * C + tid] = sbB[tid];
    if (MODE == RES_SC) sb[4 * C + tid] = sbS[tid];
  }
  for (int i = tid; i < (NIN + NH) * 2 * 4; i += THREADS) {  // the zero frame at each end of every slot
    const int slot = i / 8, e = (i / 4) % 2, q = i % 4;
    *reinterpret_cast<uint4*>(ring + (size_t)slot * ROWB + swz(e ? W + 1 : 0, q)) = make_uint4(0, 0, 0, 0);
  }
  for (int i = tid; i < W * 4; i += THREADS)  // h1 row -1 (slot NH - 1) is zero
    *reinterpret_cast<uint4*>(h1 + (size_t)(NH - 1) * ROWB + swz((i >> 2) + 1, i & 3)) = make_uint4(0, 0, 0, 0);
  for (int r = -1; r <= 1; ++r) stage_row(ring, in, r, Fin);
  sm90::cp_async_commit();

  Acc res0, res1;  // residuals of rows i - 2 and i - 1, fragment layout, fp32
  const int n_iv = MODE == FINAL ? Fout : Fout + 2;
  for (int i = 0; i < n_iv; ++i) {
    sm90::cp_async_wait<0>();
    __syncthreads();  // interval i's input rows have landed; h1 row i - 1 is written
    if (i + 1 < Fout)
      for (int r = S * (i + 1) + 2 - S; r <= S * (i + 1) + 1; ++r) stage_row(ring, in, r, Fin);
    sm90::cp_async_commit();

    if (MODE != FINAL && i >= 2) {  // conv B: output row f = i - 2
      const int f = i - 2;
      Acc acc;
      zero_acc(acc);
      if (live) {
        const unsigned char* rows[3] = {h1 + (size_t)((f + NH - 1) % NH) * ROWB, h1 + (size_t)(f % NH) * ROWB,
                                        h1 + (size_t)((f + 1) % NH) * ROWB};
        conv3(acc, rows, sm + L::wb, j0, lane);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int co = ni * 8 + 2 * c4;
        const float2 s = *reinterpret_cast<const float2*>(sb + 2 * C + co);
        const float2 b = *reinterpret_cast<const float2*>(sb + 3 * C + co);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = j0 + 16 * mi + g + 8 * h, t = t_lo + j;
            float v0 = 0.f, v1 = 0.f;
            if (t >= 0 && t < Tlen) {
              v0 = fmaxf(sm90::bf16_round(acc[mi][ni][2 * h] * s.x + b.x) + res0[mi][ni][2 * h], 0.f);
              v1 = fmaxf(sm90::bf16_round(acc[mi][ni][2 * h + 1] * s.y + b.y) + res0[mi][ni][2 * h + 1], 0.f);
            }
            *reinterpret_cast<uint32_t*>(dst + (size_t)f * ROW + j * C + co) = sm90::pack_bf16(v0, v1);
          }
      }
    }

    if (i < Fout) {  // conv A: h1 row i (FINAL: the output row i)
      const unsigned char* rows[3] = {ring + (size_t)((S * i + NIN) % NIN) * ROWB,
                                      ring + (size_t)((S * i + 1) % NIN) * ROWB,
                                      ring + (size_t)((S * i + 2) % NIN) * ROWB};
      Acc acc;
      zero_acc(acc);
      if (live) conv3(acc, rows, sm + L::wa, j0, lane);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int co = ni * 8 + 2 * c4;
        const float2 s = *reinterpret_cast<const float2*>(sb + co);
        const float2 b = *reinterpret_cast<const float2*>(sb + C + co);
#pragma unroll
        for (int m2 = 0; m2 < 2 * MI; ++m2) {  // (m tile, fragment row half)
          const int mi = m2 >> 1, h = m2 & 1;
          const int j = j0 + 16 * mi + g + 8 * h, t = t_lo + j;
          const bool in_range = t >= 0 && t < Tlen;
          const float v0 = in_range ? fmaxf(acc[mi][ni][2 * h] * s.x + b.x, 0.f) : 0.f;
          const float v1 = in_range ? fmaxf(acc[mi][ni][2 * h + 1] * s.y + b.y, 0.f) : 0.f;
          if (MODE == FINAL) {
            if (in_range && j >= HALO && j < HALO + TT) {
              out_item[(size_t)t * (C * 10) + co * 10 + i] = __float2bfloat16_rn(v0);
              out_item[(size_t)t * (C * 10) + (co + 1) * 10 + i] = __float2bfloat16_rn(v1);
            }
          } else {
            *reinterpret_cast<uint32_t*>(h1 + (size_t)(i % NH) * ROWB + swz(j + 1, ni) + 4 * c4) =
                sm90::pack_bf16(v0, v1);
          }
        }
      }
      if (MODE != FINAL) {  // the residual of row i, from the middle input row
        Acc nr;
        if (MODE == RES_ID) {
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float2 v = sm90::unpack_bf16(*reinterpret_cast<const uint32_t*>(
                    rows[1] + swz(j0 + 16 * mi + g + 8 * h + 1, ni) + 4 * c4));
                nr[mi][ni][2 * h] = v.x;
                nr[mi][ni][2 * h + 1] = v.y;
              }
        } else {
          zero_acc(nr);
          if (live) {
            const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, hi = lane >> 4;
#pragma unroll
            for (int kc = 0; kc < 2; ++kc) {
              uint32_t af[MI][4];
#pragma unroll
              for (int mi = 0; mi < MI; ++mi) sm90::ldsm_a(af[mi], rows[1] + swz(j0 + 16 * mi + 1 + lr, kc * 2 + hi));
#pragma unroll
              for (int nj = 0; nj < 2; ++nj) {
                uint32_t bfr[4];
                sm90::ldsm_bt(bfr, sm + L::ws + swz(kc * 16 + lr, nj * 2 + hi));
#pragma unroll
                for (int mi = 0; mi < MI; ++mi) {
                  sm90::mma_bf16(nr[mi][2 * nj], af[mi], bfr[0], bfr[1]);
                  sm90::mma_bf16(nr[mi][2 * nj + 1], af[mi], bfr[2], bfr[3]);
                }
              }
            }
          }
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int co = ni * 8 + 2 * c4;
            const float2 s = *reinterpret_cast<const float2*>(sb + 4 * C + co);
            const float2 b = *reinterpret_cast<const float2*>(sb + 5 * C + co);
#pragma unroll
            for (int mi = 0; mi < MI; ++mi)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                nr[mi][ni][2 * h] = nr[mi][ni][2 * h] * s.x + b.x;
                nr[mi][ni][2 * h + 1] = nr[mi][ni][2 * h + 1] * s.y + b.y;
              }
          }
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              res0[mi][ni][e] = res1[mi][ni][e];
              res1[mi][ni][e] = nr[mi][ni][e];
            }
      }
    } else if (MODE != FINAL) {  // h1 rows Fout and Fout + 1 are zero (conv B's bottom edge)
      for (int k = tid; k < W * 4; k += THREADS)
        *reinterpret_cast<uint4*>(h1 + (size_t)(i % NH) * ROWB + swz((k >> 2) + 1, k & 3)) = make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) res0[mi][ni][e] = res1[mi][ni][e];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
fcm_tc_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, Params prm, bf16* scratch, int Tlen, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int item = blockIdx.x / n_tiles, tile = blockIdx.x - item * n_tiles;
  const int t_lo = tile * TT - HALO;  // the global frame of window frame 0
  bf16* P = scratch + (size_t)blockIdx.x * SLAB;
  bf16* Q = P + 80 * ROW;
  bf16* R = Q + 40 * ROW;
  bf16* oi = out + (size_t)item * Tlen * (C * 10);
  auto w = [&](int u) { return reinterpret_cast<const bf16*>(prm.w[u]); };

  conv1(x + (size_t)item * Tlen * NF, w(0), prm.sb[0], P, reinterpret_cast<float*>(smem), t_lo, Tlen);
  // layer1_0 (stride 2): P (80) -> Q (40), shortcut from P
  unit<RES_SC>(P, 80, Q, w(1), prm.sb[1], w(2), prm.sb[2], w(3), prm.sb[3], oi, smem, t_lo, Tlen);
  // layer1_1: Q (40) -> R (40), identity shortcut
  unit<RES_ID>(Q, 40, R, w(4), prm.sb[4], w(5), prm.sb[5], nullptr, nullptr, oi, smem, t_lo, Tlen);
  // layer2_0 (stride 2): R (40) -> Q (20), shortcut from R
  unit<RES_SC>(R, 40, Q, w(6), prm.sb[6], w(7), prm.sb[7], w(8), prm.sb[8], oi, smem, t_lo, Tlen);
  // layer2_1: Q (20) -> R (20), identity shortcut
  unit<RES_ID>(Q, 20, R, w(9), prm.sb[9], w(10), prm.sb[10], nullptr, nullptr, oi, smem, t_lo, Tlen);
  // conv2 (stride 2): R (20) -> the output tile, 10 rows
  unit<FINAL>(R, 20, nullptr, w(11), prm.sb[11], nullptr, nullptr, nullptr, nullptr, oi, smem, t_lo, Tlen);
}

int launch(const void* x, void* out, const void* const* w, const void* const* sb, void* scratch, int B, int Tlen,
           void* stream) {
  Params prm;
  for (int u = 0; u < UNITS; ++u) {
    prm.w[u] = w[u];
    prm.sb[u] = static_cast<const float*>(sb[u]);
  }
  const int n_tiles = (Tlen + TT - 1) / TT;
  const size_t smem = Layout::total;
  cudaError_t err = cudaFuncSetAttribute(fcm_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fcm_tc_kernel<<<B * n_tiles, THREADS, smem, (cudaStream_t)stream>>>((const bf16*)x, (bf16*)out, prm,
                                                                      (bf16*)scratch, Tlen, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace k4tc

}  // namespace

extern "C" {

const char* sdt_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// the time tiling: a block's window of frames, and the halo on each side
int sdt_fcm_window(int bf16) { return bf16 ? k4tc::W : W; }
int sdt_fcm_halo() { return HALO; }

// elements of the global scratch (in the compute dtype) a launch needs
size_t sdt_fcm_scratch_elems(int B, int Tlen, int bf16) {
  if (bf16) return (size_t)B * ((Tlen + k4tc::TT - 1) / k4tc::TT) * k4tc::SLAB;
  return (size_t)B * ((Tlen + TT - 1) / TT) * SLAB;
}

// x (B, T, 80) and out (B, T, 320) in the compute dtype; w and sb: host arrays
// of the 12 units' device pointers (kernels/fcm.prepare_fcm_params order).
int sdt_fcm_f32(const void* x, void* out, const void* const* w, const void* const* sb, void* scratch,
                int B, int Tlen, void* stream) {
  return launch<float>(x, out, w, sb, scratch, B, Tlen, stream);
}

int sdt_fcm_bf16(const void* x, void* out, const void* const* w, const void* const* sb, void* scratch,
                 int B, int Tlen, void* stream) {
  return k4tc::launch(x, out, w, sb, scratch, B, Tlen, stream);
}

}  // extern "C"
