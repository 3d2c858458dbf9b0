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
//
// Design. One item's (80, T, 32) activation at T = 398 is 2 MB in bf16,
// far beyond one block's 227 KB of shared memory, where the TPU kernel kept
// the whole head resident in VMEM. So a block owns one batch item and one
// window of W = 128 frames: an output tile of TT = 108 frames plus a halo of
// 10 frames on each side, one per time-tapped conv (ten of them), recomputed
// by the neighbouring tiles. After conv k the window's frames [k, W - k) are
// exact, so the final conv leaves [10, 118) exact. The block's activations
// live in its own slice of a global scratch (P: 80 rows, Q and R: 40 rows
// each, a row being W frames x 32 channels), written and re-read by the same
// block, so no block waits for another and any B and T are taken (grid B x
// ceil(T / 108)). Each conv walks its output frequency rows: the three input
// rows it reads (and the block input's row 2f for a shortcut) are staged in
// shared memory with a zero frame at each end (a ring of three slots, so a
// stride-1 conv stages one new row per output row), and each of the 8 warps
// computes 16 frames x 32 channels of the row; the rows of the next output
// row are loaded into registers meanwhile. The bf16 instance runs the
// (16 frames x 288) x (288 x 32) product per warp on the tensor cores
// (wmma 16x16x16 bf16 fragments, fp32 accumulators); the fp32 instance
// runs it as fp32 FMAs on CUDA cores (the tensor cores have no full-fp32
// mode). conv1 has one input channel (9 taps) and runs as FMAs in both.
// An intermediate frame outside [0, T) is written as 0, not computed, so the
// next conv sees the zero padding the JAX code gives it. The scratch is read
// with plain (coherent) loads: the block wrote it itself, behind barriers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <type_traits>

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
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
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
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        using namespace nvcuda;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c0, c1;
        wmma::fill_fragment(c0, 0.f);
        wmma::fill_fragment(c1, 0.f);
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const T* ab = sm.rows + (((stride * fo + tap / 3) % 3) * WP + j0 + tap % 3) * C;
          const T* wb = sm.wsm + tap * C * C;
#pragma unroll
          for (int kc = 0; kc < 2; ++kc) {
            wmma::load_matrix_sync(a, ab + kc * 16, C);
            wmma::load_matrix_sync(b, wb + kc * 16 * C, C);
            wmma::mma_sync(c0, a, b, c0);
            wmma::load_matrix_sync(b, wb + kc * 16 * C + 16, C);
            wmma::mma_sync(c1, a, b, c1);
          }
        }
        wmma::store_matrix_sync(accw, c0, C, wmma::mem_row_major);
        wmma::store_matrix_sync(accw + 16, c1, C, wmma::mem_row_major);
        if (MODE == RES_SC) {
          wmma::fill_fragment(c0, 0.f);
          wmma::fill_fragment(c1, 0.f);
#pragma unroll
          for (int kc = 0; kc < 2; ++kc) {
            wmma::load_matrix_sync(a, sm.scrow + j0 * C + kc * 16, C);
            wmma::load_matrix_sync(b, sm.wsc + kc * 16 * C, C);
            wmma::mma_sync(c0, a, b, c0);
            wmma::load_matrix_sync(b, sm.wsc + kc * 16 * C + 16, C);
            wmma::mma_sync(c1, a, b, c1);
          }
          wmma::store_matrix_sync(accs, c0, C, wmma::mem_row_major);
          wmma::store_matrix_sync(accs + 16, c1, C, wmma::mem_row_major);
        }
      } else {
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
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 2 : 1)
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

}  // namespace

extern "C" {

const char* sdt_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// elements of the global scratch (in the compute dtype) a launch needs
size_t sdt_fcm_scratch_elems(int B, int Tlen) {
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
  return launch<__nv_bfloat16>(x, out, w, sb, scratch, B, Tlen, stream);
}

}  // extern "C"
