// K2: one whole CAM++ dense-TDNN block (L layers) in one launch.
//
// Replaces speaker_diarization_tpu/kernels/cam_block_pallas.py:_block_kernel
// (entry cam_dense_block_pallas). Computes what cam_block.
// cam_dense_block_infer computes: for layer i with c_in = c0 + 32 i live
// channels of the growing buffer,
//   h   = relu(buf[:, :c_in] * s1 + b1)                  (BN folded)
//   u   = relu((h @ W1[:c_in]) * s2 + b2)                 (T, 128)
//   ctx = mean_T(u) + segment means of u                  (n_seg, 128)
//   m   = sigmoid(relu(ctx @ Wc1 + bc1) @ Wc2 + bc2)      (n_seg, 32)
//   buf[:, c_in:c_in+32] = (sum_k shift_{(k-1)d}(u) @ K[k]) * m[seg(t)]
// with ceil-mode segments: n_seg = ceil(T / seg_len), the tail divided by
// its true length. The TPU kernel required T % seg_len == 0 and fell back
// to XLA otherwise, so it never ran at the TS-VAD shape (T = 199); this
// kernel takes any T and any B.
// bf16 instances round to bf16 where the JAX code does (h, u, ctx, the
// context hidden, the output); every sum accumulates in fp32.
//
// What bounds it on the H100: at the TS-VAD shape (B = 64, T = 199; blocks
// of 12/24/16 layers) the block work is ~116 GFLOP of live-channel
// products, 0.12 ms at the bf16 tensor-core peak, against ~75 MB of
// compulsory traffic (~22 us): it is bound by operations, and only the
// tensor cores come near that bound. The layers form a chain (layer i reads
// the 32 channels layer i-1 wrote), so a launch cannot spread one item's
// layers over the card; what it can spread is time.
//
// bf16 design (cam_block_tc_kernel): one thread-block cluster per batch
// item, its cl CTAs (1..8, chosen in Python by cam_block.launch_plan so that
// B * cl fills the 132 SMs: cl = 2 at B = 64) each owning the contiguous
// frames [r tc, min(T, (r+1) tc)). Per layer, each CTA:
//   A. projects its own frames on the tensor cores: mma.sync m16n8k16 bf16
//      with fp32 accumulators over (128 frames x 128) output tiles, 8 warps
//      of 32 x 64. The buffer's k-slices (64 channels; the last one 8 to
//      64, in 1 to 4 k16 steps with zeros past c_in: c0 is a multiple of 8,
//      and the wrapper runs other widths with zero channels after x) and
//      W1's are copied with cp.async into a ring of 3 stages, so the copies of slice k+2
//      overlap the products of slice k, one barrier per slice; the BN, ReLU
//      and the two bf16 roundings of h are applied to the A fragments in
//      registers (bf16x2), and s2/b2 and the ReLU of u in the epilogue
//      straight from the accumulators; u (bf16) goes to shared memory;
//   B. sums u over its part of each segment (four row quarters per column
//      pair, added in a fixed order), then waits at a cluster barrier;
//   C. reads every CTA's partial sums through distributed shared memory,
//      adding them in rank order (so each run gives the same bits), and
//      copies the dil-frame halo of u on each side from its neighbours'
//      shared memory (zeros outside [0, T)); a second cluster barrier frees
//      the partials and u for the next layer;
//   D. runs the context MLP for its own segments (CUDA cores, all threads);
//   E. runs the dilated k=3 conv on the tensor cores (8 warps of 16 frames x
//      32 channels, the layer's K copied by cp.async during A) and writes
//      conv x mask for its own frames.
// u at frame t reads only buffer row t, so a CTA reads no other CTA's
// buffer rows: the only exchange is the partial sums and the 2 dil halo
// rows, both in shared memory. When u of a CTA's frames does not fit shared
// memory (more than ~270 frames a CTA: long windows where B > 66 leaves
// cl = 1, or windows of minutes), the U_GLOBAL instance keeps u in a global
// scratch (B, 2, T, 128) by layer parity and stages each 128-frame window
// with its halo into shared memory for the conv; so no T is refused.
// On the H100 the three blocks at (64, 199) take 1.22 ms, 10x the bound:
// per layer ~8.3 us that do not grow with c_in (the two cluster barriers,
// the segment sums, the MLP, the conv) and ~1.7 us per 64-channel slice, so
// the chain of 52 layers, more than the products, sets the time now.
//
// fp32 instance (cam_block_kernel<float>, the first design): one block per item
// walks the layers on CUDA cores (fp32 FMAs; TF32 would miss the 2e-4 bar).
// u lives in shared memory while it fits there (T <= 290), in a global
// scratch per item beyond. The 1x1 projection reads only the c_in live
// channels through (104 x 32) x (32 x 128) shared-memory tiles with a
// 13 x 4 register tile per thread; the context reduction, the small MLP and
// the three shifted k=3 products then run from shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

#include "sm90_mma.cuh"

namespace {

constexpr int BNW = 128;    // bottleneck width (bn_size * growth)
constexpr int G = 32;       // growth rate
constexpr int HID = 64;     // CAM context hidden width (BNW / 2)
constexpr int THREADS = 256;
constexpr int RPT = 13;     // projection rows per thread
constexpr int TM = 8 * RPT; // projection rows per tile
constexpr int TK = 32;      // projection depth per tile
constexpr int CONV_RPT = 4; // k=3 conv rows per thread
constexpr int SEGF = 2 * BNW + HID + G;  // floats per segment: sums, ctx, hidden, mask

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
// round a float to the storage type and back (identity for float)
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f<T>(from_f<T>(v)); }

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

template <typename T>
__host__ __device__ inline size_t smem_bytes(int Tlen, int n_seg, bool u_global) {
  size_t n = align16((size_t)BNW * sizeof(T))          // zero row for the conv's edges
             + sizeof(float) * TM * TK                 // h tile
             + sizeof(float) * TK * BNW                // W1 tile
             + align16((size_t)3 * BNW * G * sizeof(T));  // k=3 conv weights of the layer
  if (!u_global)
    n += align16((size_t)Tlen * BNW * sizeof(T))       // u
         + sizeof(float) * (size_t)n_seg * SEGF;       // seg sums, ctx, hidden, mask
  return n;
}

// U_GLOBAL: u (T, 128) and the per-segment arrays live in u_g / seg_g, the
// batch item's slice of a global scratch, instead of shared memory.
template <typename T, bool U_GLOBAL>
__global__ void __launch_bounds__(THREADS, 1)
cam_block_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ s1,
                 const float* __restrict__ b1, const T* __restrict__ W1,
                 const float* __restrict__ s2, const float* __restrict__ b2,
                 const T* __restrict__ K, const T* __restrict__ Wc1,
                 const float* __restrict__ bc1, const T* __restrict__ Wc2,
                 const float* __restrict__ bc2, T* u_g, float* seg_g, int Tlen, int c0,
                 int c_max, int L, int dil, int seg_len, int n_seg) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* p = smem;
  T* zrow = reinterpret_cast<T*>(p);          p += align16((size_t)BNW * sizeof(T));
  float* hs = reinterpret_cast<float*>(p);    p += sizeof(float) * TM * TK;
  float* ws = reinterpret_cast<float*>(p);    p += sizeof(float) * TK * BNW;
  T* ks = reinterpret_cast<T*>(p);            p += align16((size_t)3 * BNW * G * sizeof(T));
  T* us;
  float* segsum;
  if (U_GLOBAL) {
    us = u_g + (size_t)blockIdx.x * Tlen * BNW;
    segsum = seg_g + (size_t)blockIdx.x * n_seg * SEGF;
  } else {
    us = reinterpret_cast<T*>(p);             p += align16((size_t)Tlen * BNW * sizeof(T));
    segsum = reinterpret_cast<float*>(p);
  }
  float* ctx = segsum + n_seg * BNW;
  float* hid = ctx + n_seg * BNW;
  float* msk = hid + n_seg * HID;

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const T* xb = x + (size_t)b * Tlen * c0;
  T* ob = out + (size_t)b * Tlen * c_max;

  for (int i = tid; i < Tlen * c0; i += THREADS) {
    const int t = i / c0, c = i - t * c0;
    ob[(size_t)t * c_max + c] = xb[i];
  }
  for (int i = tid; i < BNW; i += THREADS) zrow[i] = from_f<T>(0.f);
  __syncthreads();

  const int tx = tid & 31;  // projection: output columns 4*tx .. 4*tx+3
  const int ty = tid >> 5;  // projection: rows ty + 8 r

  for (int l = 0; l < L; ++l) {
    const int c_in = c0 + l * G;
    const float* s1l = s1 + (size_t)l * c_max;
    const float* b1l = b1 + (size_t)l * c_max;
    const T* W1l = W1 + (size_t)l * c_max * BNW;
    const float* s2l = s2 + l * BNW;
    const float* b2l = b2 + l * BNW;

    // ---- phase A: u = relu((h @ W1) * s2 + b2), h = relu(buf * s1 + b1)
    for (int r0 = 0; r0 < Tlen; r0 += TM) {
      float acc[RPT][4];
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      for (int k0 = 0; k0 < c_in; k0 += TK) {
        __syncthreads();  // the previous tile has been consumed
        for (int i = tid; i < TM * TK; i += THREADS) {
          const int rr = i / TK, kk = i - rr * TK;
          const int t = r0 + rr, c = k0 + kk;
          float h = 0.f;
          if (t < Tlen && c < c_in) {
            const float v = to_f<T>(ob[(size_t)t * c_max + c]);
            h = fmaxf(rnd<T>(rnd<T>(v * rnd<T>(s1l[c])) + rnd<T>(b1l[c])), 0.f);
          }
          hs[i] = h;
        }
        for (int i = tid; i < TK * BNW; i += THREADS) {
          const int c = k0 + i / BNW;
          ws[i] = (c < c_in) ? to_f<T>(W1l[(size_t)k0 * BNW + i]) : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < TK; ++kk) {
          const float4 w = *reinterpret_cast<const float4*>(&ws[kk * BNW + tx * 4]);
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const float a = hs[(ty + 8 * r) * TK + kk];
            acc[r][0] += a * w.x;
            acc[r][1] += a * w.y;
            acc[r][2] += a * w.z;
            acc[r][3] += a * w.w;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int t = r0 + ty + 8 * r;
        if (t < Tlen) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = tx * 4 + q;
            us[t * BNW + j] = from_f<T>(fmaxf(acc[r][q] * s2l[j] + b2l[j], 0.f));
          }
        }
      }
    }
    // this layer's k=3 weights; read after the barriers below
    const T* Kl = K + (size_t)l * 3 * BNW * G;
    for (int i = tid; i < 3 * BNW * G; i += THREADS) ks[i] = Kl[i];
    __syncthreads();

    // ---- phase B: context = global mean + ceil-mode segment means -> mask
    for (int i = tid; i < n_seg * BNW; i += THREADS) {
      const int s = i / BNW, j = i - s * BNW;
      const int t_hi = min(Tlen, (s + 1) * seg_len);
      float a = 0.f;
      for (int t = s * seg_len; t < t_hi; ++t) a += to_f<T>(us[t * BNW + j]);
      segsum[i] = a;
    }
    __syncthreads();
    for (int i = tid; i < n_seg * BNW; i += THREADS) {
      const int s = i / BNW, j = i - s * BNW;
      float g = 0.f;
      for (int q = 0; q < n_seg; ++q) g += segsum[q * BNW + j];
      const int cnt = min(seg_len, Tlen - s * seg_len);
      ctx[i] = rnd<T>(g / (float)Tlen + segsum[i] / (float)cnt);
    }
    __syncthreads();
    const T* Wc1l = Wc1 + (size_t)l * BNW * HID;
    for (int i = tid; i < n_seg * HID; i += THREADS) {
      const int s = i / HID, k = i - s * HID;
      float a = 0.f;
      for (int j = 0; j < BNW; ++j) a += ctx[s * BNW + j] * to_f<T>(Wc1l[j * HID + k]);
      hid[i] = rnd<T>(fmaxf(a + bc1[l * HID + k], 0.f));
    }
    __syncthreads();
    const T* Wc2l = Wc2 + (size_t)l * HID * G;
    for (int i = tid; i < n_seg * G; i += THREADS) {
      const int s = i / G, g = i - s * G;
      float a = 0.f;
      for (int k = 0; k < HID; ++k) a += hid[s * HID + k] * to_f<T>(Wc2l[k * G + g]);
      msk[i] = 1.f / (1.f + __expf(-(a + bc2[l * G + g])));
    }
    __syncthreads();

    // ---- phase C: dilated k=3 conv of u, masked, into channels c_in..c_in+31
    {
      const int g = tid & 31;
      const int tr = tid >> 5;
      for (int tb = 0; tb < Tlen; tb += 8 * CONV_RPT) {
        float acc[CONV_RPT];
#pragma unroll
        for (int r = 0; r < CONV_RPT; ++r) acc[r] = 0.f;
#pragma unroll
        for (int tap = 0; tap < 3; ++tap) {
          const T* rows[CONV_RPT];
#pragma unroll
          for (int r = 0; r < CONV_RPT; ++r) {
            const int tt = tb + tr + 8 * r + (tap - 1) * dil;
            rows[r] = (tt >= 0 && tt < Tlen) ? us + tt * BNW : zrow;
          }
          const T* kt = ks + tap * BNW * G + g;
          for (int c = 0; c < BNW; ++c) {
            const float kv = to_f<T>(kt[c * G]);
#pragma unroll
            for (int r = 0; r < CONV_RPT; ++r) acc[r] += to_f<T>(rows[r][c]) * kv;
          }
        }
#pragma unroll
        for (int r = 0; r < CONV_RPT; ++r) {
          const int t = tb + tr + 8 * r;
          if (t < Tlen) {
            const float m = msk[(t / seg_len) * G + g];
            ob[(size_t)t * c_max + c_in + g] = from_f<T>(acc[r] * m);
          }
        }
      }
    }
    __syncthreads();  // outputs visible to the next layer; u and ks free
  }
}

template <typename T>
int launch(const void* x, void* out, const void* s1, const void* b1, const void* W1,
           const void* s2, const void* b2, const void* K, const void* Wc1, const void* bc1,
           const void* Wc2, const void* bc2, void* u_g, void* seg_g, int B, int Tlen, int c0,
           int c_max, int L, int dil, int seg_len, void* stream) {
  const int n_seg = (Tlen + seg_len - 1) / seg_len;
  const bool u_global = u_g != nullptr;
  const size_t smem = smem_bytes<T>(Tlen, n_seg, u_global);
  auto kernel = u_global ? cam_block_kernel<T, true> : cam_block_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, (T*)out, (const float*)s1, (const float*)b1, (const T*)W1, (const float*)s2,
      (const float*)b2, (const T*)K, (const T*)Wc1, (const float*)bc1, (const T*)Wc2,
      (const float*)bc2, (T*)u_g, (float*)seg_g, Tlen, c0, c_max, L, dil, seg_len, n_seg);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, T split over a thread-block cluster
// ---------------------------------------------------------------------------

namespace k2tc {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;  // 8 warps
constexpr int MT = 128;       // projection rows per chunk
constexpr int KT = 64;        // projection depth per stage
constexpr int STAGES = 3;     // cp.async ring depth
constexpr int A_LD = KT + 8;  // padded row strides (elements): ldmatrix rows
constexpr int B_LD = BNW + 8; // land on distinct bank groups
constexpr int U_LD = BNW + 8;
constexpr int K_LD = G + 8;
static_assert(THREADS == 4 * HID && THREADS == 8 * G, "the context MLP splits its sums over all threads");

struct Layout {  // byte offsets into dynamic shared memory
  size_t a, b, k, s1, u, seg, total;
};

// u_rows: rows of u in shared memory (the CTA's frames rounded up to 16 plus
// the two halos, or one 128-frame window plus halos for U_GLOBAL); nls: the
// most segments one CTA's frames touch
__host__ __device__ inline Layout layout(int c_max, int u_rows, int nls) {
  Layout o;
  size_t p = 0;
  o.a = p;  p += (size_t)STAGES * MT * A_LD * sizeof(bf16);
  o.b = p;  p += (size_t)STAGES * KT * B_LD * sizeof(bf16);
  o.k = p;  p += (size_t)3 * BNW * K_LD * sizeof(bf16);
  o.s1 = p; p += align16((size_t)2 * c_max * sizeof(bf16));
  o.u = p;  p += align16((size_t)u_rows * U_LD * sizeof(bf16));
  o.seg = p;
  // quarter sums (4 x 128), partial sums (nls x 128), segment totals then
  // ctx (nls x 128), column sums and the cluster's column sums (2 x 128),
  // context hidden (nls x 64), mask (nls x 32)
  p += sizeof(float) * ((size_t)2 * nls * BNW + 6 * BNW + (size_t)nls * (HID + G));
  o.total = p;
  return o;
}

struct Args {
  const bf16* x;
  bf16* out;
  const float *s1, *b1;
  const bf16* W1;
  const float *s2, *b2;
  const bf16 *K, *Wc1;
  const float* bc1;
  const bf16* Wc2;
  const float* bc2;
  bf16* u_g;  // U_GLOBAL: (B, 2, T, 128), u of layer l at parity l & 1
  int T, c0, c_max, L, dil, seg_len, cl, tc, nls, u_rows;
};

// h = relu(bf16(bf16(v * s) + b)) on a pair of bf16 values, in bf16x2
// arithmetic: the product of two bf16 is exact in fp32, and the fp32 sum of
// two bf16 is either exact or off by less than it takes to move the bf16
// rounding, so each correctly rounded bf16 operation gives the bits of the
// fp32 operation rounded to bf16, as the JAX code and the twin compute them.
// The explicit .rn keeps ptxas from contracting the two into one fma, which
// rounds once and moved the block's outputs to a mean-abs of 4.8e-4 from
// the twin's (2.0e-5 with the two roundings).
__device__ __forceinline__ uint32_t bn_relu(uint32_t v, uint32_t s, uint32_t b) {
  uint32_t h;
  asm("{\n .reg .b32 p;\n mul.rn.bf16x2 p, %1, %2;\n add.rn.bf16x2 p, p, %3;\n max.bf16x2 %0, p, %4;\n}\n"
      : "=r"(h)
      : "r"(v), "r"(s), "r"(b), "r"(0u));
  return h;
}

template <bool U_GLOBAL>
__global__ void __launch_bounds__(THREADS, 1) cam_block_tc_kernel(const Args a) {
  namespace cg = cooperative_groups;
  using namespace sm90;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(a.c_max, a.u_rows, a.nls);
  bf16* a_s = reinterpret_cast<bf16*>(smem + lay.a);
  bf16* b_s = reinterpret_cast<bf16*>(smem + lay.b);
  bf16* k_s = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* s1s = reinterpret_cast<bf16*>(smem + lay.s1);  // s1, b1 of the layer in bf16
  bf16* b1s = s1s + a.c_max;
  bf16* u_s = reinterpret_cast<bf16*>(smem + lay.u);
  float* qs = reinterpret_cast<float*>(smem + lay.seg);  // [4][128]
  float* psum = qs + 4 * BNW;                            // [nls][128], read by the cluster
  float* tot = psum + a.nls * BNW;                       // [nls][128]
  float* colsum = tot + a.nls * BNW;                     // [128], read by the cluster
  float* gsum = colsum + BNW;                            // [128]
  float* hid = gsum + BNW;                               // [nls][64]
  float* msk = hid + a.nls * HID;                        // [nls][32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c4 = lane & 3;                   // fragment row / column pair
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;  // ldmatrix row / column
  const int wm = warp & 3, wn = warp >> 2;                  // projection warp tile: rows 32 wm, cols 64 wn
  const int T = a.T, d = a.dil, seg_len = a.seg_len, c_max = a.c_max;
  const int rank = (int)cluster.block_rank();
  const int item = blockIdx.x / a.cl;
  const int t0 = rank * a.tc, t1 = min(T, t0 + a.tc), n = t1 - t0;
  const int s_lo = t0 / seg_len, nl = (t1 - 1) / seg_len - s_lo + 1;
  const bf16* xb = a.x + (size_t)item * T * a.c0;
  bf16* ob = a.out + (size_t)item * T * c_max;

  for (int i = tid; i < n * (a.c0 / 8); i += THREADS) {  // own rows of x into the buffer
    const int r = i / (a.c0 / 8), q = i - r * (a.c0 / 8);
    *reinterpret_cast<uint4*>(ob + (size_t)(t0 + r) * c_max + q * 8) =
        *reinterpret_cast<const uint4*>(xb + (size_t)(t0 + r) * a.c0 + q * 8);
  }

  for (int l = 0; l < a.L; ++l) {
    const int c_in = a.c0 + l * G;
    const float* s1l = a.s1 + (size_t)l * c_max;
    const float* b1l = a.b1 + (size_t)l * c_max;
    const bf16* W1l = a.W1 + (size_t)l * c_max * BNW;
    const float* s2l = a.s2 + l * BNW;
    const float* b2l = a.b2 + l * BNW;
    const bf16* Kl = a.K + (size_t)l * 3 * BNW * G;
    bf16* ug = U_GLOBAL ? a.u_g + ((size_t)item * 2 + (l & 1)) * T * BNW : nullptr;
    // u of own row r (frame t0 + r): shared u_s row d + r, or global ug row t0 + r
    bf16* ubase = U_GLOBAL ? ug + (size_t)t0 * BNW : u_s + d * U_LD;
    const int uld = U_GLOBAL ? BNW : U_LD;

    __syncthreads();  // the previous layer is done with k_s, u_s, s1s and the segment arrays
    for (int i = tid; i < 3 * BNW * (G / 8); i += THREADS)  // K, committed with the first stage
      cp_async16(k_s + (i >> 2) * K_LD + (i & 3) * 8, Kl + (i >> 2) * G + (i & 3) * 8, true);
    // s1, b1 up to the last k16 step's edge (<= c_max), zero past c_in: there
    // the staged buffer columns and W1 rows are zeros, so h and its products are 0
    for (int i = tid; i < (c_in + 15) / 16 * 16; i += THREADS) {
      s1s[i] = __float2bfloat16_rn(i < c_in ? s1l[i] : 0.f);
      b1s[i] = __float2bfloat16_rn(i < c_in ? b1l[i] : 0.f);
    }

    // ---- A: u = relu((h @ W1) * s2 + b2) for own rows, 128 at a time
    const int nk = (c_in + KT - 1) / KT;
    for (int mc = 0; mc < n; mc += MT) {
      const int rows = min(MT, n - mc);
      auto load_tile = [&](int kt) {
        const int k0 = kt * KT, st = kt % STAGES;
        bf16* As = a_s + st * MT * A_LD;
        for (int i = tid; i < MT * (KT / 8); i += THREADS) {
          const int r = i >> 3, q = i & 7, c = k0 + q * 8;
          const bool ok = r < rows && c < c_in;
          cp_async16(As + r * A_LD + q * 8, ok ? ob + (size_t)(t0 + mc + r) * c_max + c : ob, ok);
        }
        bf16* Bs = b_s + st * KT * B_LD;
        for (int i = tid; i < KT * (BNW / 8); i += THREADS) {
          const int r = i >> 4, q = i & 15;
          const bool ok = k0 + r < c_in;
          cp_async16(Bs + r * B_LD + q * 8, ok ? W1l + (size_t)(k0 + r) * BNW + q * 8 : W1l, ok);
        }
      };
      if (mc > 0) __syncthreads();  // the previous chunk's stages are consumed
      float acc[2][8][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;
#pragma unroll
      for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk) load_tile(s);
        cp_async_commit();
      }
      for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // stage kt has landed for every thread; stage kt - 1 is consumed
        if (kt + STAGES - 1 < nk) load_tile(kt + STAGES - 1);
        cp_async_commit();
        const bf16* As = a_s + (kt % STAGES) * MT * A_LD;
        const bf16* Bs = b_s + (kt % STAGES) * KT * B_LD;
        // the k16 steps of this slice: all four, or ceil(rest / 16) in the
        // last one (c_in is a multiple of 8), each count unrolled whole so that
        // the fragment loads of one step overlap the products of the one before
        auto slice_mma = [&](auto n_steps) {
#pragma unroll
          for (int ks = 0; ks < decltype(n_steps)::value; ++ks) {
            const int kc = kt * KT + ks * 16 + 2 * c4;
            const uint32_t sa = *reinterpret_cast<const uint32_t*>(s1s + kc);
            const uint32_t sb = *reinterpret_cast<const uint32_t*>(s1s + kc + 8);
            const uint32_t ba = *reinterpret_cast<const uint32_t*>(b1s + kc);
            const uint32_t bb = *reinterpret_cast<const uint32_t*>(b1s + kc + 8);
            uint32_t af[2][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              ldsm_a(af[mi], As + (wm * 32 + mi * 16 + lr) * A_LD + ks * 16 + lc);
              af[mi][0] = bn_relu(af[mi][0], sa, ba);
              af[mi][1] = bn_relu(af[mi][1], sa, ba);
              af[mi][2] = bn_relu(af[mi][2], sb, bb);
              af[mi][3] = bn_relu(af[mi][3], sb, bb);
            }
#pragma unroll
            for (int nj = 0; nj < 4; ++nj) {
              uint32_t bfr[4];
              ldsm_bt(bfr, Bs + (ks * 16 + lr) * B_LD + wn * 64 + nj * 16 + lc);
#pragma unroll
              for (int mi = 0; mi < 2; ++mi) {
                mma_bf16(acc[mi][2 * nj], af[mi], bfr[0], bfr[1]);
                mma_bf16(acc[mi][2 * nj + 1], af[mi], bfr[2], bfr[3]);
              }
            }
          }
        };
        static_assert(KT == 64, "the dispatch below covers 1 to 4 k16 steps");
        const int rest = c_in - kt * KT;
        if (rest > 48)
          slice_mma(std::integral_constant<int, 4>{});
        else if (rest > 32)
          slice_mma(std::integral_constant<int, 3>{});
        else if (rest > 16)
          slice_mma(std::integral_constant<int, 2>{});
        else
          slice_mma(std::integral_constant<int, 1>{});
      }
      cp_async_wait<0>();
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = wn * 64 + ni * 8 + 2 * c4;
        const float2 sc = *reinterpret_cast<const float2*>(s2l + col);
        const float2 bi = *reinterpret_cast<const float2*>(b2l + col);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm * 32 + mi * 16 + g + 8 * h;
            if (r < rows)
              *reinterpret_cast<uint32_t*>(ubase + (size_t)(mc + r) * uld + col) =
                  pack_bf16(fmaxf(acc[mi][ni][2 * h] * sc.x + bi.x, 0.f), fmaxf(acc[mi][ni][2 * h + 1] * sc.y + bi.y, 0.f));
          }
      }
    }
    __syncthreads();  // u of every own row is written

    // ---- B: partial segment sums of own rows: quarter q of each segment's
    // rows per column pair, then the quarters in order, then the segments
    for (int s = 0; s < nl; ++s) {
      const int p = tid & 63, q = tid >> 6;
      const int lo = max(t0, (s_lo + s) * seg_len) - t0, hi = min(t1, (s_lo + s + 1) * seg_len) - t0;
      const int qa = lo + (hi - lo) * q / 4, qe = lo + (hi - lo) * (q + 1) / 4;
      float x0 = 0.f, x1 = 0.f;
      for (int r = qa; r < qe; ++r) {
        const float2 v = unpack_bf16(*reinterpret_cast<const uint32_t*>(ubase + (size_t)r * uld + 2 * p));
        x0 += v.x;
        x1 += v.y;
      }
      qs[q * BNW + 2 * p] = x0;
      qs[q * BNW + 2 * p + 1] = x1;
      __syncthreads();
      if (tid < BNW) psum[s * BNW + tid] = ((qs[tid] + qs[BNW + tid]) + qs[2 * BNW + tid]) + qs[3 * BNW + tid];
      __syncthreads();
    }
    if (tid < BNW) {
      float c = 0.f;
      for (int s = 0; s < nl; ++s) c += psum[s * BNW + tid];
      colsum[tid] = c;
    }
    if (U_GLOBAL) __threadfence();  // u in the global scratch, for the neighbours' halos
    cluster.sync();

    // ---- C: the cluster's sums in rank order; the halos of u
    if (tid < BNW) {
      float gs = 0.f;
      for (int r = 0; r < a.cl; ++r) gs += cluster.map_shared_rank(colsum, r)[tid];
      gsum[tid] = gs;
    }
    for (int i = tid; i < nl * BNW; i += THREADS) {
      const int S = s_lo + i / BNW, j = i % BNW;
      float v = 0.f;
      for (int r = 0; r < a.cl; ++r) {
        const int rlo = r * a.tc / seg_len, rhi = (min(T, (r + 1) * a.tc) - 1) / seg_len;
        if (S >= rlo && S <= rhi) v += cluster.map_shared_rank(psum, r)[(S - rlo) * BNW + j];
      }
      tot[i] = v;
    }
    if (!U_GLOBAL) {  // frames t0 - d .. t0 - 1 and t1 .. t1 + d - 1, zero outside [0, T)
      for (int i = tid; i < 2 * d * (BNW / 8); i += THREADS) {
        const int hr = i / (BNW / 8), q = i % (BNW / 8);
        const int t = hr < d ? t0 - d + hr : t1 + hr - d;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (t >= 0 && t < T) {
          const int r = t / a.tc;
          v = *reinterpret_cast<const uint4*>(cluster.map_shared_rank(u_s, r) + (size_t)(d + t - r * a.tc) * U_LD + q * 8);
        }
        *reinterpret_cast<uint4*>(u_s + (size_t)(d + t - t0) * U_LD + q * 8) = v;
      }
    }
    cluster.sync();  // every CTA has read the partials and halos it needs

    // ---- D: context -> mask for own segments
    for (int i = tid; i < nl * BNW; i += THREADS) {
      const int S = s_lo + i / BNW, j = i % BNW;
      const int cnt = min(seg_len, T - S * seg_len);
      tot[i] = bf16_round(gsum[j] / (float)T + tot[i] / (float)cnt);
    }
    __syncthreads();
    // the two small products with every thread: 4 (8) partial sums over a
    // fully unrolled quarter (eighth) of the inputs, so their global loads
    // are all in flight at once, then the parts added in order
    const bf16* Wc1l = a.Wc1 + (size_t)l * BNW * HID;
    const bf16* Wc2l = a.Wc2 + (size_t)l * HID * G;
    for (int s = 0; s < nl; ++s) {
      {
        const int k = tid & (HID - 1), part = tid / HID;
        float v = 0.f;
#pragma unroll
        for (int jj = 0; jj < BNW / 4; ++jj) {
          const int j = part * (BNW / 4) + jj;
          v += tot[s * BNW + j] * __bfloat162float(Wc1l[j * HID + k]);
        }
        qs[part * HID + k] = v;
      }
      __syncthreads();
      if (tid < HID)
        hid[s * HID + tid] = bf16_round(
            fmaxf(((qs[tid] + qs[HID + tid]) + qs[2 * HID + tid]) + qs[3 * HID + tid] + a.bc1[l * HID + tid], 0.f));
      __syncthreads();
      {
        const int gg = tid & (G - 1), part = tid / G;
        float v = 0.f;
#pragma unroll
        for (int kk = 0; kk < HID / 8; ++kk) {
          const int k = part * (HID / 8) + kk;
          v += hid[s * HID + k] * __bfloat162float(Wc2l[k * G + gg]);
        }
        qs[part * G + gg] = v;
      }
      __syncthreads();
      if (tid < G) {
        float v = 0.f;
        for (int part = 0; part < 8; ++part) v += qs[part * G + tid];
        msk[s * G + tid] = 1.f / (1.f + __expf(-(v + a.bc2[l * G + tid])));
      }
      __syncthreads();
    }

    // ---- E: dilated k=3 conv of u on the tensor cores, masked, into c_in .. c_in + 31
    for (int mc = 0; mc < n; mc += MT) {
      const bf16* win;  // row i: own row mc - d + i
      if (U_GLOBAL) {
        if (mc > 0) __syncthreads();  // the previous window is consumed
        for (int i = tid; i < (MT + 2 * d) * (BNW / 8); i += THREADS) {
          const int r = i >> 4, q = i & 15, t = t0 + mc - d + r;
          const bool ok = t >= 0 && t < T;
          cp_async16(u_s + r * U_LD + q * 8, ok ? ug + (size_t)t * BNW + q * 8 : ug, ok);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        win = u_s;
      } else {
        win = u_s + (size_t)mc * U_LD;
      }
      const int r0 = warp * 16;
      if (mc + r0 < n) {
        float acc[4][4];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) acc[ni][0] = acc[ni][1] = acc[ni][2] = acc[ni][3] = 0.f;
#pragma unroll
        for (int tap = 0; tap < 3; ++tap) {
#pragma unroll
          for (int kc = 0; kc < BNW / 16; ++kc) {
            uint32_t af[4];
            ldsm_a(af, win + (size_t)(r0 + lr + tap * d) * U_LD + kc * 16 + lc);
#pragma unroll
            for (int nj = 0; nj < 2; ++nj) {
              uint32_t bfr[4];
              ldsm_bt(bfr, k_s + (tap * BNW + kc * 16 + lr) * K_LD + nj * 16 + lc);
              mma_bf16(acc[2 * nj], af, bfr[0], bfr[1]);
              mma_bf16(acc[2 * nj + 1], af, bfr[2], bfr[3]);
            }
          }
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = ni * 8 + 2 * c4;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = mc + r0 + g + 8 * h;
            if (r < n) {
              const int t = t0 + r;
              const float* m = msk + (t / seg_len - s_lo) * G + col;
              *reinterpret_cast<uint32_t*>(ob + (size_t)t * c_max + c_in + col) =
                  pack_bf16(acc[ni][2 * h] * m[0], acc[ni][2 * h + 1] * m[1]);
            }
          }
        }
      }
    }
  }
}

template <bool U_GLOBAL>
int launch(const Args& a, int B, void* stream) {
  const size_t smem = layout(a.c_max, a.u_rows, a.nls).total;
  auto kernel = cam_block_tc_kernel<U_GLOBAL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * a.cl);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace k2tc

}  // namespace

extern "C" {

const char* sdt_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// fp32 instance: shared memory the launch needs; u_global: u kept in the global scratch
size_t sdt_cam_block_smem_bytes(int Tlen, int seg_len, int u_global) {
  const int n_seg = (Tlen + seg_len - 1) / seg_len;
  return smem_bytes<float>(Tlen, n_seg, u_global);
}

// bf16 instance: shared memory of one CTA (kernels/cam_block.launch_plan)
size_t sdt_cam_block_tc_smem_bytes(int c_max, int u_rows, int nls) {
  return k2tc::layout(c_max, u_rows, nls).total;
}

// u_g (B, T, 128) fp32 and seg_g (B, n_seg, 352) fp32 are the global
// scratch, or both null to keep u in shared memory.
int sdt_cam_block_f32(const void* x, void* out, const void* s1, const void* b1, const void* W1,
                      const void* s2, const void* b2, const void* K, const void* Wc1,
                      const void* bc1, const void* Wc2, const void* bc2, void* u_g, void* seg_g,
                      int B, int Tlen, int c0, int c_max, int L, int dil, int seg_len,
                      void* stream) {
  return launch<float>(x, out, s1, b1, W1, s2, b2, K, Wc1, bc1, Wc2, bc2, u_g, seg_g, B, Tlen,
                       c0, c_max, L, dil, seg_len, stream);
}

// The cluster plan (cl CTAs per item owning tc frames each, nls, u_rows)
// comes from kernels/cam_block.launch_plan; u_g (B, 2, T, 128) bf16 is the
// global scratch of the U_GLOBAL instance, or null.
int sdt_cam_block_bf16(const void* x, void* out, const void* s1, const void* b1, const void* W1,
                       const void* s2, const void* b2, const void* K, const void* Wc1,
                       const void* bc1, const void* Wc2, const void* bc2, void* u_g, int B,
                       int Tlen, int c0, int c_max, int L, int dil, int seg_len, int cl, int tc,
                       int nls, int u_rows, void* stream) {
  if (cl < 1 || cl > 8 || (cl > 1 && tc < dil) || (cl - 1) * tc >= Tlen || cl * tc < Tlen || c0 % 8 != 0)
    return (int)cudaErrorInvalidValue;
  using k2tc::bf16;
  k2tc::Args a{(const bf16*)x, (bf16*)out, (const float*)s1, (const float*)b1, (const bf16*)W1,
             (const float*)s2, (const float*)b2, (const bf16*)K, (const bf16*)Wc1,
             (const float*)bc1, (const bf16*)Wc2, (const float*)bc2, (bf16*)u_g,
             Tlen, c0, c_max, L, dil, seg_len, cl, tc, nls, u_rows};
  return u_g ? k2tc::launch<true>(a, B, stream) : k2tc::launch<false>(a, B, stream);
}

}  // extern "C"
