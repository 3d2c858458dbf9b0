// K2: one whole CAM++ dense-TDNN block (L layers) in one launch.
//
// Replaces speaker_diarization_tpu/kernels/cam_block_pallas.py:_block_kernel
// (entry cam_dense_block_pallas). Computes what cam_block_fused.
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
// compulsory traffic (~22 us): it is bound by operations. This first
// version runs them as fp32 FMAs on CUDA cores, so it sits far above that
// bound: the tensor cores (wgmma) are the next step.
// Design: one block per batch item walks the L layers in order. The
// growing channel buffer is the output tensor itself (the block-2/3 buffers
// of 26 MB at B = 64 stay in the 50 MB L2); u of the current layer lives in
// shared memory while it fits there (T <= 290 in fp32, T <= 656 in bf16,
// i.e. windows up to about 5.8 s / 13 s). Longer windows take the
// U_GLOBAL instance, which keeps u and the per-segment context arrays in a
// global scratch per batch item instead (L2-resident at these sizes), so
// no T is refused. The 1x1 projection reads only the c_in live channels
// (the TPU's zero-padded c_max-wide matmul is not repeated) through
// (104 x 32) x (32 x 128) shared-memory tiles with a 13 x 4 register tile
// per thread. The context reduction, the small MLP and the three shifted
// k=3 products then run from shared memory; __syncthreads() separates the
// phases. B = 64 blocks under-fill the 132 SMs: splitting T over a cluster
// or packing several items per SM is left to a later version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

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
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
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

}  // namespace

extern "C" {

const char* sdt_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// shared memory the launch needs; u_global: u kept in the global scratch
size_t sdt_cam_block_smem_bytes(int Tlen, int seg_len, int bf16, int u_global) {
  const int n_seg = (Tlen + seg_len - 1) / seg_len;
  return bf16 ? smem_bytes<__nv_bfloat16>(Tlen, n_seg, u_global)
              : smem_bytes<float>(Tlen, n_seg, u_global);
}

// u_g (B, T, 128) in the compute dtype and seg_g (B, n_seg, 352) fp32 are the
// global scratch, or both null to keep u in shared memory.
int sdt_cam_block_f32(const void* x, void* out, const void* s1, const void* b1, const void* W1,
                      const void* s2, const void* b2, const void* K, const void* Wc1,
                      const void* bc1, const void* Wc2, const void* bc2, void* u_g, void* seg_g,
                      int B, int Tlen, int c0, int c_max, int L, int dil, int seg_len,
                      void* stream) {
  return launch<float>(x, out, s1, b1, W1, s2, b2, K, Wc1, bc1, Wc2, bc2, u_g, seg_g, B, Tlen,
                       c0, c_max, L, dil, seg_len, stream);
}

int sdt_cam_block_bf16(const void* x, void* out, const void* s1, const void* b1, const void* W1,
                       const void* s2, const void* b2, const void* K, const void* Wc1,
                       const void* bc1, const void* Wc2, const void* bc2, void* u_g, void* seg_g,
                       int B, int Tlen, int c0, int c_max, int L, int dil, int seg_len,
                       void* stream) {
  return launch<__nv_bfloat16>(x, out, s1, b1, W1, s2, b2, K, Wc1, bc1, Wc2, bc2, u_g, seg_g, B,
                               Tlen, c0, c_max, L, dil, seg_len, stream);
}

}  // extern "C"
