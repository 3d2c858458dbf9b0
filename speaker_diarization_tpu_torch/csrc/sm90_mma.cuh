// Warp-level tensor-core and async-copy helpers shared by the bf16 kernels
// (cam_block.cu, fcm.cu): mma.sync m16n8k16 bf16 -> fp32, ldmatrix, cp.async.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16), with g = lane / 4 and
// c = lane % 4:
//   A (16 x 16, row-major): a0 (row g, cols 2c, 2c+1), a1 (row g+8, same
//     cols), a2 (row g, cols 2c+8, 2c+9), a3 (row g+8, cols 2c+8, 2c+9)
//   B (16 x 8):             b0 (rows 2c, 2c+1, col g), b1 (rows 2c+8, 2c+9)
//   C (16 x 8, fp32):       c0, c1 (row g, cols 2c, 2c+1), c2, c3 (row g+8)
// ldsm_a loads one A fragment: lane l gives the address of row
// (l & 7) + 8 ((l >> 3) & 1), column 8 (l >> 4) of the tile. ldsm_bt loads
// the B fragments of two n8 tiles from a row-major [k][n] tile: lane l gives
// row (l & 7) + 8 ((l >> 3) & 1), column 8 (l >> 4); registers 0, 1 are b0,
// b1 of columns 0-7 and registers 2, 3 those of columns 8-15.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared that does not block; ok = false writes zeros
// and reads nothing (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_bt(uint32_t (&b)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_addr(p)));
}

// d += a @ b for one m16n8k16 tile, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

}  // namespace sm90
