// Tensor-core and asynchronous-copy building blocks shared by the port's
// bf16 kernels (sm_80 instructions, all available on sm_90a):
//
//   cp_async16   16-byte global -> shared copy (cp.async.cg), zero-filled
//                when the source is out of range; cp_async8 the same for 8
//                bytes (cp.async.ca: .cg takes 16 only);
//   ldsm_x4[_t]  ldmatrix of four 8x8 bf16 matrices (.trans for an operand
//                stored k-major, as V or a row-major B);
//   mma_bf16     mma.sync.m16n8k16, bf16 in, fp32 accumulate in place.
//
// Fragment layouts (PTX ISA, "mma.m16n8k16"): lane l holds the A rows
// l/4 and l/4 + 8, the B column l/4, and the C/D rows l/4 and l/4 + 8 at
// columns 2*(l%4) and 2*(l%4) + 1.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies 16 bytes, or writes 16 zero bytes when !valid (src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// Copies 8 bytes, or writes 8 zero bytes when !valid (src is not read).
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b on one m16n8k16 tile.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16x2 register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A float as the sum of two bf16 (hi + lo, lo the rounding error of hi):
// about 16 significant bits, for an fp32 operand of a bf16 product.
__device__ __forceinline__ void split_bf16(float v, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16(v));
  lo = v - hi;
}

}  // namespace tc
