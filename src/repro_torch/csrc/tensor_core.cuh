// What the tensor-core kernels (ssd_chunk.cu, ssd_chunk_bwd.cu,
// swa_attention.cu) share: 16-byte cp.async copies into shared memory,
// ldmatrix fragment loads, the pieces of 3xTF32, f32 products on the
// tensor cores at about f32 accuracy, and bf16 products with an f32
// operand split into bf16 hi + lo.
//
// 3xTF32: each f32 operand is split as x = hi + lo, hi = x rounded to TF32
// (cvt.rna, ties away from zero) and lo = x - hi (exact in f32). lo goes
// to the tensor cores as its f32 bits, of which they read the TF32 part.
// A product a * b is then lo_a * hi_b + hi_a * lo_b + hi_a * hi_b
// (lo * lo dropped), each pass an mma.sync.m16n8k8 with f32 accumulation:
// about 2^-22 relative error per product, where one TF32 pass gives 2^-11.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// Copy 16 bytes from device to shared memory asynchronously; of them only
// the first `bytes` are read, the rest of the 16 are zero-filled. Both
// addresses are 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}
// Copy 4 bytes asynchronously (zero-filled where `bytes` is 0); both
// addresses 4-byte aligned
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo: hi = x rounded to TF32; lo = x - hi (exact in f32) goes to
// the tensor cores as its f32 bits, of which they read the TF32 part. The
// rounding is cvt.rna.tf32.f32's (to nearest, ties away from zero) done on
// the bits: adding half a TF32 step to the magnitude and clearing the 13
// low bits gives cvt.rna's word for every finite input and infinity (a
// NaN still gives a NaN lo), in two integer operations, where sm_90 runs
// cvt.rna as a sequence of compares and selects.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

// d += a b, one m16n8k8 TF32 product with f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 b16 matrices (8 x 4 b32): lane l names row l % 8 of matrix
// l / 8 (16 bytes, 16-byte aligned); r[i] is matrix i's fragment: lane l
// gets the 32-bit word l % 4 of row l / 4
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
// The same, transposed: lane l gets b16 elements (2 (l % 4), l / 4) and
// (2 (l % 4) + 1, l / 4) of each matrix
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a b, one m16n8k16 bf16 product with f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (x, y) = hi + lo, each a bf16 pair (x in the low half): about 2^-16
// relative error where one bf16 rounding gives 2^-8
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

}  // namespace tc
