// What the tensor-core kernels (ssd_chunk.cu, swa_attention.cu) share:
// 16-byte cp.async copies into shared memory, and the pieces of 3xTF32,
// f32 products on the tensor cores at about f32 accuracy.
//
// 3xTF32: each f32 operand is split as x = hi + lo, hi = x rounded to TF32
// (cvt.rna, ties away from zero) and lo = x - hi (exact in f32). lo goes
// to the tensor cores as its f32 bits, of which they read the TF32 part.
// A product a * b is then lo_a * hi_b + hi_a * lo_b + hi_a * hi_b
// (lo * lo dropped), each pass an mma.sync.m16n8k8 with f32 accumulation:
// about 2^-22 relative error per product, where one TF32 pass gives 2^-11.

#pragma once

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

}  // namespace tc
