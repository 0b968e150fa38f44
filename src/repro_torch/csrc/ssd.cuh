// What the SSD intra-chunk kernels (ssd_chunk.cu, the forward, and
// ssd_chunk_bwd.cu, the backward) share: loads and stores of f32 or bf16
// elements as f32, and the reference's clipped decay.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ssd {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// exp(clip(x, -60, 0)), the reference's clip before exp
__device__ __forceinline__ float clipped_exp(float x) {
  return expf(fminf(fmaxf(x, -60.f), 0.f));
}

// Four consecutive elements as f32 (16-byte or 8-byte aligned loads)
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}

}  // namespace ssd
