// AirComp over the compressed (m, s) cohort plane, without the dense
// (m, d) plane. Replaces the TPU kernel
// repro/kernels/aircomp_sum.py::gather_superpose_pallas (body
// _gather_superpose_kernel). With w_k = bp_k (times scale_k for int8 rows):
//     agg[c] = (noise[c] + sum_k sum_j w_k * f32(v[k, j]) [idx[k, j] == c])
//              / max(sum_k bp_k, vs_min)
//     raw    = sum_k bp_k                                  (unclamped)
// values are f32, bf16 or int8; idx is i32 in [0, d), distinct within a
// row; bp, scale and noise are f32; every sum is f32.
//
// Bound on the H100: memory. m*s values and indices are read once and
// one d-vector is written: m*s*(sizeof(v) + 4) + 8m + 8d bytes. At the
// main path's (64, 504, 8070) that is 0.32 MB, far too little to fill the
// card, so the kernel is bound by latency there.
//
// Design: a scatter that stays deterministic without atomics. A block
// owns a stripe of kStripe columns and keeps its f32 accumulator in
// shared memory, starting from the noise (the Pallas kernel's _init).
// It walks the rows k = 0..m-1 in order; its threads stride over the
// row's s entries and add w_k * v where the index falls in the stripe. A
// row's indices are distinct, so no two threads of a row hit one column,
// and a __syncthreads() between rows orders the rows: every column sums
// noise, then row 0, row 1, ... in a fixed order, and repeated calls are
// bit-identical. Rows with w_k = 0 are not skipped: 0 * v is added as the
// reference adds it. Every block sums bp in the same fixed order, so all
// divide by the same varsigma, and block 0 writes it. The ragged last
// stripe and the element range are masked; nothing is padded or copied.
// Each block reads all m*s indices (from L2 after the first); stripes of
// 128 columns give one wave of 128 blocks at d = 16384.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStripe = 128;  // columns per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_superpose_kernel(const T* __restrict__ values,
                        const int32_t* __restrict__ idx,
                        const float* __restrict__ bp,
                        const float* __restrict__ scale,
                        const float* __restrict__ noise,
                        float* __restrict__ agg, float* __restrict__ raw_out,
                        int64_t m, int64_t s, int64_t d, float vs_min) {
  __shared__ float acc[kStripe];
  __shared__ float red[kThreads];
  const int tid = threadIdx.x;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * kStripe;
  const int width = static_cast<int>(d - lo < kStripe ? d - lo : kStripe);

  for (int c = tid; c < width; c += kThreads) acc[c] = noise[lo + c];

  // varsigma: the same fixed-order sum in every block
  float part = 0.f;
  for (int64_t k = tid; k < m; k += kThreads) part += bp[k];
  red[tid] = part;
  __syncthreads();
#pragma unroll
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (tid < off) red[tid] += red[tid + off];
    __syncthreads();
  }
  const float raw = red[0];

  for (int64_t k = 0; k < m; ++k) {
    const float w = scale == nullptr ? bp[k] : __fmul_rn(bp[k], scale[k]);
    const int64_t base = k * s;
    for (int64_t j = tid; j < s; j += kThreads) {
      const int64_t c = static_cast<int64_t>(idx[base + j]) - lo;
      if (c >= 0 && c < width) {
        acc[c] = fmaf(w, to_f32(values[base + j]), acc[c]);
      }
    }
    __syncthreads();
  }

  const float denom = fmaxf(raw, vs_min);
  for (int c = tid; c < width; c += kThreads) agg[lo + c] = acc[c] / denom;
  if (blockIdx.x == 0 && tid == 0) *raw_out = raw;
}

}  // namespace

// values: (m, s) row-major, dtype 0 = f32, 1 = bf16, 2 = int8. idx: (m, s)
// i32. bp: (m,) f32. scale: (m,) f32 or null. noise: (d,) f32. agg: (d,)
// f32. raw: one f32. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int repro_gather_superpose(const void* values, const void* idx,
                                      const void* bp, const void* scale,
                                      const void* noise, void* agg, void* raw,
                                      int64_t m, int64_t s, int64_t d,
                                      float vs_min, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>((d + kStripe - 1) / kStripe));
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* w = static_cast<const float*>(bp);
  const float* sc = static_cast<const float*>(scale);
  const float* n = static_cast<const float*>(noise);
  float* out = static_cast<float*>(agg);
  float* vs = static_cast<float*>(raw);
  if (dtype == 1) {
    gather_superpose_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(values), ix, w, sc, n, out, vs, m,
        s, d, vs_min);
  } else if (dtype == 2) {
    gather_superpose_kernel<int8_t><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(values), ix, w, sc, n, out, vs, m, s, d,
        vs_min);
  } else {
    gather_superpose_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(values), ix, w, sc, n, out, vs, m, s, d,
        vs_min);
  }
  return static_cast<int>(cudaGetLastError());
}
