// Fused superpose-and-normalize: sweep 2 of the PAOTA round (eqs. 6 + 8)
// over the (K, D) payload plane.
//
// Replaces the TPU kernel
// repro/kernels/aircomp_sum.py::superpose_normalize_pallas (body
// _superpose_kernel). With bp_k = p_k * mask_k:
//     agg[d]   = (sum_k bp_k * x[k, d] + noise[d]) / max(sum_k bp_k, vs_min)
//     varsigma = sum_k bp_k                                   (raw)
// x is f32 or bf16; p, mask and noise are f32; every sum is f32.
//
// Bound on the H100: memory. K*D payload elements are read once for one
// FMA each; the output is one D-vector.
//
// Design: a reduction over K for each column, so a block owns 32
// neighbouring columns (one per lane: every row load of a warp is one
// coalesced 128-byte line in f32) and its 8 warps split the K rows
// between them (warp w takes rows w, w+8, ...), which gives D/32 blocks
// of 256 threads enough loads in flight. bp is staged in shared memory
// 256 rows at a time. The 8 warp partials of a column are added in a
// fixed order, and every block sums bp in the same fixed order, so all
// blocks divide by the same varsigma and block 0 writes it: no atomics,
// and the result is identical from run to run. The noise joins the f32
// sum before the division. Rows are D elements apart (D = 8070 is not a
// multiple of 4), so loads are scalar and the ragged last block is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;  // columns per block, one per lane

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
superpose_kernel(const T* __restrict__ x, const float* __restrict__ powers,
                 const float* __restrict__ mask,
                 const float* __restrict__ noise, float* __restrict__ agg,
                 float* __restrict__ varsigma, int64_t k, int64_t d,
                 float vs_min) {
  __shared__ float s_bp[kThreads];
  __shared__ float s_acc[kWarps][kCols + 1];
  __shared__ float s_vs[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kCols + lane;
  const bool live = col < d;

  float acc = 0.f;  // this warp's share of column `col`
  float vs = 0.f;   // this thread's share of sum_k bp_k
  for (int64_t k0 = 0; k0 < k; k0 += kThreads) {
    const int64_t kk = k0 + tid;
    const float bp = kk < k ? __fmul_rn(powers[kk], mask[kk]) : 0.f;
    s_bp[tid] = bp;
    vs += bp;
    __syncthreads();
    const int n = static_cast<int>(k - k0 < kThreads ? k - k0 : kThreads);
    if (live) {
      const T* xc = x + k0 * d + col;
#pragma unroll 4
      for (int j = warp; j < n; j += kWarps) {
        acc = fmaf(s_bp[j], to_f32(xc[static_cast<int64_t>(j) * d]), acc);
      }
    }
    __syncthreads();
  }

  s_acc[warp][lane] = acc;
  const float vw = warp_sum(vs);
  if (lane == 0) s_vs[warp] = vw;
  __syncthreads();
  if (warp == 0) {
    float raw = warp_sum(lane < kWarps ? s_vs[lane] : 0.f);
    raw = __shfl_sync(0xffffffffu, raw, 0);
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_acc[w][lane];
    if (live) agg[col] = (total + noise[col]) / fmaxf(raw, vs_min);
    if (blockIdx.x == 0 && lane == 0) *varsigma = raw;
  }
}

}  // namespace

// x: (k, d) row-major, f32 (bf16 == 0) or bf16 (bf16 == 1). powers, mask:
// (k,) f32. noise: (d,) f32. agg: (d,) f32. varsigma: one f32 (raw sum).
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int repro_superpose_normalize(const void* x, const void* powers,
                                         const void* mask, const void* noise,
                                         void* agg, void* varsigma, int64_t k,
                                         int64_t d, float vs_min, int bf16,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>((d + kCols - 1) / kCols));
  const float* p = static_cast<const float*>(powers);
  const float* m = static_cast<const float*>(mask);
  const float* n = static_cast<const float*>(noise);
  float* out = static_cast<float*>(agg);
  float* vs = static_cast<float*>(varsigma);
  if (bf16) {
    superpose_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), p, m, n, out, vs, k, d, vs_min);
  } else {
    superpose_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), p, m, n, out, vs, k, d, vs_min);
  }
  return static_cast<int>(cudaGetLastError());
}
