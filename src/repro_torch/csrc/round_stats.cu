// Per-row statistics of the (K, D) delta plane, two entry points on one
// kernel body:
//
// repro_round_stats replaces the TPU kernel
// repro/kernels/round_stats.py::round_stats_pallas (bodies _kernel and
// _kernel_payload), sweep 1 of the PAOTA round. Per row k:
//     stats[k, 0] = sum_d delta[k, d] * g[d]
//     stats[k, 1] = sum_d delta[k, d]^2
//     stats[k, 2] = sum_d payload[k, d]^2          (payload variant only)
// and gn2 = sum_d g[d]^2.
// repro_cosine_partials replaces repro/kernels/cosine_sim.py::
// cosine_partials_pallas (body _kernel): the (K, 2) [dot, ||delta||^2]
// alone, without a payload and without gn2.
// Inputs are f32 or bf16 (g is f32); every sum is f32.
//
// Bound on the H100: memory. The sweep reads K*D elements (2*K*D with a
// payload) once and does 2-3 FMAs per element, far below the card's
// operations-per-byte balance.
//
// Design: one block per row, threads striding over D with coalesced scalar
// loads. Rows are D elements apart, and D = 8070 (the paper's MLP) makes
// the row pitch 32,280 bytes, which is not 16-byte aligned, so the kernel
// does no vector loads and masks the ragged edge itself; nothing is
// padded or copied. The TPU grid carried its sums across sequential grid
// steps; here each block reduces its own row (warp shuffles, then one
// shared-memory pass over the warp partials, in a fixed order), so the
// result is identical from run to run and uses no atomics. Every block
// also sums g^2 in the same order, and block 0 writes it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

template <typename T, bool kPayload, bool kGn2>
__global__ void __launch_bounds__(kThreads)
round_stats_kernel(const T* __restrict__ deltas, const T* __restrict__ payload,
                   const float* __restrict__ g, float* __restrict__ stats,
                   float* __restrict__ gn2, int64_t d) {
  const int64_t row = blockIdx.x;
  const T* drow = deltas + row * d;
  const T* prow = kPayload ? payload + row * d : deltas;
  // acc: dot, delta sq-norm, payload sq-norm, g sq-norm
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int64_t j = threadIdx.x; j < d; j += kThreads) {
    const float x = to_f32(drow[j]);
    const float gj = g[j];
    acc[0] = fmaf(x, gj, acc[0]);
    acc[1] = fmaf(x, x, acc[1]);
    if (kPayload) {
      const float p = to_f32(prow[j]);
      acc[2] = fmaf(p, p, acc[2]);
    }
    if (kGn2) acc[3] = fmaf(gj, gj, acc[3]);
  }

  __shared__ float partial[4][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float s = warp_sum(acc[i]);
    if (lane == 0) partial[i][warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i] = warp_sum(lane < kWarps ? partial[i][lane] : 0.f);
    }
    if (lane == 0) {
      constexpr int kCols = kPayload ? 3 : 2;
      stats[row * kCols + 0] = acc[0];
      stats[row * kCols + 1] = acc[1];
      if (kPayload) stats[row * kCols + 2] = acc[2];
      if (kGn2 && row == 0) *gn2 = acc[3];
    }
  }
}

template <typename T>
void launch(const void* deltas, const void* payload, const void* g,
            void* stats, void* gn2, int64_t k, int64_t d,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(k));
  const T* dp = static_cast<const T*>(deltas);
  const T* pp = static_cast<const T*>(payload);
  const float* gp = static_cast<const float*>(g);
  float* sp = static_cast<float*>(stats);
  float* np = static_cast<float*>(gn2);
  if (payload != nullptr) {
    round_stats_kernel<T, true, true><<<grid, kThreads, 0, stream>>>(
        dp, pp, gp, sp, np, d);
  } else {
    round_stats_kernel<T, false, true><<<grid, kThreads, 0, stream>>>(
        dp, pp, gp, sp, np, d);
  }
}

}  // namespace

// deltas, payload: (k, d) row-major, f32 (bf16 == 0) or bf16 (bf16 == 1);
// payload may be null. g: (d,) f32. stats: (k, 2 or 3) f32. gn2: one f32.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int repro_round_stats(const void* deltas, const void* payload,
                                 const void* g, void* stats, void* gn2,
                                 int64_t k, int64_t d, int bf16,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch<__nv_bfloat16>(deltas, payload, g, stats, gn2, k, d, s);
  } else {
    launch<float>(deltas, payload, g, stats, gn2, k, d, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// deltas: (k, d) row-major, f32 (bf16 == 0) or bf16 (bf16 == 1). g: (d,)
// f32. out: (k, 2) f32 [dot_k, ||delta_k||^2]. Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int repro_cosine_partials(const void* deltas, const void* g,
                                     void* out, int64_t k, int64_t d,
                                     int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>(k));
  const float* gp = static_cast<const float*>(g);
  float* op = static_cast<float*>(out);
  if (bf16) {
    round_stats_kernel<__nv_bfloat16, false, false><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(deltas), nullptr, gp, op, nullptr,
        d);
  } else {
    round_stats_kernel<float, false, false><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(deltas), nullptr, gp, op, nullptr, d);
  }
  return static_cast<int>(cudaGetLastError());
}
