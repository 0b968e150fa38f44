// AirComp superposition over the (K, D) payload plane (eqs. 6 + 8), two
// entry points on one kernel body:
//
// repro_superpose_normalize replaces the TPU kernel
// repro/kernels/aircomp_sum.py::superpose_normalize_pallas (body
// _superpose_kernel), sweep 2 of the fused round. With bp_k = p_k * mask_k:
//     agg[d]   = (sum_k bp_k * x[k, d] + noise[d]) / max(sum_k bp_k, vs_min)
//     varsigma = sum_k bp_k                                   (raw)
// repro_aircomp_sum replaces repro/kernels/aircomp_sum.py::
// aircomp_sum_pallas (body _kernel), the host-path server's use_kernel
// route: bp comes already masked, vs_min is 1e-12 and only agg is written.
// x is f32 or bf16; bp, p, mask and noise are f32; every sum is f32.
//
// Bound on the H100: memory bytes. K*D payload elements are read once for
// one FMA each; the output is one D-vector. At K x D = 100 x 8070 f32 the
// plane is 3.2 MB, 1 us at 3.35 TB/s: the call is a fight with latency,
// so the whole plane has to be in flight at once, and every dependent
// step after the loads (another round of row loads, a merge through
// device memory, a memset on the stream) costs as much as the bytes.
//
// Design: a grid of column tiles, the rows split across the warps of a
// block.
// - A warp covers a tile of 32 * V columns, each lane V neighbouring
//   columns loaded at once (16, 8, 4 or 2 bytes: V is the widest width that
//   divides the row pitch and x's alignment, a template parameter; D = 8070
//   f32 rows load as float2, 64 columns a warp). The W warps of a block (16,
//   or 32 for large K) split the rows (warp w takes rows w, w + W, ... in
//   order) and each issues 8 row loads (4 of 16 bytes) before their FMAs,
//   so at K <= 128 a warp's rows are one round trip. bp_k is read directly
//   (K floats that stay in L2); nothing is staged behind barriers.
// - A block adds its warps' partials in warp order, adds the noise and
//   divides. No scratch, no counter, no float atomics: repeated calls are
//   bit-identical, and the launch is one kernel node a CUDA graph can
//   capture. (Splitting a tile's rows across blocks, merged through a
//   scratch and a counter or inside a thread block cluster, gained nothing
//   at D = 8070 on the H100.)
// - Every block sums bp for varsigma, in the same fixed order, while its
//   row loads are in flight; all divide by the same value, and tile 0
//   writes the raw varsigma. The ragged last tile is masked; nothing is
//   padded or copied.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep.cuh"

namespace {

using sweep::Vec;
using sweep::warp_sum;

// row loads a warp has in flight: 8, or 4 of 16 bytes (registers)
template <int V>
constexpr int kUnroll = V >= 4 ? 4 : 8;

__device__ __forceinline__ float weight(const float* __restrict__ powers,
                                        const float* __restrict__ mask,
                                        int64_t i) {
  return mask != nullptr ? __fmul_rn(powers[i], mask[i]) : powers[i];
}

// W warps a block. With a mask, bp_k = powers[k] * mask[k] and tile 0
// writes the raw varsigma; without, powers holds bp itself and varsigma is
// unused.
template <typename T, int V, int W>
__global__ void __launch_bounds__(W * 32)
superpose_kernel(const T* __restrict__ x, const float* __restrict__ powers,
                 const float* __restrict__ mask,
                 const float* __restrict__ noise, float* __restrict__ agg,
                 float* __restrict__ varsigma, int64_t k, int64_t d,
                 float vs_min) {
  constexpr int kTile = 32 * V;
  constexpr int kThreads = W * 32;
  __shared__ float s_acc[W][kTile];
  __shared__ float s_red[W];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t j = col0 + lane * V;      // this lane's first column
  const bool live = j < d;

  // varsigma's loads go out with the first row loads: this thread's
  // strided share of sum_k bp_k
  float vs = 0.f;
  for (int64_t i = tid; i < k; i += kThreads) vs += weight(powers, mask, i);
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  constexpr int U = kUnroll<V>;
  for (int64_t r = warp; r < k; r += W * U) {
    Vec<T, V> xv[U];
    float w[U];
    // Past the last row or column the words are zeros and their FMAs add
    // nothing. The FMAs are not guarded: under the loads' own guard the
    // compiler may fuse each load with its FMAs and wait on every load in
    // turn.
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t rr = r + u * W;
      w[u] = 0.f;
      xv[u].clear();
      if (rr < k) {
        w[u] = weight(powers, mask, rr);
        if (live) xv[u].load(x + rr * d + j);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float xf[V];
      xv[u].unpack(xf);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = fmaf(w[u], xf[i], acc[i]);
    }
  }

  // the block's partial of each tile column (its warps in order), and
  // varsigma (lanes by a fixed shuffle tree, then the warps in order)
  vs = warp_sum(vs);
  if (lane == 0) s_red[warp] = vs;
#pragma unroll
  for (int i = 0; i < V; ++i) s_acc[warp][lane * V + i] = acc[i];
  __syncthreads();
  const int64_t col = col0 + tid;
  const bool mine = tid < kTile && col < d;
  float total = 0.f;
  if (mine) {
#pragma unroll
    for (int w = 0; w < W; ++w) total += s_acc[w][tid];
  }

  float raw = 0.f;
#pragma unroll
  for (int w = 0; w < W; ++w) raw += s_red[w];
  if (mine) agg[col] = (total + noise[col]) / fmaxf(raw, vs_min);
  if (varsigma != nullptr && blockIdx.x == 0 && tid == 0) *varsigma = raw;
}

template <typename T, int V, int W>
int launch_w(const T* x, const float* powers, const float* mask,
             const float* noise, float* agg, float* varsigma, int64_t k,
             int64_t d, float vs_min, cudaStream_t s) {
  const unsigned int tiles =
      static_cast<unsigned int>((d + 32 * V - 1) / (32 * V));
  superpose_kernel<T, V, W><<<tiles, W * 32, 0, s>>>(
      x, powers, mask, noise, agg, varsigma, k, d, vs_min);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_v(const void* x, const float* powers, const float* mask,
             const float* noise, float* agg, float* varsigma, int64_t k,
             int64_t d, int warps, float vs_min, cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(x) % (sizeof(T) * V) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const T* xp = static_cast<const T*>(x);
  if (warps == 16) {
    return launch_w<T, V, 16>(xp, powers, mask, noise, agg, varsigma, k, d,
                              vs_min, s);
  }
  if (warps == 32) {
    return launch_w<T, V, 32>(xp, powers, mask, noise, agg, varsigma, k, d,
                              vs_min, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plan the wrapper hands over (aircomp_sum.plan), checked: whole
// vectors per row and a tile count the grid takes.
template <typename T>
int launch(const void* x, const void* powers, const void* mask,
           const void* noise, void* agg, void* varsigma, int64_t k, int64_t d,
           int vec, int warps, float vs_min, cudaStream_t s) {
  if (k < 1 || d < 1 || vec < 1 || d % vec != 0 ||
      static_cast<int64_t>(sizeof(T)) * vec > 16 ||
      (d + 32 * vec - 1) / (32 * vec) > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* p = static_cast<const float*>(powers);
  const float* m = static_cast<const float*>(mask);
  const float* n = static_cast<const float*>(noise);
  float* out = static_cast<float*>(agg);
  float* vs = static_cast<float*>(varsigma);
  switch (vec) {
    case 1:
      return launch_v<T, 1>(x, p, m, n, out, vs, k, d, warps, vs_min, s);
    case 2:
      return launch_v<T, 2>(x, p, m, n, out, vs, k, d, warps, vs_min, s);
    case 4:
      return launch_v<T, 4>(x, p, m, n, out, vs, k, d, warps, vs_min, s);
    case 8:
      if constexpr (sizeof(T) == 2) {
        return launch_v<T, 8>(x, p, m, n, out, vs, k, d, warps, vs_min, s);
      }
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: (k, d) row-major, f32 (bf16 == 0) or bf16 (bf16 == 1). powers, mask:
// (k,) f32. noise: (d,) f32. agg: (d,) f32. varsigma: one f32 (raw sum).
// The plan (the wrapper's aircomp_sum.plan): `vec` elements per load (1,
// 2, 4, or 8 for bf16), dividing d, with vec * sizeof(T) bytes dividing
// x's alignment (cudaErrorMisalignedAddress otherwise); `warps` (16 or
// 32) per block. Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue for a plan it cannot run).
extern "C" int repro_superpose_normalize(const void* x, const void* powers,
                                         const void* mask, const void* noise,
                                         void* agg, void* varsigma, int64_t k,
                                         int64_t d, float vs_min, int bf16,
                                         void* stream, int vec, int warps) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask == nullptr || varsigma == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bf16) {
    return launch<__nv_bfloat16>(x, powers, mask, noise, agg, varsigma, k, d,
                                 vec, warps, vs_min, s);
  }
  return launch<float>(x, powers, mask, noise, agg, varsigma, k, d, vec,
                       warps, vs_min, s);
}

// x: (k, d) row-major, f32 (bf16 == 0) or bf16 (bf16 == 1). bp: (k,) f32,
// already masked. noise: (d,) f32. agg: (d,) f32 =
// (sum_k bp_k x_k + noise) / max(sum_k bp_k, 1e-12). The plan as for
// repro_superpose_normalize. Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int repro_aircomp_sum(const void* x, const void* bp,
                                 const void* noise, void* agg, int64_t k,
                                 int64_t d, int bf16, void* stream, int vec,
                                 int warps) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(x, bp, nullptr, noise, agg, nullptr, k, d,
                                 vec, warps, 1e-12f, s);
  }
  return launch<float>(x, bp, nullptr, noise, agg, nullptr, k, d, vec, warps,
                       1e-12f, s);
}
