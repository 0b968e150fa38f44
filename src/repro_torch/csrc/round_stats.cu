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
// Bound on the H100: memory bytes. The sweep reads K*D elements (2*K*D
// with a payload) once and does 2-3 FMAs per element, far below the
// card's operations-per-byte balance. At the paper's K x D = 100 x 8070
// the plane is 3.2 MB, 1 us at 3.35 TB/s: the call is a fight with
// latency, so the whole plane has to be in flight at once, and every
// dependent step after the loads (a second round trip, a merge through
// device memory, a memset on the stream) costs as much as the bytes.
//
// Design: loads as wide as the pitch, all of a pass in flight at once, and
// no merge through device memory.
// - A block of `threads` reduces one row. A pass covers threads * 16
//   columns: each thread issues its 16 / V loads of V elements (16, 8, 4
//   or 2 bytes: V is the widest width that divides the row pitch and the
//   pointers' alignment, a template parameter) for the plane, the payload
//   and g, all before its FMAs. D = 8070 f32 rows are 8-byte aligned, so
//   they load as float2, and 512 threads take a whole row in one pass;
//   longer rows take more passes of the same block.
// - The block reduces in a fixed order (warp shuffles, then the warps in
//   order) and writes the row's stats. No scratch, no counter, no float
//   atomics: repeated calls are bit-identical, and the launch is one kernel
//   node a CUDA graph can capture. (Splitting rows across blocks, merged
//   through a scratch and a counter or inside a thread block cluster,
//   gained nothing at D = 8070 at any K from 8 up on the H100.)
// - g^2 is summed once, by row 0's block, which writes gn2.
// Nothing is padded or copied; the ragged last pass is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep.cuh"

namespace {

using sweep::Vec;
using sweep::warp_sum;

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kPerThread = 16;  // columns a thread takes per pass

// kCols: 2 (no payload) or 3 (payload) stats per row; kGn2: row 0 sums g^2.
template <typename T, int V, int kCols, bool kGn2>
__global__ void __launch_bounds__(kMaxThreads)
stats_kernel(const T* __restrict__ deltas, const T* __restrict__ payload,
             const float* __restrict__ g, float* __restrict__ stats,
             float* __restrict__ gn2, int64_t d) {
  constexpr int kLoads = kPerThread / V;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int64_t row = blockIdx.x;
  const T* drow = deltas + row * d;
  const T* prow = kCols == 3 ? payload + row * d : deltas;
  const bool with_g2 = kGn2 && row == 0;

  // dot, delta sq-norm, payload sq-norm, g sq-norm
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int64_t base = static_cast<int64_t>(tid) * V; base < d;
       base += static_cast<int64_t>(nthreads) * kPerThread) {
    Vec<T, V> xv[kLoads], pv[kLoads];
    Vec<float, V> gv[kLoads];
    // Past the row's end the words are zeros and their FMAs add nothing.
    // The FMAs are not guarded: under the loads' own guard the compiler
    // may fuse each load with its FMAs and wait on every load in turn.
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int64_t j = base + static_cast<int64_t>(u) * nthreads * V;
      if (j < d) {
        xv[u].load(drow + j);
        gv[u].load(g + j);
        if (kCols == 3) pv[u].load(prow + j);
      } else {
        xv[u].clear();
        gv[u].clear();
        if (kCols == 3) pv[u].clear();
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      float x[V], gg[V], p[V];
      xv[u].unpack(x);
      gv[u].unpack(gg);
      if (kCols == 3) pv[u].unpack(p);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        acc[0] = fmaf(x[i], gg[i], acc[0]);
        acc[1] = fmaf(x[i], x[i], acc[1]);
        if (kCols == 3) acc[2] = fmaf(p[i], p[i], acc[2]);
        if (with_g2) acc[3] = fmaf(gg[i], gg[i], acc[3]);
      }
    }
  }

  // the block's sums, in a fixed order: lanes, then warps; lane 0 of warp
  // 0 ends with them
  __shared__ float red[4][kMaxWarps];
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float s = warp_sum(acc[i]);
    if (lane == 0) red[i][warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i] = warp_sum(lane < nwarps ? red[i][lane] : 0.f);
    }
  }

  if (tid == 0) {
    stats[row * kCols + 0] = acc[0];
    stats[row * kCols + 1] = acc[1];
    if (kCols == 3) stats[row * kCols + 2] = acc[2];
    if (with_g2) *gn2 = acc[3];
  }
}

bool aligned(const void* p, size_t bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int V, int kCols, bool kGn2>
int launch_v(const T* deltas, const T* payload, const float* g,
             float* stats, float* gn2, int64_t k, int64_t d, int threads,
             cudaStream_t s) {
  // a vector load needs its width's alignment (g: V floats, up to 16 B)
  if (!aligned(deltas, sizeof(T) * V) || !aligned(payload, sizeof(T) * V) ||
      !aligned(g, 4 * V < 16 ? 4 * V : 16)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  stats_kernel<T, V, kCols, kGn2>
      <<<static_cast<unsigned int>(k), threads, 0, s>>>(deltas, payload, g,
                                                        stats, gn2, d);
  return static_cast<int>(cudaGetLastError());
}

// The plan the wrapper hands over, checked: whole vectors per row, a
// block size the kernel takes, and a grid the card takes.
bool valid_plan(int64_t k, int64_t d, int vec, int threads) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) return false;
  if (vec < 1 || kPerThread % vec != 0 || d < 1 || d % vec != 0) return false;
  return k >= 1 && k <= 2147483647LL;
}

template <typename T, int kCols, bool kGn2>
int launch(const void* deltas, const void* payload, const void* g,
           void* stats, void* gn2, int64_t k, int64_t d, int vec,
           int threads, cudaStream_t s) {
  if (!valid_plan(k, d, vec, threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* dp = static_cast<const T*>(deltas);
  const T* pp = static_cast<const T*>(payload);
  const float* gp = static_cast<const float*>(g);
  float* sp = static_cast<float*>(stats);
  float* np = static_cast<float*>(gn2);
  switch (vec) {
    case 1:
      return launch_v<T, 1, kCols, kGn2>(dp, pp, gp, sp, np, k, d, threads,
                                         s);
    case 2:
      return launch_v<T, 2, kCols, kGn2>(dp, pp, gp, sp, np, k, d, threads,
                                         s);
    case 4:
      return launch_v<T, 4, kCols, kGn2>(dp, pp, gp, sp, np, k, d, threads,
                                         s);
    case 8:
      if constexpr (sizeof(T) == 2) {
        return launch_v<T, 8, kCols, kGn2>(dp, pp, gp, sp, np, k, d,
                                           threads, s);
      }
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// deltas, payload: (k, d) row-major, f32 (bf16 == 0) or bf16 (bf16 == 1);
// payload may be null. g: (d,) f32. stats: (k, 2 or 3) f32. gn2: one f32.
// The plan (the wrapper's round_stats.plan): one block of `threads` per
// row, a multiple of 32 up to 512; `vec` elements per load (1, 2, 4, or 8
// for bf16), dividing d, with vec * sizeof(T) bytes (and min(16, 4 * vec)
// for g) dividing the pointers' alignment (cudaErrorMisalignedAddress
// otherwise). Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue for a plan it cannot run).
extern "C" int repro_round_stats(const void* deltas, const void* payload,
                                 const void* g, void* stats, void* gn2,
                                 int64_t k, int64_t d, int bf16, void* stream,
                                 int vec, int threads) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return payload != nullptr
               ? launch<__nv_bfloat16, 3, true>(deltas, payload, g, stats,
                                                gn2, k, d, vec, threads, s)
               : launch<__nv_bfloat16, 2, true>(deltas, payload, g, stats,
                                                gn2, k, d, vec, threads, s);
  }
  return payload != nullptr
             ? launch<float, 3, true>(deltas, payload, g, stats, gn2, k, d,
                                      vec, threads, s)
             : launch<float, 2, true>(deltas, payload, g, stats, gn2, k, d,
                                      vec, threads, s);
}

// deltas: (k, d) row-major, f32 (bf16 == 0) or bf16 (bf16 == 1). g: (d,)
// f32. out: (k, 2) f32 [dot_k, ||delta_k||^2]. The plan as for
// repro_round_stats. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int repro_cosine_partials(const void* deltas, const void* g,
                                     void* out, int64_t k, int64_t d,
                                     int bf16, void* stream, int vec,
                                     int threads) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16, 2, false>(deltas, nullptr, g, out, nullptr,
                                           k, d, vec, threads, s);
  }
  return launch<float, 2, false>(deltas, nullptr, g, out, nullptr, k, d, vec,
                                 threads, s);
}
