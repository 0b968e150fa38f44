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
// one d-vector is written: m*s*(sizeof(v) + 4) + 8m + 8d bytes (0.32 MB
// at the cohort path's (64, 504, 8070), 2.1 MB at the state plane's
// (256, 1024, 16384)): far too little to fill the card, so latency and
// the bytes each block must scan bound it.
//
// Design: a parallel scatter that stays deterministic without float
// atomics.
// - The grid is (stripes of W columns) x (row splits). Every block scans
//   all the indices of its rows, so the bytes a block reads fall as
//   stripes widen and as the rows split: the wrapper takes W = 1024 (or d
//   rounded up to 64 when smaller) and as many splits as fill one wave of
//   the card's SMs while each split keeps a row per warp. At the cohort
//   path's (64, 504, 8070) that is 8 stripes x 4 splits, each block
//   reading 16 rows (32 KB of indices); at the state plane's
//   (256, 1024, 16384) 16 x 8, 32 rows (128 KB) each.
// - Warp w of 16 takes its split's rows w, w + 16, ... in order. It
//   stages each row's indices (segments of up to 512) into its own ring of
//   4 buffers in shared memory with cp.async (16-byte copies where the
//   rows allow), so three segments are in flight while it scans the
//   fourth, and no load waits behind a block-wide barrier. Values are
//   read only for the indices that fall in the stripe, all of a segment's
//   at once, and added only after the next segment's scan, so the loads'
//   latency hides behind that scan.
// - The warp adds w_k * v into its own stripe accumulator. A row's
//   indices are distinct, so the lanes never collide within a row, and a
//   __syncwarp() between segments orders the rows: each warp's column sums
//   its rows in increasing k. The block's partial is acc_0 + ... + acc_15
//   in that fixed order. With one split the block writes
//   agg = (noise + partial) / varsigma. With several, each writes its
//   partial to scratch, and the last block of the stripe to arrive (an
//   integer counter picks it) writes (noise + partial_0 + partial_1 + ...)
//   / varsigma in split order. No float atomics: repeated calls are
//   bit-identical. Rows with w_k = 0 are not skipped: 0 * v is added as
//   the reference adds it. Every block sums bp in the same fixed order,
//   so all divide by the same varsigma, and block (0, 0) writes it. The
//   ragged last stripe is masked; nothing is padded or copied.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStripe = 64;    // stripe width unit (columns)
constexpr int kMaxStripe = 1024;
constexpr int kSeg = 512;      // indices per staged segment
constexpr int kStages = 4;     // segments in a warp's ring
constexpr int kBatch = kSeg / 32;   // entries a lane scans per segment

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, bool V16>
__global__ void __launch_bounds__(kThreads)
gather_superpose_kernel(const T* __restrict__ values,
                        const int32_t* __restrict__ idx,
                        const float* __restrict__ bp,
                        const float* __restrict__ scale,
                        const float* __restrict__ noise,
                        float* __restrict__ agg, float* __restrict__ raw_out,
                        float* __restrict__ partial,
                        int* __restrict__ arrived, int64_t m, int64_t s,
                        int64_t d, int stripe, int splits, int seg,
                        float vs_min) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);               // [16][stripe]
  int32_t* ring = reinterpret_cast<int32_t*>(acc + kWarps * stripe);
  __shared__ float red[kThreads];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * stripe;
  const int width = static_cast<int>(d - lo < stripe ? d - lo : stripe);

  for (int i = tid; i < kWarps * stripe; i += kThreads) acc[i] = 0.f;

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

  // this block's rows [r0, r1); this warp's items: (row r0 + warp + 16 r,
  // segment j), in order
  const int64_t per_split = (m + splits - 1) / splits;
  const int64_t r0 = blockIdx.y * per_split;
  const int64_t r1 = r0 + per_split < m ? r0 + per_split : m;
  const int64_t nseg = (s + seg - 1) / seg;
  const int64_t rows =
      r1 - r0 > warp ? (r1 - r0 - warp + kWarps - 1) / kWarps : 0;
  const int64_t items = rows * nseg;
  int32_t* wring = ring + static_cast<int64_t>(warp) * kStages * seg;
  float* wacc = acc + warp * stripe;
  auto stage = [&](int64_t it) {
    if (it < items) {
      const int64_t k = r0 + warp + kWarps * (it / nseg);
      const int64_t j0 = (it % nseg) * seg;
      const int len = static_cast<int>(s - j0 < seg ? s - j0 : seg);
      const int32_t* src = idx + k * s + j0;
      int32_t* dst = wring + (it % kStages) * seg;
      if constexpr (V16) {
        for (int e = lane * 4; e < len; e += 128) cp_async16(dst + e, src + e);
      } else {
        for (int e = lane; e < len; e += 32) cp_async4(dst + e, src + e);
      }
    }
    cp_commit();
  };
  // Scanning an item reads its indices and issues the loads of the values
  // that fall in the stripe; its adds come one item later, after the next
  // item's scan, so each warp keeps one item's value loads in flight.
  // The values stay raw in registers until the add, so nothing waits on
  // a load during the scan.
  auto scan = [&](int64_t it, int (&c)[kBatch], T (&v)[kBatch]) {
    const int64_t k = r0 + warp + kWarps * (it / nseg);
    const int64_t j0 = (it % nseg) * seg;
    const int len = static_cast<int>(s - j0 < seg ? s - j0 : seg);
    const int32_t* buf = wring + (it % kStages) * seg;
    const T* vrow = values + k * s + j0;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = lane + 32 * u;
      c[u] = e < len ? static_cast<int>(buf[e] - lo) : -1;
      if (c[u] >= 0 && c[u] < width) v[u] = vrow[e];
    }
  };
  auto add = [&](int64_t it, const int (&c)[kBatch], const T (&v)[kBatch]) {
    const int64_t k = r0 + warp + kWarps * (it / nseg);
    const float w = scale == nullptr ? bp[k] : __fmul_rn(bp[k], scale[k]);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (c[u] >= 0 && c[u] < width) {
        wacc[c[u]] = fmaf(w, to_f32(v[u]), wacc[c[u]]);
      }
    }
  };
  int ca[kBatch], cb[kBatch];
  T va[kBatch], vb[kBatch];
  for (int i = 0; i < kStages - 1; ++i) stage(i);
  if (items > 0) {
    cp_wait<kStages - 2>();
    __syncwarp();
    scan(0, ca, va);
    __syncwarp();
  }
  stage(kStages - 1);
  for (int64_t it = 0; it < items; ++it) {
    if (it + 1 < items) {
      cp_wait<kStages - 2>();    // item it + 1's group has landed
      __syncwarp();
      scan(it + 1, cb, vb);
      __syncwarp();              // its buffer may be refilled
    }
    stage(it + kStages);
    add(it, ca, va);             // rows stay in order: item it, then it + 1
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      ca[u] = cb[u];
      va[u] = vb[u];
    }
  }
  cp_wait<0>();
  __syncthreads();

  const float denom = fmaxf(raw, vs_min);
  if (splits == 1) {
    for (int c = tid; c < width; c += kThreads) {
      float v = noise[lo + c];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += acc[w * stripe + c];
      agg[lo + c] = v / denom;
    }
  } else {
    // Row splits: each block writes its partial stripe; the last of the
    // stripe's blocks to arrive (the counter decides who, not what is
    // summed) adds noise and the partials in split order 0, 1, ...
    __shared__ int last;
    float* mine = partial + static_cast<int64_t>(blockIdx.y) * d + lo;
    for (int c = tid; c < width; c += kThreads) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += acc[w * stripe + c];
      mine[c] = v;
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(&arrived[blockIdx.x], 1) == splits - 1;
    __syncthreads();
    if (last) {
      __threadfence();
      for (int c = tid; c < width; c += kThreads) {
        float v = noise[lo + c];
        for (int r = 0; r < splits; ++r) {
          v += __ldcg(partial + static_cast<int64_t>(r) * d + lo + c);
        }
        agg[lo + c] = v / denom;
      }
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) *raw_out = raw;
}

template <typename T>
int launch(const void* values, const int32_t* ix, const float* w,
           const float* sc, const float* n, float* out, float* vs,
           float* partial, int* arrived, int64_t m, int64_t s, int64_t d,
           int stripe, int splits, float vs_min, cudaStream_t st) {
  const int seg = static_cast<int>(s < kSeg ? (s + 3) / 4 * 4 : kSeg);
  const size_t bytes = sizeof(float) * kWarps * stripe +
                       sizeof(int32_t) * kWarps * kStages * seg;
  const bool v16 = s % 4 == 0 && reinterpret_cast<uintptr_t>(ix) % 16 == 0;
  auto kern = v16 ? gather_superpose_kernel<T, true>
                  : gather_superpose_kernel<T, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t stripes = (d + stripe - 1) / stripe;
  if (splits > 1) {
    e = cudaMemsetAsync(arrived, 0, sizeof(int) * stripes, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned int>(stripes),
                  static_cast<unsigned int>(splits));
  kern<<<grid, kThreads, bytes, st>>>(static_cast<const T*>(values), ix, w,
                                      sc, n, out, vs, partial, arrived, m, s,
                                      d, stripe, splits, seg, vs_min);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// values: (m, s) row-major, dtype 0 = f32, 1 = bf16, 2 = int8. idx: (m, s)
// i32. bp: (m,) f32. scale: (m,) f32 or null. noise: (d,) f32. agg: (d,)
// f32. raw: one f32. stripe: columns per block, a multiple of 64 up to
// 1024; splits: row splits (a second grid axis). With splits > 1, partial
// is (splits, d) f32 scratch and arrived one int per stripe, which this
// function zeroes on `stream` before the launch; else both may be null. Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue for a plan it cannot run).
extern "C" int repro_gather_superpose(const void* values, const void* idx,
                                      const void* bp, const void* scale,
                                      const void* noise, void* agg, void* raw,
                                      void* partial, void* arrived, int64_t m,
                                      int64_t s, int64_t d, int64_t stripe,
                                      int64_t splits, float vs_min, int dtype,
                                      void* stream) {
  if (stripe < kStripe || stripe > kMaxStripe || stripe % kStripe != 0 ||
      splits < 1 || splits > 65535 ||
      (d + stripe - 1) / stripe > 2147483647LL ||
      (splits > 1 && (partial == nullptr || arrived == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* w = static_cast<const float*>(bp);
  const float* sc = static_cast<const float*>(scale);
  const float* n = static_cast<const float*>(noise);
  float* out = static_cast<float*>(agg);
  float* vs = static_cast<float*>(raw);
  float* pa = static_cast<float*>(partial);
  int* ar = static_cast<int*>(arrived);
  const int sw = static_cast<int>(stripe), sp = static_cast<int>(splits);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(values, ix, w, sc, n, out, vs, pa, ar, m, s,
                                 d, sw, sp, vs_min, st);
  }
  if (dtype == 2) {
    return launch<int8_t>(values, ix, w, sc, n, out, vs, pa, ar, m, s, d, sw,
                          sp, vs_min, st);
  }
  return launch<float>(values, ix, w, sc, n, out, vs, pa, ar, m, s, d, sw, sp,
                       vs_min, st);
}
