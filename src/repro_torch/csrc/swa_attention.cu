// Sliding-window flash attention, forward. Replaces the TPU kernel
// repro/kernels/swa_attention.py::swa_attention_pallas (body
// _attn_kernel). q (BH, T, D), k and v (BH, S, D), f32 or bf16 (one
// type); out (BH, T, D) in that type. Query t attends to key s where
// s <= t (causal) and s > t - W (a window W >= 0; W < 0 means none):
//     out_t = sum_s softmax_s(scale * q_t . k_s) v_s,  scale = 1/sqrt(D)
// over the allowed keys; a row with no allowed key gives 0. Logits,
// softmax and sums are f32 on the CUDA cores (the port runs no TF32).
//
// Bound on the H100: f32 operations, 4 D per (query, key) pair inside
// the band, against 4 BH T D elements moved (T = S); at T = 8192,
// W = 4096, 48 heads of D = 128 that is 619 GFLOP (9.2 ms at 67 TFLOP/s)
// against 805 MB (0.24 ms at 3.35 TB/s).
//
// Design. One block per (bh, 64-query tile), 16 x 16 threads; thread
// (ty, tx) owns rows ty + 16 r (r < 4) of the tile, scores of key columns
// tx + 16 u (u < 4) and accumulator columns tx + 16 c (c < DC, D <= 16 DC).
// The running max m, sum l and accumulator of the online softmax stay in
// f32 registers; the 16 threads of a row (16 neighbouring lanes of one
// warp) reduce the row max and sum with shuffles in a fixed order.
// The block visits only the 64-key tiles that meet the band of its rows:
// keys from q0 - W + 1 (windowed) to q1 - 1 (causal), so a query tile
// costs O(W + 64) and not O(S), the structure the Pallas index map
// encodes with its clamped stripes. Per key tile: Q K^T from shared
// memory (rows padded by one float, no bank conflicts), scale, mask
// (masked logits -1e30, their probabilities exactly 0, as the reference),
// rescale by exp(m_old - m_new), P parked in shared memory, acc += P V.
// Ragged T, S and D are masked and zero-filled in shared memory; nothing
// is padded in device memory. No atomics: repeated calls are
// bit-identical. Shared memory is 4 * 64 * (3 D + 67) bytes, 115 KB at
// D = 128, so one block per SM; raising occupancy is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;      // queries per block, keys per step
constexpr int kLdP = kTile + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
swa_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int64_t t,
                     int64_t s, int d, int64_t window, int causal,
                     float scale, int64_t q_tiles) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;                      // [kTile][d + 1]
  float* ks = qs + kTile * ld;           // [kTile][d + 1]
  float* vs = ks + kTile * ld;           // [kTile][d]
  float* ps = vs + kTile * d;            // [kTile][kLdP]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t bh = blockIdx.x / q_tiles;
  const int64_t q0 = (blockIdx.x % q_tiles) * kTile;
  const int64_t q1 = q0 + kTile < t ? q0 + kTile : t;   // exclusive
  const T* qg = q + bh * t * d;
  const T* kg = k + bh * s * d;
  const T* vg = v + bh * s * d;

  for (int r = ty; r < kTile; r += 16) {
    for (int col = tx; col < d; col += 16) {
      qs[r * ld + col] = q0 + r < t ? to_f32(qg[(q0 + r) * d + col]) : 0.f;
    }
  }

  // the keys that meet the band of rows [q0, q1): [lo, hi)
  int64_t lo = 0, hi = s;
  if (window >= 0 && q0 - window + 1 > 0) lo = q0 - window + 1;
  if (causal && q1 < hi) hi = q1;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  for (int64_t j0 = lo / kTile * kTile; j0 < hi; j0 += kTile) {
    __syncthreads();            // qs is loaded; the last ks, vs, ps consumed
    for (int r = ty; r < kTile; r += 16) {
      const bool ok = j0 + r < s;
      for (int col = tx; col < d; col += 16) {
        ks[r * ld + col] = ok ? to_f32(kg[(j0 + r) * d + col]) : 0.f;
        vs[r * d + col] = ok ? to_f32(vg[(j0 + r) * d + col]) : 0.f;
      }
    }
    __syncthreads();

    float sc[4][4] = {};
    for (int kk = 0; kk < d; ++kk) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = qs[(ty + 16 * r) * ld + kk];
#pragma unroll
      for (int u = 0; u < 4; ++u) kv[u] = ks[(tx + 16 * u) * ld + kk];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int u = 0; u < 4; ++u) sc[r][u] = fmaf(qv[r], kv[u], sc[r][u]);
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t qi = q0 + ty + 16 * r;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int64_t kj = j0 + tx + 16 * u;
        ok[u] = kj < s && qi < t && (!causal || kj <= qi) &&
                (window < 0 || kj > qi - window);
        sc[r][u] = ok[u] ? sc[r][u] * scale : kNegInf;
        mx = fmaxf(mx, sc[r][u]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float pv = ok[u] ? expf(sc[r][u] - m_new) : 0.f;
        ps[(ty + 16 * r) * kLdP + tx + 16 * u] = pv;
        sum += pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

    for (int jj = 0; jj < kTile; ++jj) {
      float pv[4], vv[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = ps[(ty + 16 * r) * kLdP + jj];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < d ? vs[jj * d + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
      }
    }
  }

  T* og = out + bh * t * d;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t qi = q0 + ty + 16 * r;
    if (qi >= t) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) store(&og[qi * d + col], acc[r][c] / denom);
    }
  }
}

template <typename T, int DC>
int launch(const void* q, const void* k, const void* v, void* out,
           int64_t bh, int64_t t, int64_t s, int d, int64_t window,
           int causal, float scale, cudaStream_t st) {
  const int64_t q_tiles = (t + kTile - 1) / kTile;
  const size_t smem =
      sizeof(float) * (2 * kTile * (d + 1) + kTile * d + kTile * kLdP);
  cudaError_t err = cudaFuncSetAttribute(
      swa_attention_kernel<T, DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  swa_attention_kernel<T, DC>
      <<<static_cast<unsigned int>(bh * q_tiles), kThreads, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), t, s, d, window,
          causal, scale, q_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             int64_t bh, int64_t t, int64_t s, int d, int64_t window,
             int causal, float scale, cudaStream_t st) {
  if (d <= 64) {
    return launch<T, 4>(q, k, v, out, bh, t, s, d, window, causal, scale,
                        st);
  }
  if (d <= 128) {
    return launch<T, 8>(q, k, v, out, bh, t, s, d, window, causal, scale,
                        st);
  }
  return launch<T, 16>(q, k, v, out, bh, t, s, d, window, causal, scale, st);
}

}  // namespace

// q: (bh, t, d); k, v: (bh, s, d); out: (bh, t, d); row-major, dtype
// 0 = f32, 1 = bf16. window < 0 means no window. Launches on `stream`,
// allocates nothing, returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int repro_swa_attention(const void* q, const void* k,
                                   const void* v, void* out, int64_t bh,
                                   int64_t t, int64_t s, int64_t d,
                                   int64_t window, int causal, float scale,
                                   int dtype, void* stream) {
  if (bh < 1 || t < 1 || s < 1 || d < 1 || d > 256 ||
      bh * ((t + kTile - 1) / kTile) > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int di = static_cast<int>(d);
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(q, k, v, out, bh, t, s, di, window,
                                   causal, scale, st);
  }
  return dispatch<float>(q, k, v, out, bh, t, s, di, window, causal, scale,
                         st);
}
