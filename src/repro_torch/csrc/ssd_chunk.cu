// Mamba2 SSD intra-chunk part. Replaces the TPU kernel
// repro/kernels/ssd_chunk.py::ssd_intra_chunk_pallas (body _kernel). For
// each cell g of G = batch * chunks * heads, with cum (G, Q) f32:
//     decay[i, j] = exp(clip(cum_i - cum_j, -60, 0))   where i >= j, else 0
//     y           = ((C B^T) * decay) @ xdt                 (Q, P)
//     tail[j]     = exp(clip(cum_{Q-1} - cum_j, -60, 0))
//     state       = (B * tail)^T @ xdt                      (N, P) f32
//     chunk_decay = exp(clip(cum_{Q-1}, -60, 0))            f32
// B, C (G, Q, N) and xdt (G, Q, P) are f32 or bf16 (one type); y is
// xdt's type. Every product and sum is f32 on the CUDA cores: the port
// runs its contractions in full f32 (no TF32).
//
// Bound on the H100: f32 operations. At the full-width layer shape
// (1024, 256, 128, 64) the causal half of C B^T and of scores @ xdt plus
// the state product are 17.3 GFLOP, 0.26 ms at 67 TFLOP/s, against 437 MB
// moved, 0.13 ms at 3.35 TB/s.
//
// Design. A Pallas grid cell held B, C, xdt and the (Q, Q) scores in
// VMEM; at Q = 256, N = 128 that is 512 KB of f32, more than a block's
// 227 KB of shared memory, so the cell is tiled. One launch, grid
// (G, tiles): per cell, q_tiles * p_tiles blocks each own a 64 x 64 tile
// of y, and n_tiles * p_tiles blocks a 64 x 64 tile of the state.
// - A y block walks the 64-key tiles up to its diagonal (later tiles are
//   all masked). For each, it forms its 64 x 64 rows of C B^T in
//   registers (16 x 16 threads, 4 x 4 each, N staged 32 columns at a
//   time), multiplies each by its decay after the product and zeroes the
//   masked entries, as the reference orders it, parks the tile in shared
//   memory and adds tile @ xdt to its f32 accumulator while the xdt tile
//   is resident. The (Q, Q) scores never exist in full.
// - A state block walks the key tiles, stages B * tail (the product
//   rounded before the contraction, as the reference's b * tail) and xdt,
//   and accumulates its 64 x 64 tile; the first one writes chunk_decay.
// Every sum runs in one fixed order and there are no atomics, so
// repeated calls are bit-identical. Ragged Q, N and P are masked and
// zero-filled in shared memory; nothing is padded in device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // 16 x 16, a 4 x 4 micro-tile each
constexpr int kTile = 64;            // rows / columns of a block's tile
constexpr int kDepth = 32;           // N columns staged per C B^T step
constexpr int kLdCB = kDepth + 1;    // padded rows: no bank conflicts
constexpr int kLdS = kTile + 1;
// y part: C and B stages (aliased later by the score tile), xdt, cums
constexpr int kSmemY = 2 * kTile * kLdCB + kTile * kTile + 2 * kTile;
// state part: B * tail, xdt, tail
constexpr int kSmemS = 2 * kTile * kTile + kTile;
constexpr int kSmem = kSmemY > kSmemS ? kSmemY : kSmemS;
static_assert(kTile * kLdS <= 2 * kTile * kLdCB, "score tile must fit");

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

template <typename T>
__device__ void y_tile(float* smem, const float* __restrict__ cum,
                       const T* __restrict__ b, const T* __restrict__ c,
                       const T* __restrict__ xdt, T* __restrict__ y, int q,
                       int n, int p, int qt, int pt) {
  float* cs = smem;                              // [kTile][kLdCB]
  float* bs = smem + kTile * kLdCB;              // [kTile][kLdCB]
  float* ss = smem;                              // [kTile][kLdS], aliases
  float* xs = smem + 2 * kTile * kLdCB;          // [kTile][kTile]
  float* cq = xs + kTile * kTile;                // [kTile] query cums
  float* ck = cq + kTile;                        // [kTile] key cums
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int i0 = qt * kTile, p0 = pt * kTile;

  if (tid < kTile) cq[tid] = i0 + tid < q ? cum[i0 + tid] : 0.f;
  float acc[4][4] = {};
  for (int kt = 0; kt <= qt; ++kt) {
    const int j0 = kt * kTile;
    __syncthreads();            // the last tile's ss, xs, ck are consumed
    if (tid < kTile) ck[tid] = j0 + tid < q ? cum[j0 + tid] : 0.f;
    for (int r = ty; r < kTile; r += 16) {
      for (int col = tx; col < kTile; col += 16) {
        const bool ok = j0 + r < q && p0 + col < p;
        xs[r * kTile + col] =
            ok ? to_f32(xdt[static_cast<int64_t>(j0 + r) * p + p0 + col])
               : 0.f;
      }
    }
    float s[4][4] = {};
    for (int k0 = 0; k0 < n; k0 += kDepth) {
      __syncthreads();          // the last depth step's cs, bs are consumed
      for (int r = ty; r < kTile; r += 16) {
        for (int col = tx; col < kDepth; col += 16) {
          const bool okn = k0 + col < n;
          cs[r * kLdCB + col] =
              i0 + r < q && okn
                  ? to_f32(c[static_cast<int64_t>(i0 + r) * n + k0 + col])
                  : 0.f;
          bs[r * kLdCB + col] =
              j0 + r < q && okn
                  ? to_f32(b[static_cast<int64_t>(j0 + r) * n + k0 + col])
                  : 0.f;
        }
      }
      __syncthreads();
      const int depth = n - k0 < kDepth ? n - k0 : kDepth;
      for (int kk = 0; kk < depth; ++kk) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = cs[(ty + 16 * r) * kLdCB + kk];
#pragma unroll
        for (int u = 0; u < 4; ++u) bv[u] = bs[(tx + 16 * u) * kLdCB + kk];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int u = 0; u < 4; ++u) s[r][u] = fmaf(cv[r], bv[u], s[r][u]);
        }
      }
    }
    __syncthreads();            // cs, bs are read; ss may overwrite them
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = ty + 16 * r, j = tx + 16 * u;
        const bool keep = j0 + j <= i0 + i && j0 + j < q;
        ss[i * kLdS + j] = keep ? s[r][u] * clipped_exp(cq[i] - ck[j]) : 0.f;
      }
    }
    __syncthreads();
    const int width = q - j0 < kTile ? q - j0 : kTile;
    for (int jj = 0; jj < width; ++jj) {
      float sv[4], xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) sv[r] = ss[(ty + 16 * r) * kLdS + jj];
#pragma unroll
      for (int u = 0; u < 4; ++u) xv[u] = xs[jj * kTile + tx + 16 * u];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[r][u] = fmaf(sv[r], xv[u], acc[r][u]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int gi = i0 + ty + 16 * r, gp = p0 + tx + 16 * u;
      if (gi < q && gp < p) {
        store(&y[static_cast<int64_t>(gi) * p + gp], acc[r][u]);
      }
    }
  }
}

template <typename T>
__device__ void state_tile(float* smem, const float* __restrict__ cum,
                           const T* __restrict__ b,
                           const T* __restrict__ xdt,
                           float* __restrict__ state,
                           float* __restrict__ decay, int q, int n, int p,
                           int nt, int pt) {
  float* bt = smem;                        // [kTile j][kTile n]
  float* xs = smem + kTile * kTile;        // [kTile j][kTile p]
  float* tl = xs + kTile * kTile;          // [kTile]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = nt * kTile, p0 = pt * kTile;
  const float last = cum[q - 1];

  float acc[4][4] = {};
  for (int j0 = 0; j0 < q; j0 += kTile) {
    __syncthreads();            // the last tile's bt, xs, tl are consumed
    if (tid < kTile) {
      tl[tid] = j0 + tid < q ? clipped_exp(last - cum[j0 + tid]) : 0.f;
    }
    __syncthreads();
    for (int r = ty; r < kTile; r += 16) {
      const bool okj = j0 + r < q;
      const int64_t row = j0 + r;
      for (int col = tx; col < kTile; col += 16) {
        bt[r * kTile + col] = okj && n0 + col < n
                                  ? to_f32(b[row * n + n0 + col]) * tl[r]
                                  : 0.f;
        xs[r * kTile + col] =
            okj && p0 + col < p ? to_f32(xdt[row * p + p0 + col]) : 0.f;
      }
    }
    __syncthreads();
    const int width = q - j0 < kTile ? q - j0 : kTile;
    for (int jj = 0; jj < width; ++jj) {
      float bv[4], xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) bv[r] = bt[jj * kTile + ty + 16 * r];
#pragma unroll
      for (int u = 0; u < 4; ++u) xv[u] = xs[jj * kTile + tx + 16 * u];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[r][u] = fmaf(bv[r], xv[u], acc[r][u]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int gn = n0 + ty + 16 * r, gp = p0 + tx + 16 * u;
      if (gn < n && gp < p) state[static_cast<int64_t>(gn) * p + gp] = acc[r][u];
    }
  }
  if (nt == 0 && pt == 0 && tid == 0) *decay = clipped_exp(last);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_intra_chunk_kernel(const float* __restrict__ cum,
                       const T* __restrict__ b, const T* __restrict__ c,
                       const T* __restrict__ xdt, T* __restrict__ y,
                       float* __restrict__ state, float* __restrict__ decay,
                       int q, int n, int p, int q_tiles, int p_tiles) {
  __shared__ float smem[kSmem];
  const int64_t g = blockIdx.x;
  const int tile = blockIdx.y;
  const float* cum_g = cum + g * q;
  const T* b_g = b + g * q * n;
  const T* x_g = xdt + g * q * p;
  if (tile < q_tiles * p_tiles) {
    y_tile<T>(smem, cum_g, b_g, c + g * q * n, x_g, y + g * q * p, q, n, p,
              tile / p_tiles, tile % p_tiles);
  } else {
    const int st = tile - q_tiles * p_tiles;
    state_tile<T>(smem, cum_g, b_g, x_g, state + g * n * p, decay + g, q, n,
                  p, st / p_tiles, st % p_tiles);
  }
}

}  // namespace

// cum: (g, q) f32. b, c: (g, q, n) and xdt: (g, q, p), row-major, dtype
// 0 = f32, 1 = bf16. y: (g, q, p) in xdt's dtype; state: (g, n, p) f32;
// decay: (g,) f32. Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape the grid
// cannot hold).
extern "C" int repro_ssd_intra_chunk(const void* cum, const void* b,
                                     const void* c, const void* xdt, void* y,
                                     void* state, void* decay, int64_t g,
                                     int64_t q, int64_t n, int64_t p,
                                     int dtype, void* stream) {
  const int64_t q_tiles = (q + kTile - 1) / kTile;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  const int64_t p_tiles = (p + kTile - 1) / kTile;
  const int64_t tiles = (q_tiles + n_tiles) * p_tiles;
  if (g < 1 || g > 2147483647LL || tiles > 65535 || q * n > 2147483647LL ||
      q * p > 2147483647LL || n * p > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>(g),
                  static_cast<unsigned int>(tiles));
  const float* cm = static_cast<const float*>(cum);
  float* sto = static_cast<float*>(state);
  float* dec = static_cast<float*>(decay);
  const int qi = static_cast<int>(q), ni = static_cast<int>(n),
            pi = static_cast<int>(p);
  const int qt = static_cast<int>(q_tiles), pt = static_cast<int>(p_tiles);
  if (dtype == 1) {
    ssd_intra_chunk_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        cm, static_cast<const __nv_bfloat16*>(b),
        static_cast<const __nv_bfloat16*>(c),
        static_cast<const __nv_bfloat16*>(xdt),
        static_cast<__nv_bfloat16*>(y), sto, dec, qi, ni, pi, qt, pt);
  } else {
    ssd_intra_chunk_kernel<float><<<grid, kThreads, 0, st>>>(
        cm, static_cast<const float*>(b), static_cast<const float*>(c),
        static_cast<const float*>(xdt), static_cast<float*>(y), sto, dec, qi,
        ni, pi, qt, pt);
  }
  return static_cast<int>(cudaGetLastError());
}
