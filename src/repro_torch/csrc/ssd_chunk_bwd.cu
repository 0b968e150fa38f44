// Mamba2 SSD intra-chunk part, grouped: the backward. The reference has no
// Pallas kernel for it: jax.grad differentiates ssd_chunked's plain jnp
// (repro/models/ssm.py:81). This kernel gives the forward kernel
// (ssd_chunk.cu) its gradient, so the ssm and hybrid families train on the
// card. Per chunk cell and head h of group g, with S = C_g B_g^T,
// L_ij = exp(clip(cum_i - cum_j, -60, 0)) [i >= j], M = S * L,
// tail_j = exp(clip(cum_{Q-1} - cum_j, -60, 0)) and the forward's outputs'
// gradients dy (Q, P), dstate (P, N), ddecay:
//     dM     = (dy xdt^T) [i >= j]          dS_h = dM * L
//     dxdt   = M^T dy + (B_g * tail) dstate^T
//     dC_g   = (sum_h dS_h) B_g
//     dB_g   = (sum_h dS_h)^T C_g + sum_h tail * (xdt_h dstate_h)
//     dcum_i = rowsum(dS * S)_i - colsum(dS * S)_i - r_i
//              + [i = Q-1] (sum_j r_j + ddecay * chunk_decay)
// with r_j = tail_j sum_p xdt_jp (B dstate^T)_jp; a term whose clip binds
// takes no gradient, and the diagonal's and r_{Q-1}'s terms, which cancel,
// are left out (as the plain twin, kernels/ssd_chunk.py, writes them).
//
// Layouts: the forward's. cum (Bz, NC, Q, H) f32, xdt and dy (Bz, NC, Q, H,
// P) contiguous, B and C (Bz, NC, Q, G, N) strided views (N contiguous),
// dstate (Bz, NC, H, P, N) and ddecay (Bz, NC, H) f32. Out: dcum like cum,
// dB and dC (Bz, NC, Q, G, N) contiguous, dxdt like xdt; dB, dC, dxdt in
// the inputs' type (f32 or bf16), every sum in f32.
//
// Bound on the H100. At mamba2-370m's train microbatch (Bz 2, T 4,096:
// NC 16, H 32, G 1, Q 256, N 128, P 64) the work over the causal half is
// about 18.2 GFLOP (per head dM and M^T dy, 4.2 M each; B dstate^T and
// xdt dstate, 4.2 M each; per group S, (sum dS) B, (sum dS)^T C) against
// about 0.25 GB moved: 0.27 ms on the CUDA cores at 67 TFLOP/s (0.11 ms
// were every product 3xTF32 on the tensor cores). Operations bound it.
//
// Design: simple and right first, every product an f32 FMA chain on the
// CUDA cores (the forward's score products are FMA chains for the twin's
// summation order; the same holds here). Three launches:
// 1. ssd_bwd_scores: S = C B^T for each lower (query tile, key tile) pair
//    of a cell and group, into a workspace (no Q x Q tensor is kept between
//    forward and backward; the group's S is formed once, not per head).
// 2. ssd_bwd_heads, two roles by blockIdx.y (heaviest first):
//    - key blocks (cell, group, head subset, key tile kt): per head, the
//      state part (B_kt dstate^T, giving r_j and tail * it as dxdt's
//      first term), then M^T dy over the query tiles below, written as
//      dxdt; then sum_h tail * (xdt_h dstate_h) over the subset, per N
//      tile, into a workspace;
//    - pair blocks (cell, group, head subset, query tile, key tile): per
//      head, dM and dS over the tile, the tile's row and column sums of
//      dS * S (for dcum), and sum_h dS_h over the subset into a
//      workspace.
// 3. ssd_bwd_reduce (cell, group, row tile): the subsets' dS summed in a
//    fixed order, then dC and dB for the tile's rows, and dcum from the
//    row, column and r partials.
// A block runs 128 threads; each owns an 8 x 4 piece of a 64 x 64 output
// tile (rows rg * 8 + r, columns cg + 16 u). Tiles are staged in shared
// memory as f32 (bf16 widened on load), zero-filled past Q, N and P, so
// ragged shapes are masked and nothing is padded; where the rows allow
// it, four elements a load, every load of a tile issued before its
// stores. ssd_bwd_heads is held to 128 registers a thread, so that four
// blocks share an SM: ptxas then spills a little, and at both models'
// shapes this ran faster than the two blocks an SM that the unbounded
// build's register count allows (slower at small synthetic shapes, whose
// few blocks leave SMs idle either way). Every sum runs in one
// fixed order (FMA chains in depth order, fixed shuffle trees, the
// subsets and partials summed in index order) with no atomics: a repeated
// call is bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd.cuh"

namespace {

using ssd::clipped_exp;
using ssd::load4;
using ssd::store;
using ssd::to_f32;

constexpr int kThreads = 128;       // 4 warps
constexpr int kTile = 64;           // rows, keys, P and N columns per tile
constexpr int kLd = kTile + 4;      // shared tile row stride in floats
constexpr int kTileFloats = kTile * kLd;
constexpr int kMaxQ = 512;

struct Params {
  const float* cum;
  const void* b;
  const void* c;
  const void* xdt;
  const void* dy;
  const float* dstate;
  const float* ddecay;
  float* dcum;
  void* db;
  void* dc;
  void* dxdt;
  float* s;      // (cells, G, q_pad, q_pad): C B^T, lower tiles
  float* ds;     // (cells, G, h_sub, q_pad, q_pad): a subset's sum of dS
  float* tb;     // (cells, G, h_sub, q_pad, N): sum_h tail * (xdt dstate)
  float* rowp;   // (cells, H, q_tiles, q_pad): rowsum(dS * S) per key tile
  float* colp;   // (cells, H, q_tiles, q_pad): colsum(dS * S) per query tile
  float* rr;     // (cells, H, q_pad): r_j
  int64_t sb[4];  // B strides in elements: batch, chunk, row, group
  int64_t sc[4];  // C strides
  int nc, q, h, g, n, p, rep, hs, h_sub, q_tiles, q_pad, pairs;
};

// where the clip passes the gradient (torch.clamp's rule: bounds included)
__device__ __forceinline__ bool live(float x) {
  return x >= -60.f && x <= 0.f;
}

// Stage a 64 x 64 tile of src (row stride rs; entries outside rv x cv are
// 0) into dst as f32, as it is ([row][col]) or transposed ([col][row]).
// Where the rows and the pointer sit on 4-element boundaries, a thread
// moves four consecutive columns a load, all its loads issued before its
// stores: along a row for a tile kept as it is (coalesced loads), down
// the rows for a transposed one (a warp's stores then fill 32 consecutive
// words). Elsewhere one element a load.
template <typename T, bool kTranspose>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t rs, int rv, int cv) {
  const bool vec = rs % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % (4 * sizeof(T)) == 0;
  if (vec) {
    constexpr int kSteps = kTile * kTile / 4 / kThreads;   // 8
    float v[kSteps][4];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int idx = s * kThreads + threadIdx.x;
      const int r = kTranspose ? idx % kTile : idx / (kTile / 4);
      const int col = 4 * (kTranspose ? idx / kTile : idx % (kTile / 4));
      if (r < rv && col + 4 <= cv) {
        load4(src + r * rs + col, v[s]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[s][i] = r < rv && col + i < cv ? to_f32(src[r * rs + col + i])
                                           : 0.f;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int idx = s * kThreads + threadIdx.x;
      const int r = kTranspose ? idx % kTile : idx / (kTile / 4);
      const int col = 4 * (kTranspose ? idx / kTile : idx % (kTile / 4));
      if (kTranspose) {
#pragma unroll
        for (int i = 0; i < 4; ++i) dst[(col + i) * kLd + r] = v[s][i];
      } else {
        *reinterpret_cast<float4*>(dst + r * kLd + col) =
            make_float4(v[s][0], v[s][1], v[s][2], v[s][3]);
      }
    }
  } else {
#pragma unroll 8
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, col = e % kTile;
      const float v = r < rv && col < cv ? to_f32(src[r * rs + col]) : 0.f;
      if (kTranspose) {
        dst[col * kLd + r] = v;
      } else {
        dst[r * kLd + col] = v;
      }
    }
  }
}

// acc[r][u] += sum_k xt[k][rg * 8 + r] * y[k][cg + 16 u], k in depth order
__device__ __forceinline__ void mma_tile(float (&acc)[8][4], const float* xt,
                                         const float* y, int rg, int cg) {
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(xt + k * kLd + rg * 8);
    const float4 a1 =
        *reinterpret_cast<const float4*>(xt + k * kLd + rg * 8 + 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float bv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) bv[u] = y[k * kLd + cg + 16 * u];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[r][u] = fmaf(a[r], bv[u], acc[r][u]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[r][u] = 0.f;
}

// the sum over the 16 lanes of a thread's row group (cg = lane % 16), in
// a fixed order; every one of the 16 lanes gets it
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int m = 1; m < 16; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// the lower pair index -> (query tile, key tile), kt <= qt, qt-major
__device__ __forceinline__ void pair_of(int idx, int& qt, int& kt) {
  qt = 0;
  while (idx > qt) {
    idx -= qt + 1;
    ++qt;
  }
  kt = idx;
}

template <typename T>
__device__ __forceinline__ const T* group_rows(const void* base,
                                               const int64_t (&st)[4],
                                               const Params& pr, int64_t cell,
                                               int grp) {
  return static_cast<const T*>(base) + (cell / pr.nc) * st[0] +
         (cell % pr.nc) * st[1] + grp * st[3];
}

// 1. S = C B^T for the (qt, kt) pair: one FMA chain over n per entry, in
// n order (the forward's order for the same product)
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_scores(const Params pr) {
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;                  // C^T [n][i]
  float* bt = smem + kTileFloats;    // B^T [n][j]
  const int64_t cell = blockIdx.x / pr.g;
  const int grp = static_cast<int>(blockIdx.x % pr.g);
  int qt, kt;
  pair_of(blockIdx.y, qt, kt);
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const T* cgp = group_rows<T>(pr.c, pr.sc, pr, cell, grp);
  const T* bgp = group_rows<T>(pr.b, pr.sb, pr, cell, grp);
  float acc[8][4];
  zero(acc);
  for (int n0 = 0; n0 < pr.n; n0 += kTile) {
    __syncthreads();
    load_tile<T, true>(ct, cgp + qt * kTile * pr.sc[2] + n0, pr.sc[2],
                       pr.q - qt * kTile, pr.n - n0);
    load_tile<T, true>(bt, bgp + kt * kTile * pr.sb[2] + n0, pr.sb[2],
                       pr.q - kt * kTile, pr.n - n0);
    __syncthreads();
    mma_tile(acc, ct, bt, rg, cg);
  }
  float* out = pr.s + (cell * pr.g + grp) * pr.q_pad * pr.q_pad +
               static_cast<int64_t>(qt * kTile) * pr.q_pad + kt * kTile;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      out[(rg * 8 + r) * pr.q_pad + cg + 16 * u] = acc[r][u];
}

// 2a. key block: dxdt for the key tile kt of hs heads, their r_j, and the
// subset's sum of tail * (xdt_h dstate_h) for the tile's rows
template <typename T>
__device__ void key_block(const Params& pr, float* smem, int64_t cell,
                          int grp, int hsub, int kt) {
  float* xt = smem;
  float* yt = smem + kTileFloats;
  float* tl = yt + kTileFloats;      // tail_j of the tile's keys
  float* cj = tl + kTile;            // cum_j of the tile's keys
  float* ci = cj + kTile;            // cum_i of the current query tile
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const int q = pr.q, n = pr.n, p = pr.p, j0 = kt * kTile;
  const int64_t hp = static_cast<int64_t>(pr.h) * p;   // a row of xdt
  const T* bgp = group_rows<T>(pr.b, pr.sb, pr, cell, grp);
  const T* xcell = static_cast<const T*>(pr.xdt) + cell * q * hp;
  const T* ycell = static_cast<const T*>(pr.dy) + cell * q * hp;
  T* dxcell = static_cast<T*>(pr.dxdt) + cell * q * hp;
  const int head0 = grp * pr.rep + hsub * pr.hs;
  float acc[8][4];

  // the cum and tail of head hd's keys in this tile
  auto key_vectors = [&](int hd) {
    __syncthreads();
    const float last = pr.cum[(cell * q + q - 1) * pr.h + hd];
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      const bool in = j0 + j < q;
      cj[j] = in ? pr.cum[(cell * q + j0 + j) * pr.h + hd] : 0.f;
      tl[j] = in ? clipped_exp(last - cj[j]) : 0.f;
    }
  };

  for (int t = 0; t < pr.hs; ++t) {
    const int hd = head0 + t;
    key_vectors(hd);
    const float last = pr.cum[(cell * q + q - 1) * pr.h + hd];
    const float* dst = pr.dstate + (cell * pr.h + hd) * p * n;
    float rpart[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) rpart[r] = 0.f;
    for (int p0 = 0; p0 < p; p0 += kTile) {
      // U = B_kt dstate^T (keys x this P tile), over N in order
      zero(acc);
      for (int n0 = 0; n0 < n; n0 += kTile) {
        __syncthreads();
        load_tile<T, true>(xt, bgp + j0 * pr.sb[2] + n0, pr.sb[2], q - j0,
                           n - n0);
        load_tile<float, true>(yt, dst + p0 * n + n0, n, p - p0, n - n0);
        __syncthreads();
        mma_tile(acc, xt, yt, rg, cg);
      }
      // r_j's share of this P tile: sum_p xdt_jp U_jp
      __syncthreads();
      load_tile<T, false>(xt, xcell + j0 * hp + hd * p + p0, hp, q - j0,
                          p - p0);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          rpart[r] = fmaf(xt[(rg * 8 + r) * kLd + cg + 16 * u], acc[r][u],
                          rpart[r]);
      // dxdt = (B * tail) dstate^T + sum over the query tiles of M^T dy
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float tj = tl[rg * 8 + r];
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[r][u] *= tj;
      }
      for (int qt = kt; qt < pr.q_tiles; ++qt) {
        const int i0 = qt * kTile;
        __syncthreads();
        load_tile<float, false>(
            xt, pr.s + (cell * pr.g + grp) * pr.q_pad * pr.q_pad +
                    static_cast<int64_t>(i0) * pr.q_pad + j0,
            pr.q_pad, kTile, kTile);
        load_tile<T, false>(yt, ycell + i0 * hp + hd * p + p0, hp, q - i0,
                            p - p0);
        for (int i = threadIdx.x; i < kTile; i += kThreads) {
          ci[i] = i0 + i < q ? pr.cum[(cell * q + i0 + i) * pr.h + hd] : 0.f;
        }
        __syncthreads();
        for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
          const int i = e / kTile, j = e % kTile;
          const bool causal = i0 + i >= j0 + j && i0 + i < q;
          xt[i * kLd + j] =
              causal ? xt[i * kLd + j] * clipped_exp(ci[i] - cj[j]) : 0.f;
        }
        __syncthreads();
        mma_tile(acc, xt, yt, rg, cg);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int gj = j0 + rg * 8 + r;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int pp = p0 + cg + 16 * u;
          if (gj < q && pp < p) store(&dxcell[gj * hp + hd * p + pp],
                                      acc[r][u]);
        }
      }
    }
    // r_j = tail_j sum_p xdt_jp U_jp where the tail's clip passes it;
    // r_{Q-1} cancels itself and is left out
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float tot = sum16(rpart[r]);
      const int j = rg * 8 + r, gj = j0 + j;
      if (cg == 0) {
        const bool keep = gj < q - 1 && live(last - cj[j]);
        pr.rr[(cell * pr.h + hd) * pr.q_pad + gj] = keep ? tl[j] * tot : 0.f;
      }
    }
  }

  // the subset's sum over its heads of tail * (xdt_h dstate_h), per N
  // tile, heads in order
  float* tbo = pr.tb + ((cell * pr.g + grp) * pr.h_sub + hsub) *
                           static_cast<int64_t>(pr.q_pad) * n;
  for (int n0 = 0; n0 < n; n0 += kTile) {
    zero(acc);
    for (int t = 0; t < pr.hs; ++t) {
      const int hd = head0 + t;
      key_vectors(hd);
      const float* dst = pr.dstate + (cell * pr.h + hd) * p * n;
      for (int p0 = 0; p0 < p; p0 += kTile) {
        __syncthreads();
        load_tile<T, true>(xt, xcell + j0 * hp + hd * p + p0, hp, q - j0,
                           p - p0);
        load_tile<float, false>(yt, dst + p0 * n + n0, n, p - p0, n - n0);
        __syncthreads();
        for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
          xt[(e / kTile) * kLd + e % kTile] *= tl[e % kTile];
        }
        __syncthreads();
        mma_tile(acc, xt, yt, rg, cg);
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int nn = n0 + cg + 16 * u;
        if (nn < n) tbo[(j0 + rg * 8 + r) * static_cast<int64_t>(n) + nn] =
            acc[r][u];
      }
  }
}

// 2b. pair block: for the (qt, kt) tile and hs heads, dM and dS, the row
// and column sums of dS * S, and the subset's sum of dS
template <typename T>
__device__ void pair_block(const Params& pr, float* smem, int64_t cell,
                           int grp, int hsub, int qt, int kt) {
  float* ss = smem;                       // S [i][j]
  float* dyt = ss + kTileFloats;          // dy^T [p][i]
  float* xtt = dyt + kTileFloats;         // xdt^T [p][j]
  float* ci = xtt + kTileFloats;
  float* cj = ci + kTile;
  float* red = cj + kTile;                // [4 warps][64 keys]
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = pr.q, p = pr.p, i0 = qt * kTile, j0 = kt * kTile;
  const int64_t hp = static_cast<int64_t>(pr.h) * p;
  const T* xcell = static_cast<const T*>(pr.xdt) + cell * q * hp;
  const T* ycell = static_cast<const T*>(pr.dy) + cell * q * hp;
  const int head0 = grp * pr.rep + hsub * pr.hs;
  load_tile<float, false>(ss, pr.s + (cell * pr.g + grp) * pr.q_pad *
                                         pr.q_pad +
                                  static_cast<int64_t>(i0) * pr.q_pad + j0,
                          pr.q_pad, kTile, kTile);
  float dsum[8][4], acc[8][4];
  zero(dsum);
  for (int t = 0; t < pr.hs; ++t) {
    const int hd = head0 + t;
    zero(acc);
    for (int p0 = 0; p0 < p; p0 += kTile) {
      __syncthreads();
      load_tile<T, true>(dyt, ycell + i0 * hp + hd * p + p0, hp, q - i0,
                         p - p0);
      load_tile<T, true>(xtt, xcell + j0 * hp + hd * p + p0, hp, q - j0,
                         p - p0);
      if (p0 == 0) {
        for (int k = threadIdx.x; k < kTile; k += kThreads) {
          ci[k] = i0 + k < q ? pr.cum[(cell * q + i0 + k) * pr.h + hd] : 0.f;
          cj[k] = j0 + k < q ? pr.cum[(cell * q + j0 + k) * pr.h + hd] : 0.f;
        }
      }
      __syncthreads();
      mma_tile(acc, dyt, xtt, rg, cg);
    }
    float rsum[8], csum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = rg * 8 + r, gi = i0 + i;
      rsum[r] = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = cg + 16 * u, gj = j0 + j;
        const float x = ci[i] - cj[j];
        const bool causal = gi >= gj && gi < q;
        const float d = acc[r][u] * (causal ? clipped_exp(x) : 0.f);
        dsum[r][u] += d;
        const float e = gi > gj && gi < q && live(x) ? d * ss[i * kLd + j]
                                                     : 0.f;
        rsum[r] += e;
        csum[u] += e;
      }
    }
    float* rowo = pr.rowp + ((cell * pr.h + hd) * pr.q_tiles + kt) *
                                static_cast<int64_t>(pr.q_pad) + i0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float tot = sum16(rsum[r]);
      if (cg == 0) rowo[rg * 8 + r] = tot;
    }
    // column sums: the warp's two row groups, then the four warps in order
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float tot = csum[u] + __shfl_xor_sync(0xffffffffu, csum[u], 16);
      if (lane < 16) red[warp * kTile + cg + 16 * u] = tot;
    }
    __syncthreads();
    if (threadIdx.x < kTile) {
      const int j = threadIdx.x;
      pr.colp[((cell * pr.h + hd) * pr.q_tiles + qt) *
                  static_cast<int64_t>(pr.q_pad) + j0 + j] =
          ((red[j] + red[kTile + j]) + red[2 * kTile + j]) + red[3 * kTile + j];
    }
  }
  float* dso = pr.ds + ((cell * pr.g + grp) * pr.h_sub + hsub) *
                           static_cast<int64_t>(pr.q_pad) * pr.q_pad +
               static_cast<int64_t>(i0) * pr.q_pad + j0;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      dso[(rg * 8 + r) * pr.q_pad + cg + 16 * u] = dsum[r][u];
}

template <typename T>
// four blocks an SM: at most 128 registers a thread (see the note at the
// top)
__global__ void __launch_bounds__(kThreads, 4)
ssd_bwd_heads(const Params pr) {
  extern __shared__ __align__(16) float smem[];
  const int64_t cell = blockIdx.x / pr.g;
  const int grp = static_cast<int>(blockIdx.x % pr.g);
  const int role = blockIdx.y;
  const int n_key = pr.h_sub * pr.q_tiles;
  if (role < n_key) {                  // key blocks first: the heaviest
    key_block<T>(pr, smem, cell, grp, role % pr.h_sub, role / pr.h_sub);
  } else {
    const int idx = role - n_key;
    int qt, kt;
    pair_of(idx / pr.h_sub, qt, kt);
    pair_block<T>(pr, smem, cell, grp, idx % pr.h_sub, qt, kt);
  }
}

// the subsets' dS for the (qt, kt) tile summed in subset order, into dst
// as it is ([i][j]) or transposed ([j][i])
template <bool kTranspose>
__device__ __forceinline__ void sum_ds(float* dst, const Params& pr,
                                       int64_t cell, int grp, int qt,
                                       int kt) {
  const int64_t plane = static_cast<int64_t>(pr.q_pad) * pr.q_pad;
  const float* src = pr.ds + (cell * pr.g + grp) * pr.h_sub * plane +
                     static_cast<int64_t>(qt * kTile) * pr.q_pad + kt * kTile;
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int i = e / kTile, j = e % kTile;
    float v = 0.f;
    for (int s = 0; s < pr.h_sub; ++s) v += src[s * plane + i * pr.q_pad + j];
    if (kTranspose) {
      dst[j * kLd + i] = v;
    } else {
      dst[i * kLd + j] = v;
    }
  }
}

// 3. the row tile rt and the N tile nt: dC (even blockIdx.y) or dB (odd)
// for the tile's rows; the dC block of the first N tile also writes dcum
// for its rows of the group's heads
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce(const Params pr) {
  extern __shared__ __align__(16) float smem[];
  float* xt = smem;
  float* yt = smem + kTileFloats;
  const int64_t cell = blockIdx.x / pr.g;
  const int grp = static_cast<int>(blockIdx.x % pr.g);
  const bool is_db = blockIdx.y % 2;
  const int n_tiles = (pr.n + kTile - 1) / kTile;
  const int nt = (blockIdx.y / 2) % n_tiles;
  const int rt = blockIdx.y / 2 / n_tiles, r0 = rt * kTile, n0 = nt * kTile;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const int q = pr.q, n = pr.n;
  const T* cgp = group_rows<T>(pr.c, pr.sc, pr, cell, grp);
  const T* bgp = group_rows<T>(pr.b, pr.sb, pr, cell, grp);
  const int64_t orow = static_cast<int64_t>(pr.g) * n;   // a row of dB, dC
  T* dcg = static_cast<T*>(pr.dc) + cell * q * orow + grp * n;
  T* dbg = static_cast<T*>(pr.db) + cell * q * orow + grp * n;
  const float* tbg = pr.tb + (cell * pr.g + grp) * pr.h_sub *
                                 static_cast<int64_t>(pr.q_pad) * n;
  float acc[8][4];
  zero(acc);
  if (!is_db) {
    // dC rows: sum over the key tiles kt <= rt of dS_g(rt, kt) B_kt
    for (int kt = 0; kt <= rt; ++kt) {
      __syncthreads();
      sum_ds<true>(xt, pr, cell, grp, rt, kt);
      load_tile<T, false>(yt, bgp + kt * kTile * pr.sb[2] + n0, pr.sb[2],
                          q - kt * kTile, n - n0);
      __syncthreads();
      mma_tile(acc, xt, yt, rg, cg);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int gi = r0 + rg * 8 + r, nn = n0 + cg + 16 * u;
        if (gi < q && nn < n) store(&dcg[gi * orow + nn], acc[r][u]);
      }
  } else {
    // dB rows: sum over the query tiles qt >= rt of dS_g(qt, rt)^T C_qt,
    // then the subsets' tail terms in subset order
    for (int qt = rt; qt < pr.q_tiles; ++qt) {
      __syncthreads();
      sum_ds<false>(xt, pr, cell, grp, qt, rt);
      load_tile<T, false>(yt, cgp + qt * kTile * pr.sc[2] + n0, pr.sc[2],
                          q - qt * kTile, n - n0);
      __syncthreads();
      mma_tile(acc, xt, yt, rg, cg);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int gj = r0 + rg * 8 + r, nn = n0 + cg + 16 * u;
        if (gj < q && nn < n) {
          float v = acc[r][u];
          for (int s = 0; s < pr.h_sub; ++s) {
            v += tbg[(s * static_cast<int64_t>(pr.q_pad) + gj) * n + nn];
          }
          store(&dbg[gj * orow + nn], v);
        }
      }
    return;
  }
  if (nt != 0) return;
  // dcum of the group's heads on this tile's rows
  for (int e = threadIdx.x; e < pr.rep * kTile; e += kThreads) {
    const int hd = grp * pr.rep + e / kTile, gi = r0 + e % kTile;
    if (gi >= q) continue;
    const int64_t ch = cell * pr.h + hd;
    float v = 0.f;
    for (int kt = 0; kt <= rt; ++kt) {
      v += pr.rowp[(ch * pr.q_tiles + kt) * pr.q_pad + gi];
    }
    for (int qt = rt; qt < pr.q_tiles; ++qt) {
      v -= pr.colp[(ch * pr.q_tiles + qt) * pr.q_pad + gi];
    }
    v -= pr.rr[ch * pr.q_pad + gi];
    if (gi == q - 1) {
      float rs = 0.f;
      for (int j = 0; j < q; ++j) rs += pr.rr[ch * pr.q_pad + j];
      const float last = pr.cum[(cell * q + q - 1) * pr.h + hd];
      v += rs + (live(last) ? pr.ddecay[ch] * clipped_exp(last) : 0.f);
    }
    pr.dcum[(cell * q + gi) * pr.h + hd] = v;
  }
}

constexpr size_t kMainSmem =
    sizeof(float) * (3 * kTileFloats + 2 * kTile + 4 * kTile);
constexpr size_t kTwoTiles = sizeof(float) * 2 * kTileFloats;

// the workspace's parts in floats, in order: s, ds, tb, rowp, colp, rr
void workspace_parts(int64_t cells, int64_t h, int64_t g, int64_t n,
                     int64_t h_sub, int64_t q_tiles, int64_t (&part)[6]) {
  const int64_t q_pad = q_tiles * kTile;
  part[0] = cells * g * q_pad * q_pad;
  part[1] = cells * g * h_sub * q_pad * q_pad;
  part[2] = cells * g * h_sub * q_pad * n;
  part[3] = cells * h * q_tiles * q_pad;
  part[4] = part[3];
  part[5] = cells * h * q_pad;
}

template <typename T>
int launch(const Params& pr, int64_t cells, cudaStream_t st) {
  auto mk = ssd_bwd_heads<T>;
  cudaError_t e = cudaFuncSetAttribute(
      mk, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMainSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned int gx = static_cast<unsigned int>(cells * pr.g);
  ssd_bwd_scores<T><<<dim3(gx, pr.pairs), kThreads, kTwoTiles, st>>>(pr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mk<<<dim3(gx, pr.h_sub * (pr.q_tiles + pr.pairs)), kThreads, kMainSmem,
       st>>>(pr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned int n_tiles = (pr.n + kTile - 1) / kTile;
  ssd_bwd_reduce<T><<<dim3(gx, pr.q_tiles * n_tiles * 2), kThreads,
                       kTwoTiles, st>>>(pr);
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int64_t cells, int64_t q, int64_t h, int64_t g, int64_t n,
                 int64_t p, int64_t hs) {
  if (cells < 1 || q < 1 || n < 1 || p < 1 || g < 1 || h % g != 0 ||
      hs < 1 || (h / g) % hs != 0 || q > kMaxQ || cells * g > 2147483647LL ||
      q * h * p > 2147483647LL || h * p * n > 2147483647LL) {
    return false;
  }
  const int64_t q_tiles = (q + kTile - 1) / kTile;
  const int64_t pairs = q_tiles * (q_tiles + 1) / 2;
  return (h / g / hs) * (q_tiles + pairs) <= 65535 &&
         q_tiles * ((n + kTile - 1) / kTile) * 2 <= 65535;
}

}  // namespace

// The workspace the backward needs, in bytes (0 for a shape it refuses).
extern "C" int64_t repro_ssd_bwd_workspace(int64_t bz, int64_t nc, int64_t q,
                                           int64_t h, int64_t g, int64_t n,
                                           int64_t p, int64_t hs) {
  if (!valid_shape(bz * nc, q, h, g, n, p, hs)) return 0;
  int64_t part[6];
  workspace_parts(bz * nc, h, g, n, h / g / hs, (q + kTile - 1) / kTile,
                  part);
  int64_t total = 0;
  for (int64_t v : part) total += v;
  return total * static_cast<int64_t>(sizeof(float));
}

// cum (bz, nc, q, h) f32; b, c (bz, nc, q, g, n) with element strides sb*,
// sc* (N contiguous); xdt, dy (bz, nc, q, h, p); dstate (bz, nc, h, p, n)
// and ddecay (bz, nc, h) f32; dtype 0 = f32, 1 = bf16 for b, c, xdt, dy and
// db, dc, dxdt. dcum (bz, nc, q, h) f32; db, dc (bz, nc, q, g, n) and dxdt
// (bz, nc, q, h, p) contiguous. work: repro_ssd_bwd_workspace's bytes,
// 16-byte aligned. hs heads per block (hs divides h / g). Launches three
// kernels on `stream`, allocates nothing, returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape it refuses).
extern "C" int repro_ssd_grouped_bwd(
    const void* cum, const void* b, const void* c, const void* xdt,
    const void* dy, const void* dstate, const void* ddecay, void* dcum,
    void* db, void* dc, void* dxdt, void* work, int64_t bz, int64_t nc,
    int64_t q, int64_t h, int64_t g, int64_t n, int64_t p, int64_t sb0,
    int64_t sb1, int64_t sb2, int64_t sb3, int64_t sc0, int64_t sc1,
    int64_t sc2, int64_t sc3, int64_t hs, int dtype, void* stream) {
  const int64_t cells = bz * nc;
  if (!valid_shape(cells, q, h, g, n, p, hs) ||
      (reinterpret_cast<uintptr_t>(work) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t q_tiles = (q + kTile - 1) / kTile;
  Params pr{};
  pr.cum = static_cast<const float*>(cum);
  pr.b = b;
  pr.c = c;
  pr.xdt = xdt;
  pr.dy = dy;
  pr.dstate = static_cast<const float*>(dstate);
  pr.ddecay = static_cast<const float*>(ddecay);
  pr.dcum = static_cast<float*>(dcum);
  pr.db = db;
  pr.dc = dc;
  pr.dxdt = dxdt;
  int64_t part[6];
  workspace_parts(cells, h, g, n, h / g / hs, q_tiles, part);
  float* w = static_cast<float*>(work);
  float** dst[6] = {&pr.s, &pr.ds, &pr.tb, &pr.rowp, &pr.colp, &pr.rr};
  for (int i = 0; i < 6; ++i) {
    *dst[i] = w;
    w += part[i];
  }
  pr.sb[0] = sb0; pr.sb[1] = sb1; pr.sb[2] = sb2; pr.sb[3] = sb3;
  pr.sc[0] = sc0; pr.sc[1] = sc1; pr.sc[2] = sc2; pr.sc[3] = sc3;
  pr.nc = static_cast<int>(nc);
  pr.q = static_cast<int>(q);
  pr.h = static_cast<int>(h);
  pr.g = static_cast<int>(g);
  pr.n = static_cast<int>(n);
  pr.p = static_cast<int>(p);
  pr.rep = static_cast<int>(h / g);
  pr.hs = static_cast<int>(hs);
  pr.h_sub = static_cast<int>(h / g / hs);
  pr.q_tiles = static_cast<int>(q_tiles);
  pr.q_pad = static_cast<int>(q_tiles * kTile);
  pr.pairs = static_cast<int>(q_tiles * (q_tiles + 1) / 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(pr, cells, st)
                    : launch<float>(pr, cells, st);
}
