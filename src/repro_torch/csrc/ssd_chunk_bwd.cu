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
// about 0.25 GB moved: 0.11 ms with every product 3xTF32 on the tensor
// cores (495 / 3 TFLOP/s), 0.27 ms on the CUDA cores. Operations bound it.
//
// Design: every product on the tensor cores with mma.sync.
// - Which unit runs which product. f32: all seven products (S, dM, B
//   dstate^T, M^T dy, xdt dstate, (sum dS) B, (sum dS)^T C) in 3xTF32
//   (tensor_core.cuh: x = hi + lo, lo*hi + hi*lo + hi*hi per m16n8k8
//   step, about 2^-22 a product). bf16: m16n8k16 with f32 accumulation;
//   a product of two bf16 inputs (S = C B^T, dM = dy xdt^T) is one pass,
//   exact products summed in f32; a product with an f32 operand (M, the
//   group's sum of dS, dstate) splits that operand into bf16 hi + lo and
//   runs two passes against the exact bf16 one. No product runs on FMA
//   chains and none in a single TF32 pass. The mma's f32 accumulate
//   truncates, so every product runs 32 deep at a time from a zeroed
//   accumulator and is added into its sum on the CUDA cores, in depth
//   order.
// - Split once. Operand tiles land in shared memory through a cp.async
//   ring of three stages (16-byte copies, zero-filled past Q, N and P),
//   the copies two steps ahead of the products. Each thread then converts
//   the 16-byte pieces it copied itself into one set of planes: f32 to
//   TF32 hi and lo, or f32 to bf16 hi and lo, applying on the way what
//   the product needs (M = S * L masked; the group's subsets of dS
//   summed), so each element is split once, not once per warp that reads
//   it, and its stage is free for the next copy; bf16 inputs are read
//   where they landed. Fragments then come by ldmatrix (.trans for bf16
//   tiles read down their rows) or, for f32 tiles read down their rows,
//   32-bit loads; row pitches keep every fragment load free of bank
//   conflicts. Where a stride or pointer of B, C, xdt, dy or dstate is no
//   multiple of 16 bytes, the tiles are copied by plain loads into the
//   same ring (a template variant, chosen from the strides in
//   repro_ssd_grouped_bwd; ssd_chunk.py _bwd_vec16 says which); the
//   workspace always takes cp.async, as do the heads' cum (4 bytes each).
// - Tiles are 64 x 64 outputs, 4 warps of 32 x 32, 32 deep a ring step;
//   two blocks an SM (113 KB of shared memory and up to 255 registers a
//   thread; a 16-deep step at three blocks an SM, a deeper ring and
//   subsets of 32 heads ran no faster on the H100). Each launch is one
//   grid dimension with a (cell, group)'s blocks adjacent, so the blocks
//   that run together share that cell's tiles in L2.
// Three launches:
// 1. ssd_bwd_scores: S = C B^T for each lower (query tile, key tile) pair
//    of a cell and group, into a workspace (the group's S is formed once,
//    not per head; no Q x Q tensor is kept between forward and backward).
// 2. ssd_bwd_heads, three roles, heaviest first within a (cell, group):
//    - state blocks (cell, group, head subset, key tile): per head
//      V = xdt dstate (keys x N), and the subset's sum of tail * V, per N
//      tile, into a workspace;
//    - pair blocks (cell, group, head subset, query tile, key tile): per
//      head dM and dS over the tile, the tile's row and column sums of
//      dS * S (for dcum), and the subset's sum of dS into a workspace;
//    - dxdt blocks (cell, group, one head, key tile): U = B dstate^T,
//      r_j = tail_j sum_p xdt_jp U_jp, then dxdt = tail * U + the sum over
//      the query tiles below of M^T dy. One head a block, so the key tiles'
//      serial head loop is gone: a kt = 0 block runs N / 32 + Q / 32 ring
//      steps of one head, and the blocks run in kt order.
//    Head subsets are hs heads (ssd_chunk.py bwd_heads_per_block: the
//    largest divisor of H / G up to 16).
// 3. ssd_bwd_reduce (cell, group, row tile, N tile, dC or dB; heaviest
//    first): the subsets' dS summed in subset order as it lands, then dC
//    or dB for the tile's rows (dB with the subsets' tail terms), and dcum
//    from the row, column and r partials.
// Every sum runs in one fixed order (mma steps in depth order, fixed
// shuffle trees, subsets and partials in index order) with no atomics: a
// repeated call is bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd.cuh"
#include "tensor_core.cuh"

namespace {

using ssd::clipped_exp;
using ssd::store;
using ssd::to_f32;
using tc::cp_async16;
using tc::cp_commit;
using tc::cp_wait;

constexpr int kThreads = 128;       // 4 warps, 2 x 2 over a 64 x 64 tile
constexpr int kTile = 64;           // rows, keys, P and N columns per tile
constexpr int kChunk = 32;          // depth a ring step
constexpr int kMaxQ = 512;
constexpr int kMaxHs = 16;          // heads a subset, at most

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
  int nc, q, h, g, n, p, rep, hs, h_sub, q_tiles, q_pad, pairs, n_tiles,
      p_tiles;
  int heads_roles, reduce_roles;   // blocks a (cell, group) in launches 2, 3
};

// A block's (cell, group) and its role within them: the grid is one
// dimension with the roles of a (cell, group) adjacent, so the blocks that
// run together share that cell's tiles in L2
struct Place {
  int64_t cell;
  int grp, role;
  __device__ __forceinline__ Place(const Params& pr, int roles) {
    const int64_t cg = blockIdx.x / roles;
    cell = cg / pr.g;
    grp = static_cast<int>(cg % pr.g);
    role = static_cast<int>(blockIdx.x % roles);
  }
};

// The ring: kStages stages of two slots (A, B) where a step's tiles land,
// then one set of planes (A hi, A lo, B hi, B lo) that a step's operands
// are split into, so that a stage is free again once split and the copies
// run two steps ahead of the products. An f32 tile is split into TF32 hi
// and lo planes, or in bf16 into bf16 hi and lo planes; a bf16 tile in
// bf16 is read where it landed. A tile is [64 rows][32 deep] ("MK": A's
// rows or B's columns along a row) or [32 deep][64] ("KM": read down its
// rows). Pitches: MK rows 144 bytes (f32) or 80 (bf16), KM rows 288 or
// 144, so that ldmatrix rows fall on eight distinct 16-byte bank groups
// and f32 32-bit loads down the rows on 32 banks.
constexpr int kStages = 3;          // at least 3: see ring
constexpr int kSlot = kTile * (kChunk + 4) * 4;   // an f32 tile
constexpr int kStage = 2 * kSlot;

template <typename T>
struct Ring {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kLdMK = kF32 ? kChunk + 4 : kChunk + 8;   // in T
  static constexpr int kLdKM = kTile + 8;
  static constexpr int kPlane = kF32 ? kSlot : kTile * (kChunk + 8) * 2;
  static constexpr int kPlanes = kStages * kStage;   // where the planes start
  static constexpr int kBytes = kPlanes + 4 * kPlane;
  static_assert(kPlane % 128 == 0 && kSlot % 128 == 0, "plane alignment");
};

// An operand of source type Src (T, or f32 for dstate and the workspace)
// in a T product, laid out MK or KM (see Ring)
template <typename T, typename Src, bool KM>
struct Op {
  static constexpr bool kNative = sizeof(T) == sizeof(Src);
  static constexpr bool kSplit = sizeof(T) == 4 || !kNative;
  static constexpr int kRows = KM ? kChunk : kTile;
  static constexpr int kCols = KM ? kTile : kChunk;
  static constexpr int kE = 16 / static_cast<int>(sizeof(Src));
  static constexpr int kCpr = kCols / kE;          // 16-byte pieces a row
  static constexpr int kPer = kRows * kCpr / kThreads;   // pieces a thread
  // landing pitch (in Src) and plane pitch (in T)
  static constexpr int kLd =
      KM ? kTile + 8 : (sizeof(Src) == 4 ? kChunk + 4 : kChunk + 8);
  static constexpr int kPld = KM ? Ring<T>::kLdKM : Ring<T>::kLdMK;
  static_assert(kRows * kCpr % kThreads == 0, "pieces a thread");
};

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// The 16-byte piece k of this thread: its row and first column
template <class O>
__device__ __forceinline__ void piece(int k, int& r, int& c) {
  const int i = static_cast<int>(threadIdx.x) + k * kThreads;
  r = i / O::kCpr;
  c = (i % O::kCpr) * O::kE;
}

// Copy an operand's rows x cols tile at src (row stride rs) into the slot;
// entries outside rv x cv are 0. V16: 16-byte cp.async; else plain loads
// of the same pieces by the same threads.
template <typename T, typename Src, bool KM, bool V16>
__device__ __forceinline__ void load_op(unsigned char* slot, const Src* src,
                                        int64_t rs, int rv, int cv) {
  using O = Op<T, Src, KM>;
  Src* dst = reinterpret_cast<Src*>(slot);
#pragma unroll
  for (int k = 0; k < O::kPer; ++k) {
    int r, c;
    piece<O>(k, r, c);
    if constexpr (V16) {
      const int valid = r < rv ? min(max(cv - c, 0), O::kE) : 0;
      cp_async16(dst + r * O::kLd + c, valid ? src + r * rs + c : src,
                 valid * static_cast<int>(sizeof(Src)));
    } else {
#pragma unroll
      for (int e = 0; e < O::kE; ++e) {
        dst[r * O::kLd + c + e] =
            r < rv && c + e < cv ? src[r * rs + c + e] : zero_of<Src>();
      }
    }
  }
}

// Four landed f32 values of this thread's piece k
template <class O>
__device__ __forceinline__ void landed(const unsigned char* slot, int k,
                                       float (&v)[4]) {
  int r, c;
  piece<O>(k, r, c);
  const float4 x = *reinterpret_cast<const float4*>(
      slot + (r * O::kLd + c) * 4);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

// Split this thread's landed pieces in slot into the planes hi and
// hi + kPlane (lo) after f(k, r, c, v) has rewritten each (a bf16 tile in
// bf16 is not split)
template <typename T, typename Src, bool KM, class F>
__device__ __forceinline__ void split_op(const unsigned char* slot,
                                         unsigned char* hi, F&& f) {
  using O = Op<T, Src, KM>;
  unsigned char* lo = hi + Ring<T>::kPlane;
  if constexpr (O::kSplit) {
#pragma unroll
    for (int k = 0; k < O::kPer; ++k) {
      int r, c;
      piece<O>(k, r, c);
      float v[4];
      landed<O>(slot, k, v);
      f(k, r, c, v);
      if constexpr (sizeof(T) == 4) {
        uint32_t h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) tc::split(v[e], h[e], l[e]);
        const int off = (r * O::kPld + c) * 4;
        *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
      } else {
        uint32_t h0, l0, h1, l1;
        tc::split_bf16(v[0], v[1], h0, l0);
        tc::split_bf16(v[2], v[3], h1, l1);
        const int off = (r * O::kPld + c) * 2;
        *reinterpret_cast<uint2*>(hi + off) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(lo + off) = make_uint2(l0, l1);
      }
    }
  }
}

// The identity rewrite for split_op
struct Keep {
  __device__ __forceinline__ void operator()(int, int, int,
                                             float (&)[4]) const {}
};

// Split both operands of a step: A from slot st into planes pl, B from
// st + kSlot into pl + 2 kPlane
template <typename T, typename SA, bool AKM, typename SB, bool BKM, class FA>
__device__ __forceinline__ void split_step(const unsigned char* st,
                                           unsigned char* pl, FA&& fa) {
  split_op<T, SA, AKM>(st, pl, fa);
  split_op<T, SB, BKM>(st + kSlot, pl + 2 * Ring<T>::kPlane, Keep{});
}


// This thread's warp and lane coordinates: the warp owns rows wm * 32 and
// columns wn * 32 of the 64 x 64 output; fragment element (mi, ni, e) is
// row wm * 32 + mi * 16 + g + 8 (e / 2), column wn * 32 + ni * 8 + 2 t +
// e % 2
struct Lane {
  int lane, wm, wn, g, t;
  __device__ __forceinline__ Lane() {
    const int tid = static_cast<int>(threadIdx.x);
    lane = tid & 31;
    wm = tid >> 6;
    wn = (tid >> 5) & 1;
    g = lane >> 2;
    t = lane & 3;
  }
  __device__ __forceinline__ int row(int mi, int e) const {
    return wm * 32 + mi * 16 + g + 8 * (e >> 1);
  }
  __device__ __forceinline__ int col(int ni, int e) const {
    return wn * 32 + ni * 8 + 2 * t + (e & 1);
  }
};

// A fragments of the warp's two 16-row tiles at depth k0 of a plane
template <typename T, bool KM>
__device__ __forceinline__ void frag_a(uint32_t (&a)[2][4],
                                       const unsigned char* pl, int k0,
                                       const Lane& ln) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));   // a 16-byte run
  const int m = ln.lane >> 3, rr = ln.lane & 7;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int m0 = ln.wm * 32 + mi * 16;
    if constexpr (!KM) {
      constexpr int ld = Ring<T>::kLdMK;
      tc::ldsm_x4(a[mi], pl + ((m0 + rr + (m & 1) * 8) * ld + k0 + (m >> 1) * E) *
                              static_cast<int>(sizeof(T)));
    } else if constexpr (sizeof(T) == 2) {
      constexpr int ld = Ring<T>::kLdKM;
      tc::ldsm_x4_trans(a[mi], pl + ((k0 + rr + (m >> 1) * 8) * ld + m0 +
                                     (m & 1) * 8) * 2);
    } else {
      constexpr int ld = Ring<T>::kLdKM;
      const uint32_t* p = reinterpret_cast<const uint32_t*>(pl);
      const int c = m0 + ln.g;
      a[mi][0] = p[(k0 + ln.t) * ld + c];
      a[mi][1] = p[(k0 + ln.t) * ld + c + 8];
      a[mi][2] = p[(k0 + ln.t + 4) * ld + c];
      a[mi][3] = p[(k0 + ln.t + 4) * ld + c + 8];
    }
  }
}

// B fragments of the warp's four 8-column tiles at depth k0 of a plane
template <typename T, bool KM>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4][2],
                                       const unsigned char* pl, int k0,
                                       const Lane& ln) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  const int m = ln.lane >> 3, rr = ln.lane & 7;
  if constexpr (KM && sizeof(T) == 4) {
    constexpr int ld = Ring<T>::kLdKM;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(pl);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = ln.wn * 32 + ni * 8 + ln.g;
      b[ni][0] = p[(k0 + ln.t) * ld + c];
      b[ni][1] = p[(k0 + ln.t + 4) * ld + c];
    }
  } else {
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int n0 = ln.wn * 32 + np * 16;
      uint32_t r[4];
      if constexpr (!KM) {
        constexpr int ld = Ring<T>::kLdMK;
        tc::ldsm_x4(r, pl + ((n0 + rr + (m >> 1) * 8) * ld + k0 + (m & 1) * E) *
                            static_cast<int>(sizeof(T)));
      } else {
        constexpr int ld = Ring<T>::kLdKM;
        tc::ldsm_x4_trans(r, pl + ((k0 + rr + (m & 1) * 8) * ld + n0 +
                                   (m >> 1) * 8) * 2);
      }
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
  }
}

// acc += A B over one ring step (32 deep): each operand from its planes,
// or from its landed tile in st where it is a bf16 tile in bf16
template <typename T, typename SA, bool AKM, typename SB, bool BKM>
__device__ __forceinline__ void step_mma(float (&acc)[2][4][4],
                                         const unsigned char* st,
                                         const unsigned char* pl,
                                         const Lane& ln) {
  using R = Ring<T>;
  constexpr bool kSa = Op<T, SA, AKM>::kSplit, kSb = Op<T, SB, BKM>::kSplit;
  const unsigned char* ah_p = kSa ? pl : st;
  const unsigned char* al_p = pl + R::kPlane;
  const unsigned char* bh_p = kSb ? pl + 2 * R::kPlane : st + kSlot;
  const unsigned char* bl_p = pl + 3 * R::kPlane;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k0 = 0; k0 < kChunk; k0 += 8) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
      frag_a<T, AKM>(ah, ah_p, k0, ln);
      frag_a<T, AKM>(al, al_p, k0, ln);
      frag_b<T, BKM>(bh, bh_p, k0, ln);
      frag_b<T, BKM>(bl, bl_p, k0, ln);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          tc::mma(acc[mi][ni], al[mi], bh[ni]);
          tc::mma(acc[mi][ni], ah[mi], bl[ni]);
          tc::mma(acc[mi][ni], ah[mi], bh[ni]);
        }
    }
  } else {
#pragma unroll
    for (int k0 = 0; k0 < kChunk; k0 += 16) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
      frag_a<T, AKM>(ah, ah_p, k0, ln);
      if constexpr (kSa) frag_a<T, AKM>(al, al_p, k0, ln);
      frag_b<T, BKM>(bh, bh_p, k0, ln);
      if constexpr (kSb) frag_b<T, BKM>(bl, bl_p, k0, ln);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if constexpr (kSa) tc::mma_bf16(acc[mi][ni], al[mi], bh[ni]);
          if constexpr (kSb) tc::mma_bf16(acc[mi][ni], ah[mi], bl[ni]);
          tc::mma_bf16(acc[mi][ni], ah[mi], bh[ni]);
        }
    }
  }
}

using Frag = float[2][4][4];

__device__ __forceinline__ void zero(Frag& a) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[i][j][e] = 0.f;
}

__device__ __forceinline__ void add(Frag& s, const Frag& a) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][j][e] += a[i][j][e];
}

// Store a 64 x 64 fragment tile at out (row stride ld), rows < rv and
// columns < cv
template <typename O>
__device__ __forceinline__ void store_tile(O* out, int64_t ld, const Frag& v,
                                           int rv, int cv, const Lane& ln) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = ln.row(mi, e), c = ln.col(ni, e);
        if (r < rv && c < cv) store(&out[r * ld + c], v[mi][ni][e]);
      }
}

// The ring: load(s, stage) issues step s's copies (one commit group a
// step, two steps ahead); step(s, stage, planes) splits this thread's
// pieces of step s, synchronizes and multiplies. The barrier at the top
// of a step frees the planes and the stage that step s + 2 lands in.
template <typename T, class Load, class Step>
__device__ __forceinline__ void ring(unsigned char* smem, int steps,
                                     Load&& load, Step&& step) {
  unsigned char* planes = smem + Ring<T>::kPlanes;
  load(0, smem);
  cp_commit();
  if (steps > 1) load(1, smem + kStage);
  cp_commit();
  for (int s = 0; s < steps; ++s) {
    cp_wait<1>();
    __syncthreads();
    if (s + 2 < steps) load(s + 2, smem + (s + 2) % kStages * kStage);
    cp_commit();
    step(s, smem + s % kStages * kStage, planes);
  }
}

// where the clip passes the gradient (torch.clamp's rule: bounds included)
__device__ __forceinline__ bool live(float x) {
  return x >= -60.f && x <= 0.f;
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

// 1. S = C B^T for the (qt, kt) pair, over N in steps of 32
template <typename T, bool V16>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_scores(const Params pr) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Lane ln;
  const Place at(pr, pr.pairs);
  const int64_t cell = at.cell;
  const int grp = at.grp;
  int qt, kt;
  pair_of(at.role, qt, kt);
  const T* cq = group_rows<T>(pr.c, pr.sc, pr, cell, grp) +
                qt * kTile * pr.sc[2];
  const T* bk = group_rows<T>(pr.b, pr.sb, pr, cell, grp) +
                kt * kTile * pr.sb[2];
  Frag sum, acc;
  zero(sum);
  ring<T>(
      smem, (pr.n + kChunk - 1) / kChunk,
      [&](int s, unsigned char* st) {
        const int n0 = s * kChunk;
        load_op<T, T, false, V16>(st, cq + n0, pr.sc[2], pr.q - qt * kTile,
                                  pr.n - n0);
        load_op<T, T, false, V16>(st + kSlot, bk + n0, pr.sb[2],
                                  pr.q - kt * kTile, pr.n - n0);
      },
      [&](int, unsigned char* st, unsigned char* pl) {
        split_step<T, T, false, T, false>(st, pl, Keep{});
        __syncthreads();
        zero(acc);
        step_mma<T, T, false, T, false>(acc, st, pl, ln);
        add(sum, acc);
      });
  store_tile(pr.s + (cell * pr.g + grp) * pr.q_pad * pr.q_pad +
                 static_cast<int64_t>(qt * kTile) * pr.q_pad + kt * kTile,
             pr.q_pad, sum, kTile, kTile, ln);
}

// Shared memory a heads block takes past the ring (the pair block's: the
// S tile, the row and column sums, three heads' cum)
constexpr int kLdS = kTile + 8;     // float2 reads at fragment positions
constexpr int kHeadsExtra =
    sizeof(float) * (kTile * kLdS + 4 * kTile + 3 * 2 * kTile);

// Copy cum of head hd at rows r0 + i (i < count) into dst[i], 0 past Q,
// asynchronously: part of the calling step's copies
__device__ __forceinline__ void load_cum(float* dst, const Params& pr,
                                         int64_t cell, int hd, int r0,
                                         int i) {
  const int r = r0 + i;
  tc::cp_async4(dst + i, pr.cum + (cell * pr.q + min(r, pr.q - 1)) * pr.h +
                             hd, r < pr.q ? 4 : 0);
}

// 2a. state block: for hs heads, V = xdt dstate over the key tile kt and
// each N tile, and the subset's sum of tail * V into the workspace
template <typename T, bool V16>
__device__ void state_block(const Params& pr, unsigned char* smem,
                            int64_t cell, int grp, int hsub, int kt) {
  const Lane ln;
  // three visits' cum of the tile's keys, then cum_{Q-1} at 64
  float* cb = reinterpret_cast<float*>(smem + Ring<T>::kBytes);
  constexpr int kCb = kTile + 4;
  const int q = pr.q, n = pr.n, p = pr.p, hs = pr.hs, j0 = kt * kTile;
  const int head0 = grp * pr.rep + hsub * hs;
  const int64_t hp = static_cast<int64_t>(pr.h) * p;
  const T* xk = static_cast<const T*>(pr.xdt) + (cell * q + j0) * hp;
  const int pc = (p + kChunk - 1) / kChunk, per_tile = hs * pc;
  float* tbo = pr.tb + ((cell * pr.g + grp) * pr.h_sub + hsub) *
                           static_cast<int64_t>(pr.q_pad) * n + j0 * n;
  Frag tb, v, acc;
  ring<T>(
      smem, pr.n_tiles * per_tile,
      [&](int s, unsigned char* st) {
        const int n0 = s / per_tile * kTile, rem = s % per_tile;
        const int hd = head0 + rem / pc, p0 = rem % pc * kChunk;
        load_op<T, T, false, V16>(st, xk + hd * p + p0, hp, q - j0, p - p0);
        load_op<T, float, true, V16>(
            st + kSlot, pr.dstate + ((cell * pr.h + hd) * p + p0) * n + n0,
            n, p - p0, n - n0);
        if (rem % pc == 0 && threadIdx.x <= kTile) {   // a head's visit
          float* dst = cb + s / pc % 3 * kCb;
          if (threadIdx.x < kTile) {
            load_cum(dst, pr, cell, hd, j0, threadIdx.x);
          } else {
            load_cum(dst + kTile, pr, cell, hd, q - 1, 0);
          }
        }
      },
      [&](int s, unsigned char* st, unsigned char* pl) {
        const int n0 = s / per_tile * kTile, rem = s % per_tile;
        const int th = rem / pc, pi = rem % pc;
        split_step<T, T, false, float, true>(st, pl, Keep{});
        __syncthreads();
        zero(acc);
        step_mma<T, T, false, float, true>(acc, st, pl, ln);
        if (pi == 0) zero(v);
        add(v, acc);
        if (pi != pc - 1) return;
        if (th == 0) zero(tb);
        const float* cj = cb + s / pc % 3 * kCb;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int j = ln.row(mi, e);
            const float tj =
                j0 + j < q ? clipped_exp(cj[kTile] - cj[j]) : 0.f;
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              tb[mi][ni][e] += tj * v[mi][ni][e];
              tb[mi][ni][e + 1] += tj * v[mi][ni][e + 1];
            }
          }
        if (th == hs - 1) store_tile(tbo + n0, n, tb, kTile, n - n0, ln);
      });
}

// 2b. pair block: for the (qt, kt) tile and hs heads, dM and dS, the row
// and column sums of dS * S, and the subset's sum of dS
template <typename T, bool V16>
__device__ void pair_block(const Params& pr, unsigned char* smem,
                           int64_t cell, int grp, int hsub, int qt, int kt) {
  const Lane ln;
  float* ss = reinterpret_cast<float*>(smem + Ring<T>::kBytes);  // S [i][j]
  float* red = ss + kTile * kLdS;     // [2][64] rows, [2][64] columns
  float* cb = red + 4 * kTile;        // three heads' cum: query rows, keys
  const int tid = threadIdx.x;
  const int q = pr.q, p = pr.p, hs = pr.hs, i0 = qt * kTile, j0 = kt * kTile;
  const int64_t hp = static_cast<int64_t>(pr.h) * p;
  const T* yq = static_cast<const T*>(pr.dy) + (cell * q + i0) * hp;
  const T* xk = static_cast<const T*>(pr.xdt) + (cell * q + j0) * hp;
  const int head0 = grp * pr.rep + hsub * hs;
  // the S tile, in flight with the ring's first stage
  const float* sg = pr.s + (cell * pr.g + grp) * pr.q_pad * pr.q_pad +
                    static_cast<int64_t>(i0) * pr.q_pad + j0;
  for (int i = tid; i < kTile * kTile / 4; i += kThreads) {
    const int r = i / (kTile / 4), c = i % (kTile / 4) * 4;
    cp_async16(ss + r * kLdS + c, sg + r * pr.q_pad + c, 16);
  }
  cp_commit();
  const int pc = (p + kChunk - 1) / kChunk;
  Frag dsum, dm, acc;
  zero(dsum);
  ring<T>(
      smem, hs * pc,
      [&](int s, unsigned char* st) {
        const int th = s / pc, hd = head0 + th, p0 = s % pc * kChunk;
        load_op<T, T, false, V16>(st, yq + hd * p + p0, hp, q - i0, p - p0);
        load_op<T, T, false, V16>(st + kSlot, xk + hd * p + p0, hp, q - j0,
                                  p - p0);
        if (s % pc == 0) {      // the head's cum: query rows, then keys
          load_cum(cb + th % 3 * 2 * kTile, pr, cell, hd,
                   tid < kTile ? i0 : j0 - kTile, tid);
        }
      },
      [&](int s, unsigned char* st, unsigned char* pl) {
        const int th = s / pc, pi = s % pc;
        split_step<T, T, false, T, false>(st, pl, Keep{});
        __syncthreads();
        zero(acc);
        step_mma<T, T, false, T, false>(acc, st, pl, ln);
        if (pi == 0) zero(dm);
        add(dm, acc);
        if (pi != pc - 1) return;
        const float* ci = cb + th % 3 * 2 * kTile;
        const float* cj = ci + kTile;
        float rs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
        float cs[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = ln.row(mi, e), j = ln.col(ni, e);
              const int gi = i0 + i, gj = j0 + j;
              const float x = ci[i] - cj[j];
              const bool causal = gi >= gj && gi < q;
              const float d = causal ? dm[mi][ni][e] * clipped_exp(x) : 0.f;
              dsum[mi][ni][e] += d;
              const float v = gi > gj && gi < q && live(x)
                                  ? d * ss[i * kLdS + j] : 0.f;
              rs[mi][e >> 1] += v;
              cs[ni][e & 1] += v;
            }
        // rows: the quad's lanes, then the two column halves; columns: the
        // eight row groups, then the two row halves
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float v = rs[mi][hf];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (ln.t == 0) red[ln.wn * kTile + ln.row(mi, 2 * hf)] = v;
          }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            float v = cs[ni][b];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (ln.g == 0) red[(2 + ln.wm) * kTile + ln.col(ni, b)] = v;
          }
        __syncthreads();
        const int64_t ch = cell * pr.h + head0 + th;
        if (tid < kTile) {
          pr.rowp[(ch * pr.q_tiles + kt) * pr.q_pad + i0 + tid] =
              red[tid] + red[kTile + tid];
        } else {
          const int j = tid - kTile;
          pr.colp[(ch * pr.q_tiles + qt) * pr.q_pad + j0 + j] =
              red[2 * kTile + j] + red[3 * kTile + j];
        }
      });
  store_tile(pr.ds + ((cell * pr.g + grp) * pr.h_sub + hsub) *
                         static_cast<int64_t>(pr.q_pad) * pr.q_pad +
                 static_cast<int64_t>(i0) * pr.q_pad + j0,
             pr.q_pad, dsum, kTile, kTile, ln);
}

// 2c. dxdt block: one head hd and the key tile kt. Per P tile: U = B_kt
// dstate^T over N, r_j's share sum_p xdt_jp U_jp, then dxdt = tail * U +
// sum over the query tiles qt >= kt of M^T dy; then r_j
template <typename T, bool V16>
__device__ void dxdt_block(const Params& pr, unsigned char* smem,
                           int64_t cell, int grp, int hd, int kt) {
  const Lane ln;
  float* cv = reinterpret_cast<float*>(smem + Ring<T>::kBytes);  // rows >= j0
  float* red = cv + kMaxQ;                                      // [2][64]
  const int q = pr.q, n = pr.n, p = pr.p, j0 = kt * kTile;
  const int64_t hp = static_cast<int64_t>(pr.h) * p;
  for (int r = threadIdx.x; r < pr.q_pad - j0; r += kThreads) {
    cv[r] = j0 + r < q ? pr.cum[(cell * q + j0 + r) * pr.h + hd] : 0.f;
  }
  // (cv is published by the first step's barrier)
  const float last = pr.cum[(cell * q + q - 1) * pr.h + hd];
  const T* bk = group_rows<T>(pr.b, pr.sb, pr, cell, grp) + j0 * pr.sb[2];
  const float* dst = pr.dstate + (cell * pr.h + hd) * p * n;
  const float* sg = pr.s + (cell * pr.g + grp) * pr.q_pad * pr.q_pad + j0;
  const T* ycell = static_cast<const T*>(pr.dy) + cell * q * hp + hd * p;
  const T* xcell = static_cast<const T*>(pr.xdt) + cell * q * hp + hd * p;
  T* dxcell = static_cast<T*>(pr.dxdt) + cell * q * hp + hd * p;
  const int nch = (n + kChunk - 1) / kChunk;
  const int per = nch + kTile / kChunk * (pr.q_tiles - kt);   // a P tile's steps
  float rp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  Frag dx, acc;
  ring<T>(
      smem, pr.p_tiles * per,
      [&](int s, unsigned char* st) {
        const int p0 = s / per * kTile, u = s % per;
        if (u < nch) {
          const int n0 = u * kChunk;
          load_op<T, T, false, V16>(st, bk + n0, pr.sb[2], q - j0, n - n0);
          load_op<T, float, false, V16>(st + kSlot, dst + p0 * n + n0, n,
                                        p - p0, n - n0);
        } else {
          const int r0 = j0 + (u - nch) * kChunk;    // query rows
          load_op<T, float, true, true>(st, sg + r0 * pr.q_pad, pr.q_pad,
                                        kChunk, kTile);
          load_op<T, T, true, V16>(st + kSlot, ycell + r0 * hp + p0, hp,
                                   q - r0, p - p0);
        }
      },
      [&](int s, unsigned char* st, unsigned char* pl) {
        const int p0 = s / per * kTile, u = s % per;
        if (u < nch) {
          split_step<T, T, false, float, false>(st, pl, Keep{});
          __syncthreads();
          zero(acc);
          step_mma<T, T, false, float, false>(acc, st, pl, ln);
          if (u == 0) zero(dx);
          add(dx, acc);
          if (u == nch - 1) {
            // r_j's share of this P tile, then dxdt's state term tail * U
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const int j = ln.row(mi, 2 * hf), gj = j0 + j;
                const float tj = gj < q ? clipped_exp(last - cv[j]) : 0.f;
#pragma unroll
                for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                  for (int b = 0; b < 2; ++b) {
                    const int pp = p0 + ln.col(ni, b);
                    float& x = dx[mi][ni][2 * hf + b];
                    if (gj < q && pp < p) {
                      rp[mi][hf] += to_f32(xcell[gj * hp + pp]) * x;
                    }
                    x *= tj;
                  }
              }
          }
        } else {
          const int r0 = j0 + (u - nch) * kChunk;
          // M = S * L over rows i >= j and i < Q, transposed by the layout
          split_step<T, float, true, T, true>(
              st, pl, [&](int, int r, int c, float(&v)[4]) {
                const int gi = r0 + r;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int gj = j0 + c + e;
                  v[e] = gi >= gj && gi < q
                             ? v[e] * clipped_exp(cv[gi - j0] - cv[c + e])
                             : 0.f;
                }
              });
          __syncthreads();
          zero(acc);
          step_mma<T, float, true, T, true>(acc, st, pl, ln);
          add(dx, acc);
        }
        if (u == per - 1) {
          store_tile(dxcell + j0 * hp + p0, hp, dx, q - j0, p - p0, ln);
        }
      });
  // r_j = tail_j sum_p xdt_jp U_jp where the tail's clip passes it (the
  // quad's lanes, then the two column halves); r_{Q-1} cancels itself
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float v = rp[mi][hf];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (ln.t == 0) red[ln.wn * kTile + ln.row(mi, 2 * hf)] = v;
    }
  __syncthreads();
  if (threadIdx.x < kTile) {
    const int j = threadIdx.x, gj = j0 + j;
    const bool keep = gj < q - 1 && live(last - cv[j]);
    pr.rr[(cell * pr.h + hd) * pr.q_pad + gj] =
        keep ? clipped_exp(last - cv[j]) * (red[j] + red[kTile + j]) : 0.f;
  }
}

template <typename T, bool V16>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_heads(const Params pr) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Place at(pr, pr.heads_roles);
  const int64_t cell = at.cell;
  const int grp = at.grp;
  int role = at.role;
  const int n_state = pr.h_sub * pr.q_tiles, n_pair = pr.h_sub * pr.pairs;
  if (role < n_state) {                // heaviest first
    state_block<T, V16>(pr, smem, cell, grp, role % pr.h_sub,
                        role / pr.h_sub);
    return;
  }
  role -= n_state;
  if (role < n_pair) {
    int qt, kt;
    pair_of(role / pr.h_sub, qt, kt);
    pair_block<T, V16>(pr, smem, cell, grp, role % pr.h_sub, qt, kt);
    return;
  }
  role -= n_pair;                      // kt ascending: heaviest first
  dxdt_block<T, V16>(pr, smem, cell, grp, grp * pr.rep + role % pr.rep,
                     role / pr.rep);
}

// 3. the row tile rt and the N tile nt: dC or dB for the tile's rows, the
// subsets' dS summed in subset order as each lands; the dC block of the
// first N tile also writes dcum for its rows of the group's heads.
// The roles run heaviest first: the dC block of the last row tile and
// the dB block of the first (q_tiles tile products each), down to one.
template <typename T, bool V16>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce(const Params pr) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Lane ln;
  const Place at(pr, pr.reduce_roles);
  const int64_t cell = at.cell;
  const int grp = at.grp;
  const int nt = at.role % pr.n_tiles, w = at.role / pr.n_tiles / 2;
  const bool is_db = (at.role / pr.n_tiles) % 2;
  const int rt = is_db ? w : pr.q_tiles - 1 - w;
  const int r0 = rt * kTile, n0 = nt * kTile, hsn = pr.h_sub;
  const int q = pr.q, n = pr.n;
  const int64_t plane = static_cast<int64_t>(pr.q_pad) * pr.q_pad;
  const float* dsg = pr.ds + (cell * pr.g + grp) * hsn * plane;
  const T* cg = group_rows<T>(pr.c, pr.sc, pr, cell, grp);
  const T* bg = group_rows<T>(pr.b, pr.sb, pr, cell, grp);
  const int64_t orow = static_cast<int64_t>(pr.g) * n;   // a row of dB, dC
  using OC = Op<T, float, false>;   // dC: sum dS [i][j], MK
  using OB = Op<T, float, true>;    // dB: sum dS [i][j] read as its transpose
  static_assert(OC::kPer == OB::kPer, "pieces a thread");
  float part[OC::kPer][4];    // this thread's pieces, summed over subsets
  Frag sum, acc;
  zero(sum);
  const int steps = (is_db ? pr.q_tiles - rt : rt + 1) * (kTile / kChunk) * hsn;
  ring<T>(
      smem, steps,
      [&](int s, unsigned char* st) {
        const int u = s % hsn, half = s / hsn;   // depth chunks in order
        const int k0 = (is_db ? r0 : 0) + half * kChunk;   // depth rows
        if (!is_db) {
          load_op<T, float, false, true>(st, dsg + u * plane + r0 * pr.q_pad +
                                                 k0, pr.q_pad, kTile, kChunk);
          if (u == hsn - 1) {
            load_op<T, T, true, V16>(st + kSlot, bg + k0 * pr.sb[2] + n0,
                                     pr.sb[2], q - k0, n - n0);
          }
        } else {
          load_op<T, float, true, true>(st, dsg + u * plane + k0 * pr.q_pad +
                                                r0, pr.q_pad, kChunk, kTile);
          if (u == hsn - 1) {
            load_op<T, T, true, V16>(st + kSlot, cg + k0 * pr.sc[2] + n0,
                                     pr.sc[2], q - k0, n - n0);
          }
        }
      },
      [&](int s, unsigned char* st, unsigned char* pl) {
        const int u = s % hsn;
        auto sum_in = [&](int k, int, int, float(&v)[4]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            v[e] = u == 0 ? v[e] : part[k][e] + v[e];
            part[k][e] = v[e];
          }
        };
        if (u < hsn - 1) {
#pragma unroll
          for (int k = 0; k < OC::kPer; ++k) {
            float v[4];
            if (is_db) landed<OB>(st, k, v); else landed<OC>(st, k, v);
            sum_in(k, 0, 0, v);
          }
          return;
        }
        if (is_db) {
          split_step<T, float, true, T, true>(st, pl, sum_in);
        } else {
          split_step<T, float, false, T, true>(st, pl, sum_in);
        }
        __syncthreads();
        zero(acc);
        if (is_db) {
          step_mma<T, float, true, T, true>(acc, st, pl, ln);
        } else {
          step_mma<T, float, false, T, true>(acc, st, pl, ln);
        }
        add(sum, acc);
      });
  if (is_db) {
    // the subsets' tail terms, in subset order
    const float* tbg = pr.tb + (cell * pr.g + grp) * hsn *
                                   static_cast<int64_t>(pr.q_pad) * n;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gj = r0 + ln.row(mi, e), nn = n0 + ln.col(ni, e);
          if (gj < q && nn < n) {
            float v = sum[mi][ni][e];
            for (int u = 0; u < hsn; ++u) {
              v += tbg[(u * static_cast<int64_t>(pr.q_pad) + gj) * n + nn];
            }
            sum[mi][ni][e] = v;
          }
        }
    store_tile(static_cast<T*>(pr.db) + cell * q * orow + grp * n +
                   r0 * orow + n0, orow, sum, q - r0, n - n0, ln);
    return;
  }
  store_tile(static_cast<T*>(pr.dc) + cell * q * orow + grp * n + r0 * orow +
                 n0, orow, sum, q - r0, n - n0, ln);
  if (nt != 0) return;
  // dcum of the group's heads on this tile's rows
  const int last_row = q - 1;
  auto partials = [&](int64_t ch, int gi) {
    float v = 0.f;
    for (int kt = 0; kt <= rt; ++kt) {
      v += pr.rowp[(ch * pr.q_tiles + kt) * pr.q_pad + gi];
    }
    for (int qt = rt; qt < pr.q_tiles; ++qt) {
      v -= pr.colp[(ch * pr.q_tiles + qt) * pr.q_pad + gi];
    }
    return v - pr.rr[ch * pr.q_pad + gi];
  };
  for (int e = threadIdx.x; e < pr.rep * kTile; e += kThreads) {
    const int hd = grp * pr.rep + e / kTile, gi = r0 + e % kTile;
    if (gi >= last_row) continue;
    pr.dcum[(cell * q + gi) * pr.h + hd] = partials(cell * pr.h + hd, gi);
  }
  if (last_row < r0 || last_row >= r0 + kTile) return;
  // the last row adds sum_j r_j and the chunk decay's term: a warp a head,
  // its lanes strided over j, then a fixed shuffle tree
  for (int t = threadIdx.x >> 5; t < pr.rep; t += kThreads / 32) {
    const int hd = grp * pr.rep + t;
    const int64_t ch = cell * pr.h + hd;
    float rs = 0.f;
    for (int j = threadIdx.x & 31; j < q; j += 32) {
      rs += pr.rr[ch * pr.q_pad + j];
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) {
      rs += __shfl_xor_sync(0xffffffffu, rs, m);
    }
    if ((threadIdx.x & 31) == 0) {
      const float last = pr.cum[(cell * q + last_row) * pr.h + hd];
      pr.dcum[(cell * q + last_row) * pr.h + hd] =
          partials(ch, last_row) + rs +
          (live(last) ? pr.ddecay[ch] * clipped_exp(last) : 0.f);
    }
  }
}

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

template <typename T, bool V16>
int launch(const Params& pr, int64_t cells, cudaStream_t st) {
  constexpr int kRing = Ring<T>::kBytes;
  constexpr int kHeads = kRing + kHeadsExtra;
  auto ks = ssd_bwd_scores<T, V16>;
  auto kh = ssd_bwd_heads<T, V16>;
  auto kr = ssd_bwd_reduce<T, V16>;
  cudaError_t e = cudaFuncSetAttribute(
      ks, cudaFuncAttributeMaxDynamicSharedMemorySize, kRing);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kh, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kHeads);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kr, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kRing);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t cg = cells * pr.g;
  ks<<<static_cast<unsigned int>(cg * pr.pairs), kThreads, kRing, st>>>(pr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  kh<<<static_cast<unsigned int>(cg * pr.heads_roles), kThreads, kHeads,
       st>>>(pr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  kr<<<static_cast<unsigned int>(cg * pr.reduce_roles), kThreads, kRing,
       st>>>(pr);
  return static_cast<int>(cudaGetLastError());
}

// blocks a (cell, group) in the heads and reduce launches
int64_t heads_roles(int64_t q_tiles, int64_t rep, int64_t hs) {
  return rep / hs * (q_tiles + q_tiles * (q_tiles + 1) / 2) + rep * q_tiles;
}
int64_t reduce_roles(int64_t q_tiles, int64_t n) {
  return q_tiles * ((n + kTile - 1) / kTile) * 2;
}

bool valid_shape(int64_t cells, int64_t q, int64_t h, int64_t g, int64_t n,
                 int64_t p, int64_t hs) {
  if (cells < 1 || q < 1 || n < 1 || p < 1 || g < 1 || h % g != 0 ||
      hs < 1 || hs > kMaxHs || (h / g) % hs != 0 || q > kMaxQ ||
      q * h * p > 2147483647LL || h * p * n > 2147483647LL) {
    return false;
  }
  const int64_t q_tiles = (q + kTile - 1) / kTile;
  const int64_t hr = heads_roles(q_tiles, h / g, hs);
  const int64_t rr = reduce_roles(q_tiles, n);
  return cells * g <= 2147483647LL / (hr > rr ? hr : rr);   // 1-D grids
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
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
// 16-byte aligned. hs heads per subset (hs divides h / g, at most 16).
// Tiles are copied by cp.async where every pointer and stride of b, c,
// xdt, dy and dstate is a multiple of 16 bytes, else by plain loads
// (ssd_chunk.py _bwd_vec16). Launches three kernels on `stream`, allocates
// nothing, returns cudaGetLastError() (or cudaErrorInvalidValue for a
// shape it refuses).
extern "C" int repro_ssd_grouped_bwd(
    const void* cum, const void* b, const void* c, const void* xdt,
    const void* dy, const void* dstate, const void* ddecay, void* dcum,
    void* db, void* dc, void* dxdt, void* work, int64_t bz, int64_t nc,
    int64_t q, int64_t h, int64_t g, int64_t n, int64_t p, int64_t sb0,
    int64_t sb1, int64_t sb2, int64_t sb3, int64_t sc0, int64_t sc1,
    int64_t sc2, int64_t sc3, int64_t hs, int dtype, void* stream) {
  const int64_t cells = bz * nc;
  if (!valid_shape(cells, q, h, g, n, p, hs) || !aligned16(work)) {
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
  pr.n_tiles = static_cast<int>((n + kTile - 1) / kTile);
  pr.p_tiles = static_cast<int>((p + kTile - 1) / kTile);
  pr.heads_roles = static_cast<int>(heads_roles(q_tiles, h / g, hs));
  pr.reduce_roles = static_cast<int>(reduce_roles(q_tiles, n));
  // the staging variant: every tile row of b, c, xdt, dy and dstate on 16
  // bytes (ssd_chunk.py _bwd_vec16 is the same predicate)
  const int64_t esz = dtype == 1 ? 2 : 4;
  bool v16 = aligned16(b) && aligned16(c) && aligned16(xdt) &&
             aligned16(dy) && aligned16(dstate) && (p * esz) % 16 == 0 &&
             (n * 4) % 16 == 0;
  for (int i = 0; i < 4; ++i) {
    v16 = v16 && (pr.sb[i] * esz) % 16 == 0 && (pr.sc[i] * esz) % 16 == 0;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return v16 ? launch<__nv_bfloat16, true>(pr, cells, st)
               : launch<__nv_bfloat16, false>(pr, cells, st);
  }
  return v16 ? launch<float, true>(pr, cells, st)
             : launch<float, false>(pr, cells, st);
}
