// Mamba2 SSD intra-chunk part, grouped. Replaces the TPU kernel
// repro/kernels/ssd_chunk.py::ssd_intra_chunk_pallas (body _kernel). For
// each chunk cell (batch b, chunk c) and head h of group g = h / rep, with
// cum_h (Q,) the head's cumulative log-decay and B_g, C_g (Q, N) the
// group's:
//     decay[i, j] = exp(clip(cum_i - cum_j, -60, 0))   where i >= j, else 0
//     y_h         = ((C_g B_g^T) * decay) @ xdt_h           (Q, P)
//     tail[j]     = exp(clip(cum_{Q-1} - cum_j, -60, 0))
//     state_h     = ((B_g * tail)^T @ xdt_h)^T              (P, N) f32
//     chunk_decay = exp(clip(cum_{Q-1}, -60, 0))            f32
// B, C and xdt are f32 or bf16 (one type); y is xdt's type. The
// reference's (G, Q, N) per-head layout is the case H = G = 1.
//
// Layouts: cum (Bz, NC, Q, H) f32 and xdt (Bz, NC, Q, H, P) contiguous;
// B and C (Bz, NC, Q, G, N) strided views (any strides, N contiguous), so
// the conv output is read in place. y (Bz, NC, Q, H, P), state
// (Bz, NC, H, P, N) and decay (Bz, NC, H) are written in the layouts the
// cross-chunk recurrence reads.
//
// Bound on the H100. At mamba2-370m's prefill layer (Bz 8, NC 4, H 32,
// G 1, Q 256, N 128, P 64) the work is 8.94 GFLOP (0.27 of it C B^T, once
// per group; 4.31 the causal half of scores @ xdt; 4.29 the state)
// against 177 MB moved (0.053 ms at 3.35 TB/s). The y products on the
// CUDA cores at 67 TFLOP/s take at least 0.069 ms and the state product
// in 3xTF32 (three passes at 495 TFLOP/s) 0.026 ms: about 0.095 ms.
//
// Design.
// - Which unit runs which product, and why. The state product runs on
//   the tensor cores in 3xTF32: mma.sync.m16n8k8 tf32, each operand split
//   as x = hi + lo (hi = cvt.rna.tf32(x), lo = x - hi passed as its f32
//   bits, which the tensor cores read to TF32), lo*hi + hi*lo + hi*hi
//   per 8-deep step (lo*lo dropped; the helpers are in tensor_core.cuh):
//   about 2^-22 relative error per product. It holds the twin at 3.8e-6
//   (2e-5 allowed). The two y
//   products (C B^T and scores @ xdt) were 3xTF32 too and were closer to
//   an f64 oracle than the f32 twin (2.7e-5 against 4.4e-5 at
//   (8, 64, 128, 64)), but differed from the twin by up to 4.7e-5 at
//   (1024, 256, 128, 64), over its 2e-5: at |y| ~ 30 two f32 summation
//   orders differ by that much. So they run on f32 FMA chains in key
//   order (and n order for C B^T), the order of the twin's batched
//   products, with 8 x 4 register tiles and 16-byte shared loads; y then
//   equals the twin's bit for bit. A single TF32 pass (2^-11) is never
//   used.
// - One C B^T per group, shared by its heads. A y block owns (cell,
//   group, one 64-row query tile, hs heads of the group, one 64-column P
//   tile). It forms its rows of C B^T for the key tiles up to its diagonal
//   once and parks them, transposed, in shared memory (68 KB at Q = 256).
//   Then for each of its heads and key tiles it starts the xdt tile's
//   copy, forms the decayed, masked scores tile (the product rounded
//   before the contraction, as the reference orders it; one exp per
//   unmasked entry, a third of the phase's time) while the copy is in
//   flight, and multiplies.
// - A state block owns (cell, group, hs heads, a 64-column N tile, a P
//   tile). It stages its whole (Q, 64) slab of B once and reuses it for
//   every head; the head's tail is applied to each B element as its
//   fragment is loaded (b * tail rounded before the contraction), and the
//   accumulator comes out as (P, N), the recurrence's layout. Its xdt
//   tiles come through a two-deep cp.async ring.
// - Loads are 16-byte cp.async, zero-filling the ragged edge. Shapes
//   whose strides are not 16-byte multiples take a synchronous
//   element-wise staging loop (a template variant chosen from the
//   strides; mamba2's shapes all take cp.async).
// - Head subset hs = 8 (or the largest divisor of rep <= 8): a y block
//   then spends 2 of every 10 tile-products on C B^T, and at the prefill
//   layer the launch has 512 y blocks and 256 state blocks, about three
//   waves of two 109 KB blocks per SM. Blocks are ordered heaviest first
//   along blockIdx.y (state blocks, then query tiles from the diagonal's
//   far end down), so the light low-qt tiles fill the last wave.
// Every sum runs in one fixed order with no atomics, so repeated calls are
// bit-identical. Ragged Q, N and P are zero-filled and masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd.cuh"
#include "tensor_core.cuh"

namespace {

using ssd::clipped_exp;
using ssd::load4;
using ssd::store;
using ssd::to_f32;
using tc::cp_async16;
using tc::cp_commit;
using tc::cp_wait;
using tc::mma;
using tc::split;

constexpr int kThreads = 128;   // 4 warps
constexpr int kTile = 64;       // query rows, key rows, P and N columns
constexpr int kDepth = 32;      // N columns staged per C B^T step
constexpr int kMaxQ = 512;      // the score rows and the B slab fit

struct Params {
  const float* cum;
  const void* b;
  const void* c;
  const void* xdt;
  void* y;
  float* state;
  float* decay;
  int64_t sb[4];   // B strides in elements: batch, chunk, row, group
  int64_t sc[4];   // C strides
  int nc, q, h, g, n, p, rep, hs, h_sub, q_tiles, n_tiles, p_tiles, q_pad;
};

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
// Row strides in elements such that fragment loads hit 32 distinct banks:
// "A" tiles are read as (row + g) * ld + t, "B" tiles as t * ld + g
// (g = lane / 4, t = lane % 4), so ld is 4 words past a multiple of 32
// for A and 8 words past for B; both keep rows 16-byte aligned.
template <typename T> __host__ __device__ constexpr int ld_a(int cols) {
  return ((cols * static_cast<int>(sizeof(T)) + 127) / 128 * 128 + 16) /
         static_cast<int>(sizeof(T));
}
template <typename T> __host__ __device__ constexpr int ld_b(int cols) {
  return ((cols * static_cast<int>(sizeof(T)) + 127) / 128 * 128 + 32) /
         static_cast<int>(sizeof(T));
}

// The y block's first region: the C/B ring, later the xdt tile and the
// decayed scores tile (row stride kTile + 4)
template <typename T> __host__ __device__ constexpr size_t region1() {
  return 2 * 2 * kTile * ld_a<T>(kDepth) * sizeof(T) >
                 kTile * ld_b<T>(kTile) * sizeof(T) +
                     kTile * (kTile + 4) * sizeof(float)
             ? 2 * 2 * kTile * ld_a<T>(kDepth) * sizeof(T)
             : kTile * ld_b<T>(kTile) * sizeof(T) +
                   kTile * (kTile + 4) * sizeof(float);
}

// Stage a rows x cols tile (cols a multiple of 16 bytes) of src, row
// stride rs, into dst (row stride ld); entries outside rv x cv are 0.
template <typename T, bool V16>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src,
                                      int64_t rs, int rows, int rv, int cols,
                                      int cv) {
  if constexpr (V16) {
    constexpr int E = 16 / sizeof(T);
    const int cpr = cols / E;
    for (int i = threadIdx.x; i < rows * cpr; i += kThreads) {
      const int r = i / cpr, c = (i % cpr) * E;
      const int valid = r < rv ? min(max(cv - c, 0), E) : 0;
      const T* s = valid ? src + r * rs + c : src;
      cp_async16(dst + r * ld + c, s, valid * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i % cols;
      dst[r * ld + c] = r < rv && c < cv ? src[r * rs + c] : zero<T>();
    }
  }
}

// One 8-deep step of a warp's 32 x 32 tile: lo*hi + hi*lo + hi*hi
__device__ __forceinline__ void mma3x(float (&acc)[2][4][4],
                                      const float (&a)[2][4],
                                      const float (&b)[4][2]) {
  uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) split(a[i][e], ah[i][e], al[i][e]);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) split(b[j][e], bh[j][e], bl[j][e]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mma(acc[i][j], al[i], bh[j]);
      mma(acc[i][j], ah[i], bl[j]);
      mma(acc[i][j], ah[i], bh[j]);
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// y block: (cell, group, query tile qt, head subset, P tile). Both of its
// products are f32 FMA chains in key order (see the note at the top). The
// C B^T rows and the decayed scores tile are kept transposed ([key][row])
// so a thread reads its 8 rows with two 16-byte loads. Thread (rg, cg) of
// 8 x 16 owns rows rg * 8 + {0..7} and, in phase 1, keys cg + 16 u
// (u < 4), in phase 2 P columns cg * 4 + {0..3}: 32 FMAs per step, and in
// phase 2 three shared loads per step.
template <typename T, bool V16>
__device__ void y_block(const Params& pr, unsigned char* smem, int64_t cell,
                        int grp, int qt, int hsub, int pt) {
  constexpr int LDA = ld_a<T>(kDepth), LDX = ld_b<T>(kTile);
  constexpr int LDT = kTile + 4;
  T* ring = reinterpret_cast<T*>(smem);           // phase 1: C/B ring
  T* xs = ring;                                   // phase 2: xdt tile
  float* sst = reinterpret_cast<float*>(xs + kTile * LDX);  // scores^T
  float* st = reinterpret_cast<float*>(smem + region1<T>());  // (C B^T)^T
  float* vec = st + pr.q_pad * LDT;               // the head's cum
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int q = pr.q, n = pr.n, p = pr.p, q0 = qt * kTile, p0 = pt * kTile;
  const int64_t bi = cell / pr.nc, ci = cell % pr.nc;
  const T* cgp = static_cast<const T*>(pr.c) + bi * pr.sc[0] +
                 ci * pr.sc[1] + grp * pr.sc[3];
  const T* bgp = static_cast<const T*>(pr.b) + bi * pr.sb[0] +
                 ci * pr.sb[1] + grp * pr.sb[3];
  const int kq = qt + 1;
  float acc[8][4];

  // phase 1: S = C[q0:q0+64] B[0:(qt+1)*64]^T, one FMA chain over n per
  // entry (zero-filled past N), parked transposed in shared memory
  const int nch = (n + kDepth - 1) / kDepth, steps1 = kq * nch;
  auto stage1 = [&](int s) {
    const int kt = s / nch, k0 = (s % nch) * kDepth;
    T* cs = ring + (s & 1) * 2 * kTile * LDA;
    stage<T, V16>(cs, LDA, cgp + q0 * pr.sc[2] + k0, pr.sc[2], kTile,
                  q - q0, kDepth, n - k0);
    stage<T, V16>(cs + kTile * LDA, LDA, bgp + kt * kTile * pr.sb[2] + k0,
                  pr.sb[2], kTile, q - kt * kTile, kDepth, n - k0);
  };
  stage1(0);
  cp_commit();
  for (int s = 0; s < steps1; ++s) {
    if (s + 1 < steps1) {
      stage1(s + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int kt = s / nch, ch = s % nch;
    const T* cs = ring + (s & 1) * 2 * kTile * LDA;
    const T* bs = cs + kTile * LDA;
    if (ch == 0) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[r][u] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float cv[8], bv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) cv[r] = to_f32(cs[(rg * 8 + r) * LDA + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) bv[u] = to_f32(bs[(cg + 16 * u) * LDA + kk]);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[r][u] = fmaf(cv[r], bv[u], acc[r][u]);
    }
    if (ch == nch - 1) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          st[(kt * kTile + cg + 16 * u) * LDT + rg * 8 + r] = acc[r][u];
    }
    __syncthreads();
  }

  // phase 2: for each head, y = (S * decay, masked) @ xdt, one FMA chain
  // over the keys per output. The xdt tile's copy is in flight while the
  // block forms the decayed, masked scores tile.
  const int head0 = grp * pr.rep + hsub * pr.hs;
  const int64_t xrs = static_cast<int64_t>(pr.h) * p;
  const T* xcell = static_cast<const T*>(pr.xdt) + cell * q * xrs + p0;
  for (int s = 0; s < pr.hs * kq; ++s) {
    const int hd = head0 + s / kq, kt = s % kq, j0 = kt * kTile;
    if (s > 0) __syncthreads();        // the last step's tiles are read
    stage<T, V16>(xs, LDX, xcell + j0 * xrs + hd * p, xrs, kTile, q - j0,
                  kTile, p - p0);
    cp_commit();
    if (kt == 0) {
      for (int j = tid; j < kq * kTile; j += kThreads) {
        vec[j] = j < q ? pr.cum[(cell * q + j) * pr.h + hd] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[r][u] = 0.f;
    }
    {
      const int i = tid % kTile;       // each thread keeps one row
      const float ci = vec[q0 + i];
#pragma unroll 8
      for (int j = tid / kTile; j < kTile; j += kThreads / kTile) {
        float v = 0.f;
        if (j0 + j <= q0 + i) {        // masked entries take no exp
          v = st[(j0 + j) * LDT + i] * clipped_exp(ci - vec[j0 + j]);
        }
        sst[j * LDT + i] = v;
      }
    }
    cp_wait<0>();
    __syncthreads();
#pragma unroll 8
    for (int jj = 0; jj < kTile; ++jj) {
      float sv[8], xv[4];
      const float4 s0 = *reinterpret_cast<const float4*>(
          sst + jj * LDT + rg * 8);
      const float4 s1 = *reinterpret_cast<const float4*>(
          sst + jj * LDT + rg * 8 + 4);
      sv[0] = s0.x; sv[1] = s0.y; sv[2] = s0.z; sv[3] = s0.w;
      sv[4] = s1.x; sv[5] = s1.y; sv[6] = s1.z; sv[7] = s1.w;
      load4(xs + jj * LDX + cg * 4, xv);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[r][u] = fmaf(sv[r], xv[u], acc[r][u]);
    }
    if (kt == qt) {
      T* yb = static_cast<T*>(pr.y);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int qi = q0 + rg * 8 + r;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int pp = p0 + cg * 4 + u;
          if (qi < q && pp < p) {
            store(&yb[((cell * q + qi) * pr.h + hd) * p + pp], acc[r][u]);
          }
        }
      }
    }
  }
  __syncthreads();
}

// state block: (cell, group, head subset, N tile, P tile)
template <typename T, bool V16>
__device__ void state_block(const Params& pr, unsigned char* smem,
                            int64_t cell, int grp, int hsub, int nt, int pt) {
  constexpr int LDB = ld_b<T>(kTile);
  T* slab = reinterpret_cast<T*>(smem);                 // [q_pad][LDB]
  T* ring = slab + pr.q_pad * LDB;                      // 2 x [64][LDB]
  float* tl = reinterpret_cast<float*>(ring + 2 * kTile * LDB);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp >> 1, wn = warp & 1, gid = lane >> 2, tig = lane & 3;
  const int q = pr.q, n = pr.n, p = pr.p, n0 = nt * kTile, p0 = pt * kTile;
  const int64_t bi = cell / pr.nc, ci = cell % pr.nc;
  const T* bg = static_cast<const T*>(pr.b) + bi * pr.sb[0] + ci * pr.sb[1] +
                grp * pr.sb[3];
  stage<T, V16>(slab, LDB, bg + n0, pr.sb[2], pr.q_pad, q, kTile, n - n0);
  cp_commit();

  const int qtl = pr.q_tiles, steps = pr.hs * qtl;
  const int head0 = grp * pr.rep + hsub * pr.hs;
  const int64_t xrs = static_cast<int64_t>(pr.h) * p;
  const T* xcell = static_cast<const T*>(pr.xdt) + cell * q * xrs + p0;
  auto stage2 = [&](int s) {
    const int hd = head0 + s / qtl, kt = s % qtl;
    stage<T, V16>(ring + (s & 1) * kTile * LDB, LDB,
                  xcell + kt * kTile * xrs + hd * p, xrs, kTile,
                  q - kt * kTile, kTile, p - p0);
  };
  stage2(0);
  cp_commit();
  float acc[2][4][4];
  for (int s = 0; s < steps; ++s) {
    const int hd = head0 + s / qtl, kt = s % qtl;
    if (s + 1 < steps) {
      stage2(s + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    if (kt == 0) {
      const float last = pr.cum[(cell * q + q - 1) * pr.h + hd];
      for (int j = threadIdx.x; j < pr.q_pad; j += kThreads) {
        tl[j] = j < q ? clipped_exp(last - pr.cum[(cell * q + j) * pr.h + hd])
                      : 0.f;
      }
      if (nt == 0 && pt == 0 && threadIdx.x == 0) {
        pr.decay[cell * pr.h + hd] = clipped_exp(last);
      }
      zero_acc(acc);
    }
    __syncthreads();
    const T* xs = ring + (s & 1) * kTile * LDB;
    const T* bs = slab + kt * kTile * LDB;
    const float* tk = tl + kt * kTile;
#pragma unroll
    for (int kk = 0; kk < kTile; kk += 8) {
      float a[2][4], b[4][2];
      const T* xr = xs + (kk + tig) * LDB + wm * 32 + gid;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i][0] = to_f32(xr[i * 16]);
        a[i][1] = to_f32(xr[i * 16 + 8]);
        a[i][2] = to_f32(xr[4 * LDB + i * 16]);
        a[i][3] = to_f32(xr[4 * LDB + i * 16 + 8]);
      }
      const float t0 = tk[kk + tig], t1 = tk[kk + tig + 4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const T* r = bs + (kk + tig) * LDB + wn * 32 + j * 8 + gid;
        b[j][0] = to_f32(r[0]) * t0;
        b[j][1] = to_f32(r[4 * LDB]) * t1;
      }
      mma3x(acc, a, b);
    }
    if (kt == qtl - 1) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int pp = p0 + wm * 32 + i * 16 + gid + (e >= 2 ? 8 : 0);
            const int nn = n0 + wn * 32 + j * 8 + 2 * tig + (e & 1);
            if (pp < p && nn < n) {
              pr.state[((cell * pr.h + hd) * p + pp) * n + nn] =
                  acc[i][j][e];
            }
          }
    }
    __syncthreads();
  }
}

template <typename T, bool V16>
__global__ void __launch_bounds__(kThreads)
ssd_grouped_kernel(const Params pr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t cell = blockIdx.x / pr.g;
  const int grp = static_cast<int>(blockIdx.x % pr.g);
  int role = blockIdx.y;
  const int n_state = pr.n_tiles * pr.h_sub * pr.p_tiles;
  if (role < n_state) {
    const int pt = role % pr.p_tiles;
    role /= pr.p_tiles;
    state_block<T, V16>(pr, smem, cell, grp, role % pr.h_sub,
                        role / pr.h_sub, pt);
  } else {
    role -= n_state;
    const int pt = role % pr.p_tiles;
    role /= pr.p_tiles;
    const int qt = pr.q_tiles - 1 - role / pr.h_sub;   // heaviest first
    y_block<T, V16>(pr, smem, cell, grp, qt, role % pr.h_sub, pt);
  }
}

template <typename T>
size_t smem_bytes(int q_pad) {
  constexpr int LDB = ld_b<T>(kTile);
  const size_t y = region1<T>() +
                   sizeof(float) * (q_pad * (kTile + 4) + q_pad);
  const size_t st = (q_pad + 2 * kTile) * LDB * sizeof(T) +
                    sizeof(float) * q_pad;
  return y > st ? y : st;
}

template <typename T, bool V16>
int launch(const Params& pr, int64_t cells, cudaStream_t st) {
  const size_t bytes = smem_bytes<T>(pr.q_pad);
  auto kern = ssd_grouped_kernel<T, V16>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int roles = (pr.n_tiles + pr.q_tiles) * pr.h_sub * pr.p_tiles;
  const dim3 grid(static_cast<unsigned int>(cells * pr.g),
                  static_cast<unsigned int>(roles));
  kern<<<grid, kThreads, bytes, st>>>(pr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cum: (bz, nc, q, h) f32; xdt: (bz, nc, q, h, p); b, c: (bz, nc, q, g, n)
// with element strides sb*, sc* (N contiguous); dtype 0 = f32, 1 = bf16
// for b, c, xdt and y. y: (bz, nc, q, h, p); state: (bz, nc, h, p, n) f32;
// decay: (bz, nc, h) f32. hs heads per block (hs divides h / g); vec16 = 1
// when every base pointer and row stride is a multiple of 16 bytes.
// Launches on `stream`, allocates nothing, returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape the grid or shared memory cannot hold).
extern "C" int repro_ssd_grouped(
    const void* cum, const void* b, const void* c, const void* xdt, void* y,
    void* state, void* decay, int64_t bz, int64_t nc, int64_t q, int64_t h,
    int64_t g, int64_t n, int64_t p, int64_t sb0, int64_t sb1, int64_t sb2,
    int64_t sb3, int64_t sc0, int64_t sc1, int64_t sc2, int64_t sc3,
    int64_t hs, int dtype, int vec16, void* stream) {
  const int64_t q_tiles = (q + kTile - 1) / kTile;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  const int64_t p_tiles = (p + kTile - 1) / kTile;
  const int64_t cells = bz * nc;
  if (cells < 1 || g < 1 || h % g != 0 || hs < 1 || (h / g) % hs != 0 ||
      cells * g > 2147483647LL ||
      (n_tiles + q_tiles) * (h / g / hs) * p_tiles > 65535 ||
      q_tiles * kTile > kMaxQ || q * h * p > 2147483647LL ||
      h * p * n > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params pr{};
  pr.cum = static_cast<const float*>(cum);
  pr.b = b;
  pr.c = c;
  pr.xdt = xdt;
  pr.y = y;
  pr.state = static_cast<float*>(state);
  pr.decay = static_cast<float*>(decay);
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
  pr.n_tiles = static_cast<int>(n_tiles);
  pr.p_tiles = static_cast<int>(p_tiles);
  pr.q_pad = static_cast<int>(q_tiles * kTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return vec16 ? launch<__nv_bfloat16, true>(pr, cells, st)
                 : launch<__nv_bfloat16, false>(pr, cells, st);
  }
  return vec16 ? launch<float, true>(pr, cells, st)
               : launch<float, false>(pr, cells, st);
}
