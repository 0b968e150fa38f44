// Sliding-window flash attention, forward. Replaces the TPU kernel
// repro/kernels/swa_attention.py::swa_attention_pallas (body
// _attn_kernel). q (BH, T, D), k and v (BH, S, D), f32 or bf16 (one
// type); out (BH, T, D) in that type. Query t attends to key s where
// s <= t (causal) and s > t - W (a window W >= 0; W < 0 means none):
//     out_t = sum_s softmax_s(scale * q_t . k_s) v_s,  scale = 1/sqrt(D)
// over the allowed keys; a row with no allowed key gives 0.
//
// Bound on the H100, at T = S = 8192, W = 4096, 48 heads of D = 128
// (mixtral-8x22b): 4 D operations per (query, key) pair inside the band,
// 618.5 GFLOP, against 805 MB moved (0.24 ms at 3.35 TB/s). In f32 on the
// CUDA cores that is 9.23 ms at 67 TFLOP/s; in three TF32 passes on the
// tensor cores 3.75 ms at 495 TFLOP/s. So both products run on the tensor
// cores.
//
// Design: FlashAttention-2 with mma.sync.
// - Precision. f32: both products in 3xTF32 (tensor_core.cuh): about
//   2^-22 per product, where one TF32 pass (2^-11) would miss the twin's
//   3e-5. The mma's f32 accumulate truncates, so an O accumulator that
//   ran over the whole band (W = 4096: 1,536 mmas into each element) would
//   drift toward zero by up to ~1e-4 of |O|, past the twin's 3e-5 where
//   the softmax is peaked and |O| near 1 (mixtral's layer-0 inputs, q, k,
//   v of std 1.57; chip_smoke.py moe_serve holds both against f64 there).
//   So each key tile's P V starts from a zeroed accumulator and is added
//   into O on the CUDA cores, rounded as f32 adds. bf16: Q K^T is one
//   bf16 m16n8k16 mma (products of bf16 values are exact in f32); P V
//   splits P into bf16 hi + lo, two mmas, V being exact. Softmax, sums and
//   accumulators are f32.
// - A block owns one (bh, query tile); each warp owns 16 query rows: 8
//   warps and 128 rows at D <= 128, 4 warps and 64 rows above. The S tile
//   and the O accumulator live in mma fragments. The Q tile is staged once
//   into shared memory and read at each k step: its fragments beside O and
//   S would spill registers at f32 D = 112 and 128.
// - A lane reads 8 bytes of each 32-byte k step of a row: the f32 k8
//   step's logical columns (t, t + 4) are its physical (2t, 2t + 1), the
//   bf16 k16 step's (2t, 2t + 1, 2t + 8, 2t + 9) its 4t..4t + 3. Q and K
//   share the permutation, so the dot products are unchanged and a K
//   fragment is one 8-byte load. In f32 P V the keys of a k step are
//   permuted the same way, which makes S's accumulator fragment P's A
//   fragment as it stands; in bf16 the accumulator's pairs pack into it.
//   P never leaves registers; the row max reduces over the row's quad of
//   lanes with two shuffles, and each lane keeps its own part of the row
//   sum until the end (one fixed order).
// - K and V tiles (64 keys at D <= 128, 16 above) come through a 2-stage
//   cp.async ring: tile j + 1 is in flight while j computes, and one
//   __syncthreads() per tile both publishes tile j and frees the stage
//   that tile j + 1 overwrites. Row pitches make the fragment loads
//   conflict-free: K (and Q) rows 32 mod 128 bytes apart for the 8-byte
//   loads (a phase of 16 lanes reads 4 rows), V rows 16 mod 64 bytes
//   apart for f32's 4-byte loads (rows 2t, 2t + 1) and bf16's
//   ldmatrix.trans.
// - Masks only on the band's edge. The wrapper hands the kernel a plan per
//   query tile, (lo, ilo, ihi, hi) in key tiles (swa_attention.py
//   band_plan, tested on the CPU against the band's mask): the block
//   visits [lo, hi), so a query tile costs O(W + 128) and not O(S); tiles
//   in [ilo, ihi) hold allowed pairs only and run with no mask; the
//   others (the window's start, the diagonal, a ragged S) mask to -inf.
//   The running max starts at -1e30, so a masked probability is exactly
//   0 and a row with no key ends at 0.
// - Ragged T, S and D are zero-filled in shared memory (D is padded to
//   the instance's DP), never in device memory. Planes whose
//   row pitch or base is not 16-byte aligned are staged by plain loads.
// - No atomics, one fixed order of every sum: repeated calls are
//   bit-identical. Query tiles run heaviest first within a head.
// Shared memory per block is rows x K pitch + 2 x keys x (K pitch + V
// pitch): f32 206,848 B at D = 128 and 182,272 B at D = 112, bf16
// 108,544 B at D = 128; one block of 8 warps per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegBig = -1e30f;   // the running max before any key

constexpr int divisor_upto8(int n) {
  return n % 8 == 0 ? 8 : n % 7 == 0 ? 7 : n % 6 == 0 ? 6 : 4;
}

// One instance per padded head dim DP (a multiple of 16)
template <typename T, int DP>
struct Cfg {
  static constexpr bool kWide = DP > 128;
  static constexpr int kWarps = kWide ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBq = 16 * kWarps;       // query rows per block
  static constexpr int kBc = kWide ? 16 : 64;   // keys per tile
  static constexpr int kStages = 2;
  static constexpr int kRow = DP * static_cast<int>(sizeof(T));  // bytes
  static constexpr int kSteps = kRow / 32;      // Q K^T k steps
  static constexpr int kLdK = kRow % 64 == 0 ? kRow + 32 : kRow;
  static constexpr int kLdV = kRow + 16;
  static constexpr int kSt = kBc / 8;           // S n tiles
  static constexpr int kOt = DP / 8;            // O n tiles
  static constexpr int kGroup = divisor_upto8(kOt);   // f32 P V B frags
  static constexpr int kStage = kBc * (kLdK + kLdV);
  static constexpr int kSmem = kBq * kLdK + kStages * kStage;
  static_assert(DP % 16 == 0 && kRow % 32 == 0, "DP: a multiple of 16");
  static_assert(kSmem <= 232448, "shared memory");
};

template <typename T> struct Bits;
template <> struct Bits<float> { using type = uint32_t; };
template <> struct Bits<__nv_bfloat16> { using type = uint16_t; };

__device__ __forceinline__ uint2 lds64(const unsigned char* p) {
  return *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8 x 8 b16 matrices, transposed: lane l names row l % 8 of matrix
// l / 8; r[i] is matrix i's fragment
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const unsigned char* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a b, one m16n8k16 bf16 product with f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (x, y) = hi + lo, each a bf16 pair (x in the low half)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Stage rows [r0, r0 + rows) of an (n, d) plane into shared memory (row
// pitch ld bytes, DP columns); rows >= n and columns >= d are 0. With
// `async` (row pitch and base 16-byte aligned) by 16-byte cp.async, else
// by plain loads and stores.
template <typename T, int DP, int kThreads>
__device__ __forceinline__ void stage(unsigned char* dst, int ld,
                                      const T* src, int64_t r0, int rows,
                                      int64_t n, int d, bool async) {
  const int64_t left = n - r0;
  const int rv = left <= 0 ? 0 : left < rows ? static_cast<int>(left) : rows;
  if (async) {
    constexpr int kChunks = DP * static_cast<int>(sizeof(T)) / 16;
    const int bytes = d * static_cast<int>(sizeof(T));
    const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
    for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const int valid = r < rv ? min(max(bytes - 16 * c, 0), 16) : 0;
      const unsigned char* g = valid ? s + (r0 + r) * bytes + 16 * c : s;
      tc::cp_async16(dst + r * ld + 16 * c, g, valid);
    }
  } else {
    using B = typename Bits<T>::type;
    const B* s = reinterpret_cast<const B*>(src);
    for (int i = threadIdx.x; i < rows * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      reinterpret_cast<B*>(dst + r * ld)[c] =
          r < rv && c < d ? s[(r0 + r) * d + c] : B(0);
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;            // (bh, t) f32, or null (serving)
  const int4* plan;
  int64_t bh, t, s, window;
  int d, causal, block_q, block_k;
  float scale;
  bool async;
};

template <typename T, int DP>
__global__ void __launch_bounds__(Cfg<T, DP>::kThreads, 1)
swa_attention_kernel(Args a, int q_tiles) {
  using C = Cfg<T, DP>;
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qs = smem + C::kStages * C::kStage;   // the Q tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int64_t bh = blockIdx.x / q_tiles;
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x % q_tiles);
  const int4 pl = a.plan[qt];              // lo, ilo, ihi, hi
  const int64_t t = a.t, s = a.s, window = a.window;
  const int d = a.d;
  const int64_t q0 = static_cast<int64_t>(qt) * C::kBq;
  const T* qg = static_cast<const T*>(a.q) + bh * t * d;
  const T* kg = static_cast<const T*>(a.k) + bh * s * d;
  const T* vg = static_cast<const T*>(a.v) + bh * s * d;

  auto stage_kv = [&](int j) {
    unsigned char* st = smem + ((j - pl.x) % C::kStages) * C::kStage;
    const int64_t k0 = static_cast<int64_t>(j) * C::kBc;
    stage<T, DP, C::kThreads>(st, C::kLdK, kg, k0, C::kBc, s, d, a.async);
    stage<T, DP, C::kThreads>(st + C::kBc * C::kLdK, C::kLdV, vg, k0,
                              C::kBc, s, d, a.async);
  };
  if (pl.x < pl.w) {
    stage<T, DP, C::kThreads>(qs, C::kLdK, qg, q0, C::kBq, t, d, a.async);
    stage_kv(pl.x);
  }
  tc::cp_commit();

  // this lane's rows of the warp's 16: row0 and row0 + 8
  const int64_t row0 = q0 + 16 * warp + g;
  const unsigned char* qw = qs + (16 * warp + g) * C::kLdK + 8 * tq;

  float o[C::kOt][4];
#pragma unroll
  for (int n = 0; n < C::kOt; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};

  for (int j = pl.x; j < pl.w; ++j) {
    tc::cp_wait<0>();
    __syncthreads();    // tile j is in; every warp is done with j - 1
    if (j + 1 < pl.w) stage_kv(j + 1);
    tc::cp_commit();
    const unsigned char* ks = smem + ((j - pl.x) % C::kStages) * C::kStage;
    const unsigned char* vs = ks + C::kBc * C::kLdK;

    // S = Q K^T: n tile n holds keys 8n..8n+7 of the tile
    float sc[C::kSt][4];
#pragma unroll
    for (int n = 0; n < C::kSt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int st = 0; st < C::kSteps; ++st) {
      const uint2 x = lds64(qw + 32 * st), y = lds64(qw + 32 * st +
                                                     8 * C::kLdK);
      const uint32_t af[4] = {x.x, y.x, x.y, y.y};
      const unsigned char* kp = ks + g * C::kLdK + 32 * st + 8 * tq;
      if constexpr (kF32) {
        uint32_t ah[4], al[4], bh[C::kSt][2], bl[C::kSt][2];
#pragma unroll
        for (int e = 0; e < 4; ++e) tc::split(__uint_as_float(af[e]), ah[e],
                                              al[e]);
#pragma unroll
        for (int n = 0; n < C::kSt; ++n) {
          const uint2 b = lds64(kp + 8 * n * C::kLdK);
          tc::split(__uint_as_float(b.x), bh[n][0], bl[n][0]);
          tc::split(__uint_as_float(b.y), bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < C::kSt; ++n) tc::mma(sc[n], al, bh[n]);
#pragma unroll
        for (int n = 0; n < C::kSt; ++n) tc::mma(sc[n], ah, bl[n]);
#pragma unroll
        for (int n = 0; n < C::kSt; ++n) tc::mma(sc[n], ah, bh[n]);
      } else {
#pragma unroll
        for (int n = 0; n < C::kSt; ++n) {
          const uint2 b = lds64(kp + 8 * n * C::kLdK);
          const uint32_t bf[2] = {b.x, b.y};
          mma_bf16(sc[n], af, bf);
        }
      }
    }

    // scale; mask on the band's edge; online softmax. sc[n][e] is row
    // row0 + 8 (e / 2), key k0 + 8 n + 2 tq + e % 2
#pragma unroll
    for (int n = 0; n < C::kSt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] *= a.scale;
    if (j < pl.y || j >= pl.z) {
      const int64_t k0 = static_cast<int64_t>(j) * C::kBc;
#pragma unroll
      for (int n = 0; n < C::kSt; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t qi = row0 + 8 * (e >> 1);
          const int64_t kj = k0 + 8 * n + 2 * tq + (e & 1);
          const bool ok = kj < s && (!a.causal || kj <= qi) &&
                          (window < 0 || kj > qi - window);
          if (!ok) sc[n][e] = __int_as_float(0xff800000);   // -inf
        }
      }
    }
    float mx[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int n = 0; n < C::kSt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f((m[r] - mn) * kLog2e);
      m[r] = mn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < C::kSt; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((sc[n][e] - m[e >> 1]) * kLog2e);
        sc[n][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < C::kOt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    // O += P V
    if constexpr (kF32) {
      // this tile's P V from a zeroed accumulator, kGroup n tiles at a
      // time, then added into O on the CUDA cores (see Precision)
#pragma unroll
      for (int n0 = 0; n0 < C::kOt; n0 += C::kGroup) {
        float acc[C::kGroup][4];
#pragma unroll
        for (int i = 0; i < C::kGroup; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
        // keys 8 k8 + {2 tq, 2 tq + 1}
#pragma unroll
        for (int k8 = 0; k8 < C::kSt; ++k8) {
          const float pa[4] = {sc[k8][0], sc[k8][2], sc[k8][1], sc[k8][3]};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) tc::split(pa[e], ah[e], al[e]);
          const unsigned char* vp = vs + (8 * k8 + 2 * tq) * C::kLdV + 4 * g;
          uint32_t bh[C::kGroup][2], bl[C::kGroup][2];
#pragma unroll
          for (int i = 0; i < C::kGroup; ++i) {
            const unsigned char* p = vp + 32 * (n0 + i);
            tc::split(__uint_as_float(lds32(p)), bh[i][0], bl[i][0]);
            tc::split(__uint_as_float(lds32(p + C::kLdV)), bh[i][1],
                      bl[i][1]);
          }
#pragma unroll
          for (int i = 0; i < C::kGroup; ++i) tc::mma(acc[i], al, bh[i]);
#pragma unroll
          for (int i = 0; i < C::kGroup; ++i) tc::mma(acc[i], ah, bl[i]);
#pragma unroll
          for (int i = 0; i < C::kGroup; ++i) tc::mma(acc[i], ah, bh[i]);
        }
#pragma unroll
        for (int i = 0; i < C::kGroup; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n0 + i][e] += acc[i][e];
      }
    } else {
      // ldmatrix rows: key 16 k16 + 8 (mat % 2) + lane % 8, columns from
      // 16 np + 8 (mat / 2), mat = lane / 8
      const unsigned char* vl = vs + (8 * ((lane >> 3) & 1) + (lane & 7)) *
                                         C::kLdV + 16 * (lane >> 4);
#pragma unroll
      for (int k16 = 0; k16 < C::kBc / 16; ++k16) {
        uint32_t ah[4], al[4];
        split_bf16(sc[2 * k16][0], sc[2 * k16][1], ah[0], al[0]);
        split_bf16(sc[2 * k16][2], sc[2 * k16][3], ah[1], al[1]);
        split_bf16(sc[2 * k16 + 1][0], sc[2 * k16 + 1][1], ah[2], al[2]);
        split_bf16(sc[2 * k16 + 1][2], sc[2 * k16 + 1][3], ah[3], al[3]);
#pragma unroll
        for (int np = 0; np < C::kOt / 2; ++np) {
          uint32_t b[4];
          ldsm_x4_trans(b, vl + 16 * k16 * C::kLdV + 32 * np);
          const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
          mma_bf16(o[2 * np], al, b0);
          mma_bf16(o[2 * np + 1], al, b1);
          mma_bf16(o[2 * np], ah, b0);
          mma_bf16(o[2 * np + 1], ah, b1);
        }
      }
    }
  }

  T* og = static_cast<T*>(a.out) + bh * t * d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int64_t qi = row0 + 8 * r;
    if (qi >= t) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    // the row's log-sum-exp for the backward: m + log l (a row with no
    // key keeps m = -1e30)
    if (a.lse != nullptr && tq == 0) a.lse[bh * t + qi] = m[r] + logf(denom);
    T* orow = og + qi * d;
#pragma unroll
    for (int n = 0; n < C::kOt; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * n + 2 * tq + c;
        if (col < d) store(&orow[col], o[n][2 * r + c] / denom);
      }
    }
  }
}

template <typename T, int DP>
int launch(const Args& a, cudaStream_t st) {
  using C = Cfg<T, DP>;
  if (a.block_q != C::kBq || a.block_k != C::kBc) {
    return static_cast<int>(cudaErrorInvalidValue);   // plan for other tiles
  }
  const int64_t q_tiles = (a.t + C::kBq - 1) / C::kBq;
  if (a.bh * q_tiles > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      swa_attention_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  swa_attention_kernel<T, DP>
      <<<static_cast<unsigned int>(a.bh * q_tiles), C::kThreads, C::kSmem,
         st>>>(a, static_cast<int>(q_tiles));
  return static_cast<int>(cudaGetLastError());
}

// The padded head dims (swa_attention.py HEAD_DIMS)
template <typename T>
int dispatch(const Args& a, cudaStream_t st) {
  if (a.d <= 32) return launch<T, 32>(a, st);
  if (a.d <= 64) return launch<T, 64>(a, st);
  if (a.d <= 96) return launch<T, 96>(a, st);
  if (a.d <= 112) return launch<T, 112>(a, st);
  if (a.d <= 128) return launch<T, 128>(a, st);
  return launch<T, 256>(a, st);
}

}  // namespace

// q: (bh, t, d); k, v: (bh, s, d); out: (bh, t, d); row-major, dtype
// 0 = f32, 1 = bf16. lse: (bh, t) f32 written with each row's log-sum-exp
// of its scaled logits for the backward, or null (serving: nothing more
// is written and out is unchanged). window < 0 means no window. plan: int32
// (ceil(t / block_q), 4), 16-byte aligned, per query tile (lo, ilo, ihi,
// hi) in key tiles of block_k (swa_attention.py band_plan); block_q and
// block_k must be the instance's tiles for d (swa_attention.py tiles).
// Launches on `stream`, allocates nothing, returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape or plan the kernel does not take).
extern "C" int repro_swa_attention(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int64_t bh,
                                   int64_t t, int64_t s, int64_t d,
                                   int64_t window, int causal, float scale,
                                   int dtype, const void* plan, int block_q,
                                   int block_k, void* stream) {
  if (bh < 1 || t < 1 || s < 1 || d < 1 || d > 256 || block_q < 1 ||
      block_k < 1 || s / block_k >= 2147483647LL ||
      reinterpret_cast<uintptr_t>(plan) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int size = dtype == 1 ? 2 : 4;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  Args a{q, k, v, out, static_cast<float*>(lse),
         static_cast<const int4*>(plan), bh, t, s, window,
         static_cast<int>(d), causal, block_q, block_k, scale,
         (d * size) % 16 == 0 && bases % 16 == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, st);
  return dispatch<float>(a, st);
}

// ---------------------------------------------------------------------------
// Backward. Replaces no TPU kernel: the reference trains attention through
// its plain _flash custom VJP (repro/models/layers.py _flash_bwd), and this
// is that VJP's math by hand. With P = exp(scale q k^T - lse) inside the
// band (0 outside it and in a row with no key), lse the forward's, and
// D_i = rowsum(dO_i o O_i):
//     dV = P^T dO,  dS = P o (dO V^T - D) scale,  dQ = dS K,  dK = dS^T Q.
//
// Bound on the H100: 10 D operations a (query, key) pair inside the band
// (Q K^T, dO V^T, P^T dO, dS K, dS^T Q), 14 D as run here, the dQ pass
// recomputing P and dP; in f32 on the CUDA cores (67 TFLOP/s) that is the
// bound at the models' shapes (smollm-135m's 18 x 4,096 x 64 causal rows:
// 2.0 ms at 14 D, 1.5 at 10 D), against 8 rows x T x D reads and writes.
//
// Design: simple and exact first, f32 FMA chains on the CUDA cores (no
// tensor cores yet). No float atomics: two passes, each output written by
// one block.
// - Pass 1, per (bh, query tile of 64 rows): D for the tile's rows
//   (written to a scratch row for pass 2), then for each key tile the band
//   plan lists (band_plan, the forward's plan at 64 x 64), S and dP over
//   the 64 x 64 pairs, dS into shared memory, dQ += dS K in registers.
// - Pass 2, per (bh, key tile of 64 keys): for each query tile that sees
//   the key tile (band_plan_t, the plan transposed), S and dP again, P and
//   dS into shared memory, dV += P^T dO and dK += dS^T Q in registers.
// - Inputs are converted to f32 as they are staged (bf16 too); the head
//   dim is zero-padded to the instance's DP (32, 64, 80, 112, 128) in
//   shared memory only. Row pitch DP + 1 (odd): the 16 keys a warp reads
//   at one column fall in 16 banks. A thread owns 4 rows x 4 keys of S
//   (rows 4 ty + a, keys tx + 16 b) and 4 rows x DP / 16 columns of its
//   output.
// - Every mask is computed per pair (kj < S, causal, window), so edge tiles
//   need no plan of their own; P is 0 outside the band, so a row (key)
//   with no admitted key (query) gets zero gradients.
// - Fixed order of every sum: repeated calls are bit-identical.
// Shared memory: pass 1 4 x 64 x (DP + 1) + 64 x 65 + 128 floats (149,248
// B at DP = 128), pass 2 the same with a second 64 x 65 tile (165,888 B).

namespace {

constexpr int kBwdRows = 64;      // query rows and keys per tile
constexpr int kBwdThreads = 256;
constexpr int kLdS = kBwdRows + 1;

template <int DP>
struct BwdCfg {
  static constexpr int kLd = DP + 1;
  static constexpr int kCols = DP / 16;   // output columns per thread
  static constexpr int kTile = kBwdRows * kLd;
  static constexpr int kSmem1 =
      static_cast<int>(sizeof(float)) * (4 * kTile + kBwdRows * kLdS +
                                         2 * kBwdRows);
  static constexpr int kSmem2 =
      static_cast<int>(sizeof(float)) * (4 * kTile + 2 * kBwdRows * kLdS +
                                         2 * kBwdRows);
  static_assert(DP % 16 == 0, "DP: a multiple of 16");
  static_assert(kSmem2 <= 232448, "shared memory");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Rows [r0, r0 + 64) of an (n, d) plane into a 64 x DP f32 tile of pitch
// DP + 1; rows >= n and columns >= d are 0
template <typename T, int DP>
__device__ __forceinline__ void stage_f32(float* dst, const T* src,
                                          int64_t r0, int64_t n, int d) {
  for (int i = threadIdx.x; i < kBwdRows * DP; i += kBwdThreads) {
    const int r = i / DP, c = i % DP;
    const int64_t row = r0 + r;
    dst[r * (DP + 1) + c] =
        row < n && c < d ? to_f32(src[row * d + c]) : 0.f;
  }
}

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;         // (bh, t) scratch: pass 1 writes, pass 2 reads
  void* dq;
  void* dk;
  void* dv;
  const int4* plan_q;   // per query tile (lo, ilo, ihi, hi) in key tiles
  const int2* plan_k;   // per key tile (lo, hi) in query tiles
  int64_t bh, t, s, window;
  int d, causal;
  float scale;
};

// P and dS of this thread's 4 x 4 pairs (rows 4 ty + a of the query tile
// at q0, keys tx + 16 b of the key tile at k0): S and dP as FMA chains over
// the head dim in column order, then the mask.
template <int DP>
__device__ __forceinline__ void pairs(const BwdArgs& a, const float* qs,
                                      const float* dos, const float* ks,
                                      const float* vs, const float* lse_s,
                                      const float* delta_s, int64_t q0,
                                      int64_t k0, float (&p)[4][4],
                                      float (&ds)[4][4]) {
  constexpr int kLd = DP + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float sc[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DP; ++c) {
    float qa[4], da[4], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = qs[(4 * ty + i) * kLd + c];
      da[i] = dos[(4 * ty + i) * kLd + c];
      kb[i] = ks[(tx + 16 * i) * kLd + c];
      vb[i] = vs[(tx + 16 * i) * kLd + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
        dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    const int64_t qi = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t kj = k0 + tx + 16 * j;
      const bool ok = qi < a.t && kj < a.s && (!a.causal || kj <= qi) &&
                      (a.window < 0 || kj > qi - a.window);
      const float pr = ok ? expf(sc[i][j] * a.scale - lse_s[r]) : 0.f;
      p[i][j] = pr;
      ds[i][j] = pr * (dp[i][j] - delta_s[r]) * a.scale;
    }
  }
}

// lse and D of the query tile at q0 into shared memory (rows past T: lse
// 0, D 0; their pairs are masked)
__device__ __forceinline__ void stage_rows(const BwdArgs& a, int64_t bh,
                                           int64_t q0, float* lse_s,
                                           float* delta_s) {
  for (int r = threadIdx.x; r < kBwdRows; r += kBwdThreads) {
    const int64_t qi = q0 + r;
    lse_s[r] = qi < a.t ? a.lse[bh * a.t + qi] : 0.f;
    delta_s[r] = qi < a.t ? a.delta[bh * a.t + qi] : 0.f;
  }
}

// A thread's 4 rows x kCols columns (rows 4 ty + i, columns tx + 16 e)
// of an (n, d) output
template <typename T, int kCols>
__device__ __forceinline__ void store_rows(T* dst, int64_t r0, int64_t n,
                                           int d, int ty, int tx,
                                           const float (&acc)[4 * kCols]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = r0 + 4 * ty + i;
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int c = tx + 16 * e;
      if (row < n && c < d) store(&dst[row * d + c], acc[i * kCols + e]);
    }
  }
}

// Pass 1: D, then dQ, per (bh, query tile)
template <typename T, int DP>
__global__ void __launch_bounds__(kBwdThreads, 1)
swa_bwd_dq_kernel(BwdArgs a, int q_tiles) {
  using C = BwdCfg<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + C::kTile;
  float* ks = dos + C::kTile;
  float* vs = ks + C::kTile;
  float* ds_s = vs + C::kTile;
  float* lse_s = ds_s + kBwdRows * kLdS;
  float* delta_s = lse_s + kBwdRows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t bh = blockIdx.x / q_tiles;
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x % q_tiles);
  const int4 pl = a.plan_q[qt];
  const int64_t q0 = static_cast<int64_t>(qt) * kBwdRows;
  const int64_t t = a.t, s = a.s;
  const int d = a.d;
  const T* qg = static_cast<const T*>(a.q) + bh * t * d;
  const T* og = static_cast<const T*>(a.o) + bh * t * d;
  const T* dog = static_cast<const T*>(a.dout) + bh * t * d;
  const T* kg = static_cast<const T*>(a.k) + bh * s * d;
  const T* vg = static_cast<const T*>(a.v) + bh * s * d;

  stage_f32<T, DP>(qs, qg, q0, t, d);
  stage_f32<T, DP>(dos, dog, q0, t, d);
  // D = rowsum(dO o O): a warp per row, lanes over the columns in a fixed
  // order, then a fixed shuffle tree
  for (int r = warp; r < kBwdRows; r += kBwdThreads / 32) {
    const int64_t qi = q0 + r;
    float acc = 0.f;
    if (qi < t) {
      for (int c = lane; c < d; c += 32) {
        acc = fmaf(to_f32(dog[qi * d + c]), to_f32(og[qi * d + c]), acc);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) {
      delta_s[r] = acc;
      if (qi < t) a.delta[bh * t + qi] = acc;
      lse_s[r] = qi < t ? a.lse[bh * t + qi] : 0.f;
    }
  }

  float acc[4 * C::kCols];
#pragma unroll
  for (int i = 0; i < 4 * C::kCols; ++i) acc[i] = 0.f;
  for (int j = pl.x; j < pl.w; ++j) {
    const int64_t k0 = static_cast<int64_t>(j) * kBwdRows;
    __syncthreads();   // every warp is done with the last key tile
    stage_f32<T, DP>(ks, kg, k0, s, d);
    stage_f32<T, DP>(vs, vg, k0, s, d);
    __syncthreads();
    float p[4][4], ds[4][4];
    pairs<DP>(a, qs, dos, ks, vs, lse_s, delta_s, q0, k0, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        ds_s[(4 * ty + i) * kLdS + tx + 16 * jj] = ds[i][jj];
    __syncthreads();
    // dQ += dS K over the tile's keys in order
#pragma unroll 4
    for (int kk = 0; kk < kBwdRows; ++kk) {
      float w[4], kv[C::kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = ds_s[(4 * ty + i) * kLdS + kk];
#pragma unroll
      for (int e = 0; e < C::kCols; ++e) kv[e] = ks[kk * C::kLd + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < C::kCols; ++e)
          acc[i * C::kCols + e] = fmaf(w[i], kv[e], acc[i * C::kCols + e]);
    }
  }
  store_rows<T, C::kCols>(static_cast<T*>(a.dq) + bh * t * d, q0, t, d, ty,
                          tx, acc);
}

// Pass 2: dK and dV per (bh, key tile)
template <typename T, int DP>
__global__ void __launch_bounds__(kBwdThreads, 1)
swa_bwd_dkdv_kernel(BwdArgs a, int k_tiles) {
  using C = BwdCfg<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + C::kTile;
  float* ks = dos + C::kTile;
  float* vs = ks + C::kTile;
  float* p_s = vs + C::kTile;
  float* ds_s = p_s + kBwdRows * kLdS;
  float* lse_s = ds_s + kBwdRows * kLdS;
  float* delta_s = lse_s + kBwdRows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t bh = blockIdx.x / k_tiles;
  const int kt = static_cast<int>(blockIdx.x % k_tiles);
  const int2 pl = a.plan_k[kt];
  const int64_t k0 = static_cast<int64_t>(kt) * kBwdRows;
  const int64_t t = a.t, s = a.s;
  const int d = a.d;
  const T* qg = static_cast<const T*>(a.q) + bh * t * d;
  const T* dog = static_cast<const T*>(a.dout) + bh * t * d;
  const T* kg = static_cast<const T*>(a.k) + bh * s * d;
  const T* vg = static_cast<const T*>(a.v) + bh * s * d;

  stage_f32<T, DP>(ks, kg, k0, s, d);
  stage_f32<T, DP>(vs, vg, k0, s, d);
  float dk[4 * C::kCols], dv[4 * C::kCols];
#pragma unroll
  for (int i = 0; i < 4 * C::kCols; ++i) dk[i] = dv[i] = 0.f;
  for (int i = pl.x; i < pl.y; ++i) {
    const int64_t q0 = static_cast<int64_t>(i) * kBwdRows;
    __syncthreads();   // every warp is done with the last query tile
    stage_f32<T, DP>(qs, qg, q0, t, d);
    stage_f32<T, DP>(dos, dog, q0, t, d);
    stage_rows(a, bh, q0, lse_s, delta_s);
    __syncthreads();
    float p[4][4], ds[4][4];
    pairs<DP>(a, qs, dos, ks, vs, lse_s, delta_s, q0, k0, p, ds);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        p_s[(4 * ty + r) * kLdS + tx + 16 * jj] = p[r][jj];
        ds_s[(4 * ty + r) * kLdS + tx + 16 * jj] = ds[r][jj];
      }
    __syncthreads();
    // this thread's keys 4 ty + c: dV += P^T dO, dK += dS^T Q over the
    // tile's rows in order
#pragma unroll 4
    for (int r = 0; r < kBwdRows; ++r) {
      float pw[4], sw[4], dov[C::kCols], qv[C::kCols];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        pw[c] = p_s[r * kLdS + 4 * ty + c];
        sw[c] = ds_s[r * kLdS + 4 * ty + c];
      }
#pragma unroll
      for (int e = 0; e < C::kCols; ++e) {
        dov[e] = dos[r * C::kLd + tx + 16 * e];
        qv[e] = qs[r * C::kLd + tx + 16 * e];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < C::kCols; ++e) {
          dv[c * C::kCols + e] = fmaf(pw[c], dov[e], dv[c * C::kCols + e]);
          dk[c * C::kCols + e] = fmaf(sw[c], qv[e], dk[c * C::kCols + e]);
        }
    }
  }
  store_rows<T, C::kCols>(static_cast<T*>(a.dk) + bh * s * d, k0, s, d, ty,
                          tx, dk);
  store_rows<T, C::kCols>(static_cast<T*>(a.dv) + bh * s * d, k0, s, d, ty,
                          tx, dv);
}

template <typename T, int DP>
int launch_bwd(const BwdArgs& a, cudaStream_t st) {
  using C = BwdCfg<DP>;
  const int64_t q_tiles = (a.t + kBwdRows - 1) / kBwdRows;
  const int64_t k_tiles = (a.s + kBwdRows - 1) / kBwdRows;
  if (a.bh * q_tiles > 2147483647LL || a.bh * k_tiles > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      swa_bwd_dq_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(swa_bwd_dkdv_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  swa_bwd_dq_kernel<T, DP>
      <<<static_cast<unsigned int>(a.bh * q_tiles), kBwdThreads, C::kSmem1,
         st>>>(a, static_cast<int>(q_tiles));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  swa_bwd_dkdv_kernel<T, DP>
      <<<static_cast<unsigned int>(a.bh * k_tiles), kBwdThreads, C::kSmem2,
         st>>>(a, static_cast<int>(k_tiles));
  return static_cast<int>(cudaGetLastError());
}

// The padded head dims: the ported families' 64, 80, 112 and 128, and 32
// (the reduced configs)
template <typename T>
int dispatch_bwd(const BwdArgs& a, cudaStream_t st) {
  if (a.d <= 32) return launch_bwd<T, 32>(a, st);
  if (a.d <= 64) return launch_bwd<T, 64>(a, st);
  if (a.d <= 80) return launch_bwd<T, 80>(a, st);
  if (a.d <= 112) return launch_bwd<T, 112>(a, st);
  return launch_bwd<T, 128>(a, st);
}

}  // namespace

// The backward of repro_swa_attention. q, o, dout, dq: (bh, t, d); k, v,
// dk, dv: (bh, s, d); row-major, dtype 0 = f32, 1 = bf16 (one dtype for
// all); lse: (bh, t) f32 from the forward; delta: (bh, t) f32 scratch.
// plan_q: int32 (ceil(t / 64), 4), the forward's band plan at 64 x 64
// tiles; plan_k: int32 (ceil(s / 64), 2), per key tile the query tiles
// [lo, hi) that see it (swa_attention.py band_plan_t). d <= 128. Launches
// two kernels on `stream` (dQ, then dK and dV), allocates nothing, returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape the kernels do
// not take).
extern "C" int repro_swa_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int64_t bh, int64_t t, int64_t s, int64_t d, int64_t window,
    int causal, float scale, int dtype, const void* plan_q,
    const void* plan_k, void* stream) {
  if (bh < 1 || t < 1 || s < 1 || d < 1 || d > 128 ||
      reinterpret_cast<uintptr_t>(plan_q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(plan_k) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse),
            static_cast<float*>(delta), dq, dk, dv,
            static_cast<const int4*>(plan_q),
            static_cast<const int2*>(plan_k), bh, t, s, window,
            static_cast<int>(d), causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch_bwd<__nv_bfloat16>(a, st);
  return dispatch_bwd<float>(a, st);
}
