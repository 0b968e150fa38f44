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

// The largest divisor of n that is at most cap
constexpr int divisor_upto(int n, int cap) {
  return cap <= 1 ? 1 : n % cap == 0 ? cap : divisor_upto(n, cap - 1);
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
  static constexpr int kGroup = divisor_upto(kOt, 8);   // f32 P V B frags
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

using tc::ldsm_x4_trans;
using tc::mma_bf16;
using tc::split_bf16;

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
// (Q K^T, dO V^T, P^T dO, dS K, dS^T Q), 14 D as run here (the dQ pass
// recomputes S and dP). In f32 every product is three TF32 passes on the
// tensor cores (495 / 3 TFLOP/s): smollm-135m's 18 x 4,096 x 64 causal rows
// are 0.59 ms at 10 D, 0.82 ms at 14 D; on the CUDA cores (67 TFLOP/s) 1.4
// and 2.0 ms. The bytes (8 rows x T x D read or written) are far below.
//
// Design: FlashAttention-2's backward with mma.sync, as the forward (above)
// runs its two products. No float atomics: two passes, each output written
// by one block, so repeated calls are bit-identical.
// - Pass 1, dQ: a block owns one (bh, query tile), each warp 16 rows: 4
//   warps and 64 rows, or 8 warps and 128 rows (two plan tiles) in f32 from
//   D = 80 up, where one block fills the shared memory and 4 warps would
//   leave each scheduler one warp (hubert's row ran 2.11 ms so, 1.64 with
//   8 warps; H100 80GB HBM3, 700 W). Q and dO are staged once; K and V
//   tiles of 64 keys (32 in the 8-warp blocks) come through a 2-stage
//   cp.async ring, in the input dtype. Per key tile,
//   S = Q K^T and dP = dO V^T are the forward's Q K^T (A from the staged
//   rows, B as 8-byte loads along D); dS = P o (dP - D) scale stays in its
//   accumulator fragment and is the A fragment of dQ += dS K, the
//   forward's P V with K in V's place (B read down the rows). The pass
//   also writes D (each lane's columns of dO o O, then the row's quad of
//   lanes, one fixed order) for pass 2. Query tiles run heaviest first.
// - Pass 2, dK and dV, in transposed form: a block owns one (bh, key
//   tile), each warp 16 keys, as many warps as pass 1. K and V are staged
//   once and are the A rows of S^T = K Q^T and dP^T = V dO^T; Q, dO and
//   the query tile's lse and D stream through the ring (tiles of 64
//   queries; 32 in the 8-warp blocks and in bf16 above D = 80, where the
//   running dK and dV take 128 registers a lane). P^T and dS^T stay in
//   their accumulator fragments and are the A fragments of dV += P^T dO
//   and dK += dS^T Q; no P or dS goes through shared memory. Pass 2 (and
//   bf16's pass 1 at D = 80) runs at up to 255 registers with 4-68 bytes
//   spilled (ptxas); zeroed groups of 4 n tiles in place of 8 left the
//   spills and ran up to 10% slower.
// - Precision. f32: every product in 3xTF32 (tensor_core.cuh). The mma's
//   f32 accumulate truncates, so every sum that runs over many tiles (dQ
//   over key tiles, dK and dV over query tiles) takes each tile's product
//   from a zeroed accumulator, a group of n tiles at a time, and adds it
//   in on the CUDA cores (as the forward's P V does: over a 4,096-key
//   band the mma's own accumulation drifted past 3e-5). bf16: Q K^T and
//   dO V^T (and their transposes) are one bf16 m16n8k16 mma each; P^T,
//   dS^T and dS are split into bf16 hi + lo, two mmas against the exact
//   bf16 operand. Softmax, D and sums are f32.
// - One tile, two reads. K in pass 1, and Q and dO in pass 2, are read both
//   along D (8-byte loads: a phase of 16 lanes reads 4 rows at 4 offsets)
//   and down the rows (f32: 4-byte loads from rows 2t and 2t + 1; bf16:
//   ldmatrix.trans over 8 rows). No row pitch is conflict-free for both
//   (along D wants rows 32 mod 128 bytes apart, down the rows 16 mod 64),
//   and staging twice would cost a third more shared memory. So rows are
//   padded to a multiple of 128 bytes and the 16-byte chunks of row r are
//   XOR-swizzled by s(r) in {0..7} (r mod 8): f32 s = 2 ((r ^ r / 4) mod 4)
//   puts rows 0-3, 4-7, the even and the odd rows each on four distinct
//   chunk pairs; bf16 s = 2 (r mod 4) + (r / 4 mod 2) puts rows 0-7 on
//   eight distinct chunks (ldmatrix) and rows 0-3 and 4-7 on distinct
//   pairs. Every fragment load of both passes is then conflict-free.
// - Masks only on the band's edge: pass 1 walks band_plan's key tiles
//   [lo, hi) and pass 2 band_plan_t's query tiles (both at 64 x 64,
//   swa_attention.py; a block over two plan tiles walks their union and
//   leaves unmasked only the tiles interior to both); the tiles in
//   [ilo, ihi) hold allowed pairs only and run with no mask, the rest
//   mask to -inf before the exp2. A row (key) that no key (query) sees
//   gets zero gradients.
// - Ragged T, S and D are zero-filled in shared memory, never in device
//   memory; planes whose rows or base are not 16-byte aligned are staged
//   by plain loads.
// Shared memory per block (pass 1 | pass 2), f32: D <= 32 49,152 | 50,176
// B; 64 98,304 | 99,328 (two blocks an SM); 80 147,456 | 147,968; 112 and
// 128 196,608 | 197,120 (one 8-warp block). bf16: 32 and 64 49,152 |
// 50,176; 80 98,304 | 99,328; 112 and 128 98,304 | 66,048.

namespace {

constexpr int kBwdRows = 64;      // plan tiles: query rows and keys

template <typename T, int DP>
struct BwdCfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  // f32 from D = 80 up: blocks of 8 warps over two plan tiles, so that two
  // warps share each scheduler in the shared memory one block takes
  static constexpr bool kWide = kF32 && DP >= 80;
  static constexpr int kWarps = kWide ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBlk = 16 * kWarps;   // query rows / keys a block
  static constexpr int kPlans = kBlk / kBwdRows;     // plan tiles a block
  static constexpr int kBc = kWide ? 32 : 64;        // keys a pass-1 tile
  // queries a pass-2 tile
  static constexpr int kBq = kWide || DP > 80 ? 32 : 64;
  static constexpr int kSub1 = kBwdRows / kBc;       // sub-tiles a plan tile
  static constexpr int kSub2 = kBwdRows / kBq;
  static constexpr int kRow = DP * static_cast<int>(sizeof(T));   // bytes
  static constexpr int kLd = (kRow + 127) / 128 * 128;  // swizzled pitch
  static constexpr int kSteps = kRow / 32;   // k steps along D (k8 / k16)
  static constexpr int kDt = DP / 8;         // n tiles over D
  // f32 partials: n tiles per zeroed group (pass 2 at D = 128 holds 128
  // registers of running sums)
  static constexpr int kGroup1 = divisor_upto(kDt, 8);
  static constexpr int kGroup2 = divisor_upto(kDt, DP == 128 ? 4 : 8);
  static constexpr int kTile = kBlk * kLd;
  static constexpr int kStage1 = 2 * kBc * kLd;                // K, V
  static constexpr int kStage2 = 2 * kBq * kLd + 2 * kBq * 4;  // Q, dO, lse, D
  static constexpr int kSmem1 = 2 * kTile + 2 * kStage1;
  static constexpr int kSmem2 = 2 * kTile + 2 * kStage2;
  static_assert(DP % 16 == 0 && kRow % 32 == 0, "DP: a multiple of 16");
  static_assert(kStage2 % 128 == 0, "stage alignment");
  static_assert(kSmem1 <= 232448 && kSmem2 <= 232448, "shared memory");
};

// The XOR swizzle of row r's 16-byte chunks (see the design note)
template <typename T>
__device__ __forceinline__ int swz(int r) {
  r &= 7;
  if constexpr (sizeof(T) == 4) return 2 * ((r ^ (r >> 2)) & 3);
  else return ((r & 3) << 1) | (r >> 2);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

// Stage rows [r0, r0 + rows) of an (n, d) plane into a swizzled tile of
// pitch kLd; rows >= n and columns >= d are 0. With `async` (row pitch and
// base 16-byte aligned) by 16-byte cp.async, else by plain loads.
template <typename T, int DP, int kRows, int kThreads>
__device__ __forceinline__ void stage_sw(unsigned char* dst, const T* src,
                                         int64_t r0, int64_t n, int d,
                                         bool async) {
  constexpr int kLd = BwdCfg<T, DP>::kLd;
  const int64_t left = n - r0;
  const int rv = left <= 0 ? 0 : left < kRows ? static_cast<int>(left)
                                              : kRows;
  if (async) {
    constexpr int kChunks = DP * static_cast<int>(sizeof(T)) / 16;
    const int bytes = d * static_cast<int>(sizeof(T));
    const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
    for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const int valid = r < rv ? min(max(bytes - 16 * c, 0), 16) : 0;
      const unsigned char* g = valid ? s + (r0 + r) * bytes + 16 * c : s;
      tc::cp_async16(dst + r * kLd + 16 * (c ^ swz<T>(r)), g, valid);
    }
  } else {
    using B = typename Bits<T>::type;
    constexpr int kSize = static_cast<int>(sizeof(T));
    const B* s = reinterpret_cast<const B*>(src);
    for (int i = threadIdx.x; i < kRows * DP; i += kThreads) {
      const int r = i / DP, c = i % DP, b = c * kSize;
      *reinterpret_cast<B*>(dst + r * kLd + 16 * ((b / 16) ^ swz<T>(r)) +
                            b % 16) =
          r < rv && c < d ? s[(r0 + r) * d + c] : B(0);
    }
  }
}

// acc (16 x 8 NT) += A B^T over the head dim: A's rows g and g + 8 at a and
// a + 8 rows, B's rows 8 n + g at b + 8 n rows, both swizzled tiles; offa
// the lane's byte offsets of the four k steps of a 128-byte line
template <typename T, int DP, int NT>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4],
                                         const unsigned char* a,
                                         const unsigned char* b,
                                         const int (&offa)[4]) {
  using C = BwdCfg<T, DP>;
#pragma unroll
  for (int st = 0; st < C::kSteps; ++st) {
    const int off = 128 * (st / 4) + offa[st % 4];
    const uint2 x = lds64(a + off), y = lds64(a + 8 * C::kLd + off);
    const uint32_t af[4] = {x.x, y.x, x.y, y.y};
    if constexpr (C::kF32) {
      uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int e = 0; e < 4; ++e) tc::split(__uint_as_float(af[e]), ah[e],
                                            al[e]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint2 bb = lds64(b + 8 * n * C::kLd + off);
        tc::split(__uint_as_float(bb.x), bh[n][0], bl[n][0]);
        tc::split(__uint_as_float(bb.y), bh[n][1], bl[n][1]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) tc::mma(acc[n], al, bh[n]);
#pragma unroll
      for (int n = 0; n < NT; ++n) tc::mma(acc[n], ah, bl[n]);
#pragma unroll
      for (int n = 0; n < NT; ++n) tc::mma(acc[n], ah, bh[n]);
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint2 bb = lds64(b + 8 * n * C::kLd + off);
        const uint32_t bf[2] = {bb.x, bb.y};
        mma_bf16(acc[n], af, bf);
      }
    }
  }
}

// f32: out (16 x DP) += P B over P's 8 KT columns, P an accumulator
// fragment (16 x 8 KT) and B's rows read down: b at the lane's row 2t of
// the tile, offb0 / offb1 the lane's offsets in rows 2t / 2t + 1. Each
// group of kGroup n tiles sums into a zeroed accumulator first.
template <int DP, int KT, int kGroup>
__device__ __forceinline__ void mma_acc_f32(float (&out)[DP / 8][4],
                                            const float (&p)[KT][4],
                                            const unsigned char* b,
                                            const int (&offb0)[4],
                                            const int (&offb1)[4]) {
  constexpr int kLd = BwdCfg<float, DP>::kLd;
#pragma unroll
  for (int n0 = 0; n0 < DP / 8; n0 += kGroup) {
    float acc[kGroup][4];
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
    for (int k8 = 0; k8 < KT; ++k8) {
      // rows 8 k8 + {2 t, 2 t + 1}: P's columns as the accumulator has them
      const float pa[4] = {p[k8][0], p[k8][2], p[k8][1], p[k8][3]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) tc::split(pa[e], ah[e], al[e]);
      const unsigned char* r0 = b + 8 * k8 * kLd;
      uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int n = n0 + i, line = 128 * (n / 4);
        tc::split(__uint_as_float(lds32(r0 + line + offb0[n % 4])), bh[i][0],
                  bl[i][0]);
        tc::split(__uint_as_float(lds32(r0 + kLd + line + offb1[n % 4])),
                  bh[i][1], bl[i][1]);
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) tc::mma(acc[i], al, bh[i]);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) tc::mma(acc[i], ah, bl[i]);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) tc::mma(acc[i], ah, bh[i]);
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[n0 + i][e] += acc[i][e];
  }
}

// bf16: out (16 x DP) += P B, P an accumulator fragment (16 x 8 KT) split
// into bf16 hi + lo, B's rows by ldmatrix.trans: b at the lane's
// ldmatrix row of the tile, offl its offsets in a 128-byte line
template <int DP, int KT>
__device__ __forceinline__ void mma_acc_bf16(float (&out)[DP / 8][4],
                                             const float (&p)[KT][4],
                                             const unsigned char* b,
                                             const int (&offl)[4]) {
  constexpr int kLd = BwdCfg<__nv_bfloat16, DP>::kLd;
#pragma unroll
  for (int k16 = 0; k16 < KT / 2; ++k16) {
    uint32_t ah[4], al[4];
    split_bf16(p[2 * k16][0], p[2 * k16][1], ah[0], al[0]);
    split_bf16(p[2 * k16][2], p[2 * k16][3], ah[1], al[1]);
    split_bf16(p[2 * k16 + 1][0], p[2 * k16 + 1][1], ah[2], al[2]);
    split_bf16(p[2 * k16 + 1][2], p[2 * k16 + 1][3], ah[3], al[3]);
#pragma unroll
    for (int np = 0; np < DP / 16; ++np) {
      uint32_t bb[4];
      ldsm_x4_trans(bb, b + 16 * k16 * kLd + 128 * (np / 4) + offl[np % 4]);
      const uint32_t b0[2] = {bb[0], bb[1]}, b1[2] = {bb[2], bb[3]};
      mma_bf16(out[2 * np], al, b0);
      mma_bf16(out[2 * np + 1], al, b1);
      mma_bf16(out[2 * np], ah, b0);
      mma_bf16(out[2 * np + 1], ah, b1);
    }
  }
}

// The lane's swizzled offsets: offa for 8-byte loads along D (rows g),
// offb0 / offb1 for f32's 4-byte loads down rows 2t / 2t + 1, offl for
// bf16's ldmatrix rows
template <typename T>
struct LaneOffsets {
  int a[4], b0[4], b1[4], l[4];
  __device__ __forceinline__ LaneOffsets(int lane) {
    const int g = lane / 4, tq = lane % 4;
    const int sa = swz<T>(g), s0 = swz<T>(2 * tq), s1 = swz<T>(2 * tq + 1),
              sl = swz<T>(lane & 7);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = 16 * ((2 * i + (tq >> 1)) ^ sa) + 8 * (tq & 1);
      b0[i] = 16 * ((2 * i + (g >> 2)) ^ s0) + 4 * (g & 3);
      b1[i] = 16 * ((2 * i + (g >> 2)) ^ s1) + 4 * (g & 3);
      l[i] = 16 * ((2 * i + (lane >> 4)) ^ sl);
    }
  }
};

// A block's walk over its kPlans plan tiles (first, first + 1, ...; those
// at or past `count` hold only rows past T or keys past S, which are never
// stored), in sub-tiles of 64 / sub: [lo, hi) the union of their visits,
// [ilo, ihi) the tiles interior to every one (empty where one visits
// nothing: its rows or keys see no pair)
template <int kPlans>
__device__ __forceinline__ int4 block_plan(const int4* plan, int first,
                                           int count, int sub) {
  int lo = 0x7fffffff, hi = 0, ilo = 0, ihi = 0x7fffffff;
#pragma unroll
  for (int p = 0; p < kPlans; ++p) {
    if (first + p >= count) break;
    const int4 e = plan[first + p];
    if (e.x < e.w) {
      lo = min(lo, e.x);
      hi = max(hi, e.w);
    }
    ilo = max(ilo, e.y);
    ihi = min(ihi, e.z);
  }
  if (lo >= hi) return make_int4(0, 0, 0, 0);
  return make_int4(lo * sub, ilo * sub, max(ilo, ihi) * sub, hi * sub);
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
  const int4* plan_k;   // per key tile (lo, ilo, ihi, hi) in query tiles
  int64_t bh, t, s, window;
  int d, causal;
  float scale;
  bool async;
};

__device__ __forceinline__ bool allowed(const BwdArgs& a, int64_t qi,
                                        int64_t kj) {
  return qi < a.t && kj < a.s && (!a.causal || kj <= qi) &&
         (a.window < 0 || kj > qi - a.window);
}

// A lane's rows row0 and row0 + 8 of an (n, d) output, columns 8 n + 2 t
// + {0, 1}
template <typename T, int DP>
__device__ __forceinline__ void store_frag(T* dst, int64_t row0, int64_t n,
                                           int d, int tq,
                                           const float (&acc)[DP / 8][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = row0 + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * nt + 2 * tq + c;
        if (col < d) store(&dst[row * d + col], acc[nt][2 * r + c]);
      }
  }
}

// Pass 1: D, then dQ, per (bh, query tile)
template <typename T, int DP>
__global__ void __launch_bounds__(BwdCfg<T, DP>::kThreads)
swa_bwd_dq_kernel(BwdArgs a, int q_tiles, int plans) {
  using C = BwdCfg<T, DP>;
  constexpr int kSt = C::kBc / 8;
  extern __shared__ __align__(128) unsigned char smem_bwd[];
  unsigned char* qs = smem_bwd;
  unsigned char* dos = qs + C::kTile;
  unsigned char* ring = dos + C::kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  // heaviest query tiles first, across the heads
  const int64_t bh = blockIdx.x % a.bh;
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x / a.bh);
  const int4 pl = block_plan<C::kPlans>(a.plan_q, qt * C::kPlans, plans,
                                        C::kSub1);
  const int lo = pl.x, ilo = pl.y, ihi = pl.z, hi = pl.w;
  const int64_t t = a.t, s = a.s;
  const int d = a.d;
  const int64_t q0 = static_cast<int64_t>(qt) * C::kBlk;
  const T* qg = static_cast<const T*>(a.q) + bh * t * d;
  const T* og = static_cast<const T*>(a.o) + bh * t * d;
  const T* dog = static_cast<const T*>(a.dout) + bh * t * d;
  const T* kg = static_cast<const T*>(a.k) + bh * s * d;
  const T* vg = static_cast<const T*>(a.v) + bh * s * d;

  auto stage_kv = [&](int j) {
    unsigned char* st = ring + ((j - lo) % 2) * C::kStage1;
    const int64_t k0 = static_cast<int64_t>(j) * C::kBc;
    stage_sw<T, DP, C::kBc, C::kThreads>(st, kg, k0, s, d, a.async);
    stage_sw<T, DP, C::kBc, C::kThreads>(st + C::kBc * C::kLd, vg, k0, s, d,
                                         a.async);
  };
  if (lo < hi) {
    stage_sw<T, DP, C::kBlk, C::kThreads>(qs, qg, q0, t, d, a.async);
    stage_sw<T, DP, C::kBlk, C::kThreads>(dos, dog, q0, t, d, a.async);
    stage_kv(lo);
  }
  tc::cp_commit();

  // this lane's rows of the warp's 16: row0 and row0 + 8. D over the
  // lane's columns 8 i + 2 t + {0, 1}, then the row's quad, one order
  const int64_t row0 = q0 + 16 * warp + g;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t qi = row0 + 8 * r;
    float acc = 0.f;
    if (qi < t) {
#pragma unroll
      for (int i = 0; i < DP / 8; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * i + 2 * tq + c;
          if (col < d) acc = fmaf(to_f32(dog[qi * d + col]),
                                  to_f32(og[qi * d + col]), acc);
        }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[r] = acc;
    lse2[r] = qi < t ? a.lse[bh * t + qi] * kLog2e : 0.f;
    if (tq == 0 && qi < t) a.delta[bh * t + qi] = acc;
  }
  const float scale2 = a.scale * kLog2e;

  const LaneOffsets<T> off(lane);
  const unsigned char* qw = qs + (16 * warp + g) * C::kLd;
  const unsigned char* dw = dos + (16 * warp + g) * C::kLd;
  const int rl = (lane & 7) + 8 * ((lane >> 3) & 1);   // ldmatrix row
  float dq[C::kDt][4];
#pragma unroll
  for (int n = 0; n < C::kDt; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int j = lo; j < hi; ++j) {
    tc::cp_wait<0>();
    __syncthreads();    // tile j is in; every warp is done with j - 1
    if (j + 1 < hi) stage_kv(j + 1);
    tc::cp_commit();
    const unsigned char* ks = ring + ((j - lo) % 2) * C::kStage1;
    const unsigned char* vs = ks + C::kBc * C::kLd;

    // S = Q K^T, dP = dO V^T: sc[n][e] is row row0 + 8 (e / 2), key
    // k0 + 8 n + 2 t + e % 2
    float sc[kSt][4], dp[kSt][4];
#pragma unroll
    for (int n = 0; n < kSt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
    mma_rows<T, DP, kSt>(sc, qw, ks + g * C::kLd, off.a);
    mma_rows<T, DP, kSt>(dp, dw, vs + g * C::kLd, off.a);
    if (j < ilo || j >= ihi) {
      const int64_t k0 = static_cast<int64_t>(j) * C::kBc;
#pragma unroll
      for (int n = 0; n < kSt; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!allowed(a, row0 + 8 * (e >> 1), k0 + 8 * n + 2 * tq + (e & 1)))
            sc[n][e] = __int_as_float(0xff800000);   // -inf
    }
    // dS = P o (dP - D) scale, in dp's registers
#pragma unroll
    for (int n = 0; n < kSt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(sc[n][e], scale2, -lse2[e >> 1]));
        dp[n][e] = p * (dp[n][e] - dl[e >> 1]) * a.scale;
      }
    // dQ += dS K
    if constexpr (C::kF32) {
      mma_acc_f32<DP, kSt, C::kGroup1>(dq, dp, ks + 2 * tq * C::kLd, off.b0,
                                       off.b1);
    } else {
      mma_acc_bf16<DP, kSt>(dq, dp, ks + rl * C::kLd, off.l);
    }
  }
  store_frag<T, DP>(static_cast<T*>(a.dq) + bh * t * d, row0, t, d, tq, dq);
}

// Pass 2: dK and dV per (bh, key tile)
template <typename T, int DP>
__global__ void __launch_bounds__(BwdCfg<T, DP>::kThreads)
swa_bwd_dkdv_kernel(BwdArgs a, int plans) {
  using C = BwdCfg<T, DP>;
  constexpr int kQt = C::kBq / 8;
  extern __shared__ __align__(128) unsigned char smem_bwd[];
  unsigned char* ks = smem_bwd;
  unsigned char* vs = ks + C::kTile;
  unsigned char* ring = vs + C::kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  // key tile 0 first: the heaviest where causal
  const int64_t bh = blockIdx.x % a.bh;
  const int kt = static_cast<int>(blockIdx.x / a.bh);
  const int4 pl = block_plan<C::kPlans>(a.plan_k, kt * C::kPlans, plans,
                                        C::kSub2);
  const int lo = pl.x, ilo = pl.y, ihi = pl.z, hi = pl.w;
  const int64_t t = a.t, s = a.s;
  const int d = a.d;
  const int64_t k0 = static_cast<int64_t>(kt) * C::kBlk;
  const T* qg = static_cast<const T*>(a.q) + bh * t * d;
  const T* dog = static_cast<const T*>(a.dout) + bh * t * d;
  const T* kg = static_cast<const T*>(a.k) + bh * s * d;
  const T* vg = static_cast<const T*>(a.v) + bh * s * d;
  const float* lseg = a.lse + bh * t;
  const float* delg = a.delta + bh * t;

  auto stage_q = [&](int i) {
    unsigned char* st = ring + ((i - lo) % 2) * C::kStage2;
    const int64_t q0 = static_cast<int64_t>(i) * C::kBq;
    stage_sw<T, DP, C::kBq, C::kThreads>(st, qg, q0, t, d, a.async);
    stage_sw<T, DP, C::kBq, C::kThreads>(st + C::kBq * C::kLd, dog, q0, t, d,
                                         a.async);
    float* ls = reinterpret_cast<float*>(st + 2 * C::kBq * C::kLd);
    for (int r = threadIdx.x; r < 2 * C::kBq; r += C::kThreads) {
      const int64_t qi = q0 + r % C::kBq;
      const float* src = r < C::kBq ? lseg : delg;
      cp_async4(ls + r, qi < t ? src + qi : src, qi < t ? 4 : 0);
    }
  };
  if (lo < hi) {
    stage_sw<T, DP, C::kBlk, C::kThreads>(ks, kg, k0, s, d, a.async);
    stage_sw<T, DP, C::kBlk, C::kThreads>(vs, vg, k0, s, d, a.async);
    stage_q(lo);
  }
  tc::cp_commit();

  const LaneOffsets<T> off(lane);
  const unsigned char* kw = ks + (16 * warp + g) * C::kLd;
  const unsigned char* vw = vs + (16 * warp + g) * C::kLd;
  const int rl = (lane & 7) + 8 * ((lane >> 3) & 1);
  // this lane's keys of the warp's 16: key0 and key0 + 8
  const int64_t key0 = k0 + 16 * warp + g;
  const float scale2 = a.scale * kLog2e;
  float dk[C::kDt][4], dv[C::kDt][4];
#pragma unroll
  for (int n = 0; n < C::kDt; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int i = lo; i < hi; ++i) {
    tc::cp_wait<0>();
    __syncthreads();    // tile i is in; every warp is done with i - 1
    if (i + 1 < hi) stage_q(i + 1);
    tc::cp_commit();
    const unsigned char* qs = ring + ((i - lo) % 2) * C::kStage2;
    const unsigned char* dos = qs + C::kBq * C::kLd;
    const float* lse_s = reinterpret_cast<const float*>(dos + C::kBq * C::kLd);
    const float* del_s = lse_s + C::kBq;
    const int64_t q0 = static_cast<int64_t>(i) * C::kBq;

    // S^T = K Q^T, dP^T = V dO^T: pt[n][e] is key key0 + 8 (e / 2), query
    // q0 + 8 n + 2 t + e % 2
    float pt[kQt][4], dpt[kQt][4];
#pragma unroll
    for (int n = 0; n < kQt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pt[n][e] = dpt[n][e] = 0.f;
    mma_rows<T, DP, kQt>(pt, kw, qs + g * C::kLd, off.a);
    mma_rows<T, DP, kQt>(dpt, vw, dos + g * C::kLd, off.a);
    if (i < ilo || i >= ihi) {
#pragma unroll
      for (int n = 0; n < kQt; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!allowed(a, q0 + 8 * n + 2 * tq + (e & 1), key0 + 8 * (e >> 1)))
            pt[n][e] = __int_as_float(0xff800000);   // -inf
    }
    // P^T in pt's registers, dS^T = P^T o (dP^T - D) scale in dpt's
#pragma unroll
    for (int n = 0; n < kQt; ++n) {
      const float2 lq = *reinterpret_cast<const float2*>(lse_s + 8 * n +
                                                         2 * tq);
      const float2 dlq = *reinterpret_cast<const float2*>(del_s + 8 * n +
                                                          2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lv = (e & 1) ? lq.y : lq.x, dl = (e & 1) ? dlq.y : dlq.x;
        const float p = exp2f(fmaf(pt[n][e], scale2, -lv * kLog2e));
        pt[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - dl) * a.scale;
      }
    }
    // dV += P^T dO, dK += dS^T Q
    if constexpr (C::kF32) {
      mma_acc_f32<DP, kQt, C::kGroup2>(dv, pt, dos + 2 * tq * C::kLd, off.b0,
                                       off.b1);
      mma_acc_f32<DP, kQt, C::kGroup2>(dk, dpt, qs + 2 * tq * C::kLd, off.b0,
                                       off.b1);
    } else {
      mma_acc_bf16<DP, kQt>(dv, pt, dos + rl * C::kLd, off.l);
      mma_acc_bf16<DP, kQt>(dk, dpt, qs + rl * C::kLd, off.l);
    }
  }
  store_frag<T, DP>(static_cast<T*>(a.dk) + bh * s * d, key0, s, d, tq, dk);
  store_frag<T, DP>(static_cast<T*>(a.dv) + bh * s * d, key0, s, d, tq, dv);
}

template <typename T, int DP>
int launch_bwd(const BwdArgs& a, cudaStream_t st) {
  using C = BwdCfg<T, DP>;
  const int64_t q_tiles = (a.t + C::kBlk - 1) / C::kBlk;
  const int64_t k_tiles = (a.s + C::kBlk - 1) / C::kBlk;
  const int q_plans = static_cast<int>((a.t + kBwdRows - 1) / kBwdRows);
  const int k_plans = static_cast<int>((a.s + kBwdRows - 1) / kBwdRows);
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
      <<<static_cast<unsigned int>(a.bh * q_tiles), C::kThreads, C::kSmem1,
         st>>>(a, static_cast<int>(q_tiles), q_plans);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  swa_bwd_dkdv_kernel<T, DP>
      <<<static_cast<unsigned int>(a.bh * k_tiles), C::kThreads, C::kSmem2,
         st>>>(a, k_plans);
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
// tiles; plan_k: int32 (ceil(s / 64), 4), per key tile (lo, ilo, ihi, hi)
// in query tiles of 64 (swa_attention.py band_plan_t). d <= 128. Launches
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
      reinterpret_cast<uintptr_t>(plan_k) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int size = dtype == 1 ? 2 : 4;
  const uintptr_t bases =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse),
            static_cast<float*>(delta), dq, dk, dv,
            static_cast<const int4*>(plan_q),
            static_cast<const int4*>(plan_k), bh, t, s, window,
            static_cast<int>(d), causal, scale,
            (d * size) % 16 == 0 && bases % 16 == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch_bwd<__nv_bfloat16>(a, st);
  return dispatch_bwd<float>(a, st);
}
