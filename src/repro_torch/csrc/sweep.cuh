// What the two delta-plane sweeps (round_stats.cu, aircomp_sum.cu) share:
// loads as wide as a row pitch allows and a warp's fixed-order sum.
//
// Vec<T, V> holds V consecutive elements of type T (float or bf16) as raw
// 16-, 8-, 4- or 2-byte words, so a thread can issue all its loads before
// it converts and adds any of them. V * sizeof(T) bytes must be a load
// width the address is aligned to: the wrappers pick V from the row pitch
// and the base pointers' alignment. 32 bytes (8 floats) load as two
// 16-byte words.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sweep {

template <int kBytes> struct Word;
template <> struct Word<2> { using type = unsigned short; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };

__device__ __forceinline__ unsigned word32(unsigned w, int) { return w; }
__device__ __forceinline__ unsigned word32(uint2 w, int i) {
  return i == 0 ? w.x : w.y;
}
__device__ __forceinline__ unsigned word32(uint4 w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

template <typename T, int V>
struct Vec {
  static constexpr int kBytes = static_cast<int>(sizeof(T)) * V;
  static constexpr int kWordBytes = kBytes < 16 ? kBytes : 16;
  static constexpr int kWords = kBytes / kWordBytes;
  using W = typename Word<kWordBytes>::type;
  W w[kWords];

  __device__ __forceinline__ void load(const T* p) {
    const W* q = reinterpret_cast<const W*>(p);
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = __ldg(q + i);
  }

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = W{};
  }

  // The V elements as f32 (bf16 widens exactly: it is the top half).
  __device__ __forceinline__ void unpack(float (&out)[V]) const {
    if constexpr (sizeof(T) == 4) {
      constexpr int kPer = kWordBytes / 4;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        out[i] = __uint_as_float(word32(w[i / kPer], i % kPer));
      }
    } else if constexpr (V == 1) {
      out[0] = __uint_as_float(static_cast<unsigned>(w[0]) << 16);
    } else {
      constexpr int kPer = kWordBytes / 4;
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        const unsigned u = word32(w[i / kPer], i % kPer);
        out[2 * i] = __uint_as_float(u << 16);
        out[2 * i + 1] = __uint_as_float(u & 0xffff0000u);
      }
    }
  }
};

// The warp's sum in lane 0, by a fixed shuffle tree.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

}  // namespace sweep
