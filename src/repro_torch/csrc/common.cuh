// Shared device helpers for the DegreeSketch kernels (sm_90a): the hash,
// exact 2^-x, the per-word (s, z) terms of both register layouts, the
// nibble max of the packed layout, the Eq. 19 histogram update, vector
// loads and row groups, the row clamp, warp sums and grid sizes.
//
// The hash is the one of repro/core/hashing.py, computed natively in
// uint32_t: two murmur3 finalizers with distinct seed mixing, cross-mixed,
// give a (hi, lo) pair; the bucket is the top p bits of hi and rho the
// leading-zero count of the following q = 64 - p bits, plus one. The seed
// words are folded on the host (kernels/hll_accumulate.py) exactly as
// hashing.py:48-49 does.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// bucket in [0, 2^p), rho in [1, q + 1]; p in [1, 31].
__device__ __forceinline__ void bucket_rho(uint32_t key, int p, uint32_t s_hi,
                                           uint32_t s_lo, uint32_t* bucket,
                                           uint32_t* rho) {
  uint32_t hi = fmix32(key ^ s_hi);
  const uint32_t lo = fmix32((key + 0x85EBCA6Bu) ^ s_lo);
  hi = fmix32(hi + lo * 0x9E3779B9u);
  *bucket = hi >> (32 - p);
  const uint32_t w_hi = (hi << p) | (lo >> (32 - p));
  const uint32_t w_lo = lo << p;
  // __clz(0) == 32, as jax.lax.clz gives
  const int lz = w_hi != 0u ? __clz(w_hi) : 32 + __clz(w_lo);
  *rho = static_cast<uint32_t>(min(lz, 64 - p) + 1);
}

// 2^-x, exact: built from the exponent bits for the register range
// (x <= 65 always; larger bytes only come from foreign panels).
__device__ __forceinline__ float exp2_neg(uint32_t x) {
  return x <= 126u ? __int_as_float(static_cast<int>(127u - x) << 23)
                   : exp2f(-static_cast<float>(x));
}

// Adds the 2^-x terms and zero count of the four register bytes of w;
// T is float or double (each term is exact in both).
template <typename T>
__device__ __forceinline__ void add_word_stats(uint32_t w, T* s, int* z) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t x = (w >> (8 * k)) & 0xFFu;
    *s += exp2_neg(x);
    *z += x == 0u;
  }
}

// Counts one register pair (x, y) into a 5 * nb slice of Eq. 19
// histograms, ordered [x<y at x, x>y at x, y<x at y, y>x at y, x==y at x],
// with shared-memory integer atomics. Values >= nb count in no bin, as a
// one-hot over arange(nb) would.
__device__ __forceinline__ void eq19_add(uint32_t x, uint32_t y, int nb,
                                         int* hist) {
  const uint32_t bins = static_cast<uint32_t>(nb);
  if (x < y) {
    if (x < bins) atomicAdd(hist + x, 1);
    if (y < bins) atomicAdd(hist + 3 * nb + y, 1);
  } else if (x > y) {
    if (x < bins) atomicAdd(hist + nb + x, 1);
    if (y < bins) atomicAdd(hist + 2 * nb + y, 1);
  } else if (x < bins) {
    atomicAdd(hist + 4 * nb + x, 1);
  }
}

// Register lanes of one 32-bit word: four bytes on the byte layout, eight
// 4-bit nibbles on the packed layout (kernels/packing.py; split-half, so
// the order of registers within a row differs, which no statistic here
// depends on).
template <bool kPacked>
struct Lanes {
  static constexpr int kBits = kPacked ? 4 : 8;
  static constexpr int kPerWord = 32 / kBits;
  static constexpr uint32_t kMask = (1u << kBits) - 1u;
};

// Nibble-wise max of two packed words (eight 4-bit registers each): a
// byte-wise max is wrong on packed bytes (0x10 vs 0x01 must give 0x11).
__device__ __forceinline__ uint32_t nib_max4(uint32_t a, uint32_t b) {
  return __vmaxu4(a & 0x0F0F0F0Fu, b & 0x0F0F0F0Fu) |
         (__vmaxu4((a >> 4) & 0x0F0F0F0Fu, (b >> 4) & 0x0F0F0F0Fu) << 4);
}

// Harmonic term of one register. Byte layout: 2^-x as float. Packed
// layout: x <= 15, so the sum is kept exactly as the integer
// sum 2^(15 - x) (at most 2^16 * 2^15 = 2^31 for r <= 2^16) and rounded
// to float once at the end, so any order of summation gives the same
// bits (ref.packed_stats does the same on the host).
template <bool kPacked>
struct Harmonic {
  using Sum = float;
  __device__ static __forceinline__ float term(uint32_t x) {
    return exp2_neg(x);
  }
  __device__ static __forceinline__ float finish(float s) { return s; }
};

template <>
struct Harmonic<true> {
  using Sum = uint32_t;
  __device__ static __forceinline__ uint32_t term(uint32_t x) {
    return 0x8000u >> x;
  }
  __device__ static __forceinline__ float finish(uint32_t s) {
    return __uint2float_rn(s) * 3.0517578125e-05f;  // exact: times 2^-15
  }
};

// Adds the harmonic terms and zero count of the registers of word w.
template <bool kPacked>
__device__ __forceinline__ void add_lane_stats(
    uint32_t w, typename Harmonic<kPacked>::Sum* s, int* z) {
  using L = Lanes<kPacked>;
#pragma unroll
  for (int k = 0; k < L::kPerWord; ++k) {
    const uint32_t x = (w >> (L::kBits * k)) & L::kMask;
    *s += Harmonic<kPacked>::term(x);
    *z += x == 0u;
  }
}

// A 16- or 8-byte vector load (uint4 or uint2) and its 32-bit words.
template <int kBytes>
struct Vec;
template <>
struct Vec<16> {
  using T = uint4;
  __device__ static __forceinline__ uint32_t word(const uint4& v, int i) {
    return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
  }
};
template <>
struct Vec<8> {
  using T = uint2;
  __device__ static __forceinline__ uint32_t word(const uint2& v, int i) {
    return i == 0 ? v.x : v.y;
  }
};

// log2 of the lanes that share a row of `row_vecs` vectors when each lane
// takes `loads` of them a step (a power of two): row_vecs / loads lanes,
// clamped to [1, 32], so g * loads divides row_vecs whenever g > 1.
inline int group_log2(int row_vecs, int loads) {
  int g_log2 = 0;
  while (g_log2 < 5 && (loads << (g_log2 + 1)) <= row_vecs) ++g_log2;
  return g_log2;
}

// Row index clamped into [0, n_rows), as a jnp gather clamps: callers
// validate ids, so this only keeps a stray id in bounds.
__device__ __forceinline__ int64_t clamp_row(int64_t i, int64_t n_rows) {
  return i < 0 ? 0 : (i >= n_rows ? n_rows - 1 : i);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

// Blocks for a grid-stride loop over `work` items of `threads` each.
inline unsigned int grid_for(int64_t work, int threads) {
  const int64_t blocks = (work + threads - 1) / threads;
  return static_cast<unsigned int>(blocks < (1 << 20) ? blocks : (1 << 20));
}

// Blocks of a persistent grid-stride loop of kKernel (launched with
// `threads` threads a block) over `blocks` blocks of work: at most `per_sm`
// on each SM of the current device, and no more than fit there at once,
// so the grid is one wave and no block waits for a second.
template <auto kKernel>
unsigned int persistent_grid(int threads, int64_t blocks, int per_sm) {
  static const int fit = [threads] {
    int f = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f, kKernel, threads, 0);
    return f < 1 ? 1 : f;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t cap =
      static_cast<int64_t>(sms > 0 ? sms : 1) * (per_sm < fit ? per_sm : fit);
  if (blocks < 1) return 1u;
  return static_cast<unsigned int>(blocks < cap ? blocks : cap);
}

}  // namespace repro
