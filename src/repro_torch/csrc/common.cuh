// Shared device helpers for the DegreeSketch kernels (sm_90a): the hash,
// exact 2^-x, the nibble max of the packed layout, the Eq. 19 histogram
// update, vector loads and row groups, register-wise maxima,
// nonzero-register masks, the exact per-vector (s, z) sums of both
// register layouts, the row clamp, warp sums and grid sizes.
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

// Register-wise max of two words, or of two vectors, of either layout.
template <bool kPacked>
__device__ __forceinline__ uint32_t reg_max(uint32_t a, uint32_t b) {
  return kPacked ? nib_max4(a, b) : __vmaxu4(a, b);
}
template <bool kPacked>
__device__ __forceinline__ uint4 reg_max(const uint4& a, const uint4& b) {
  return make_uint4(reg_max<kPacked>(a.x, b.x), reg_max<kPacked>(a.y, b.y),
                    reg_max<kPacked>(a.z, b.z), reg_max<kPacked>(a.w, b.w));
}
template <bool kPacked>
__device__ __forceinline__ uint2 reg_max(const uint2& a, const uint2& b) {
  return make_uint2(reg_max<kPacked>(a.x, b.x), reg_max<kPacked>(a.y, b.y));
}

// The top bit of each register of w that is nonzero, and only those: the
// low bits plus all-ones-but-the-top carry into the top bit of their own
// register only (no add carries across a register).
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  return (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
}
__device__ __forceinline__ uint32_t nonzero_nibbles(uint32_t w) {
  return (((w & 0x77777777u) + 0x77777777u) | w) & 0x88888888u;
}
template <bool kPacked>
__device__ __forceinline__ uint32_t nonzero_regs(uint32_t w) {
  return kPacked ? nonzero_nibbles(w) : nonzero_bytes(w);
}

// Exact harmonic sums. Byte layout: registers x <= 27 add 2^(27 - x) to a
// fixed-point sum in units of 2^-27; larger ones (a few in a real panel,
// or foreign bytes) add their float32 term 2^-x to a float64 `tiny`.
// Packed layout: every register (x <= 15) adds 2^(15 - x), exactly.
// harmonic_finish rounds the sum to float32 once, so s does not depend on
// the order of summation or on the lanes' layout.
constexpr uint32_t kFixOne = 1u << 27;

// Byte layout: adds the terms of the kVec / 4 words of one vector to fix
// and tiny and its nonzero bytes to nz.
template <int kVec>
__device__ __forceinline__ void byte_vec_stats(
    const typename Vec<kVec>::T& v, unsigned long long* fix, double* tiny,
    int* nz) {
  using V = Vec<kVec>;
  constexpr int kWords = kVec / 4;
  uint32_t large = 0u;  // bit 7 of a byte: some word's byte is >= 28
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const uint32_t w = V::word(v, k);
    *nz += __popc(nonzero_bytes(w));
    large |= ((w & 0x7F7F7F7Fu) + 0x64646464u) | w;
  }
  if ((large & 0x80808080u) == 0u) {
    // bits 5-7 of every byte are 0, so each wrapping shift's 5-bit amount
    // is one byte; the vector's terms sum to at most 16 * 2^27 = 2^31
    uint32_t part = 0u;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const uint32_t w = V::word(v, k);
      part += __funnelshift_r(kFixOne, 0u, w) +
              __funnelshift_r(kFixOne, 0u, w >> 8) +
              __funnelshift_r(kFixOne, 0u, w >> 16) +
              __funnelshift_r(kFixOne, 0u, w >> 24);
    }
    *fix += part;
    return;
  }
  // a byte > 27 somewhere in the vector: one rolled loop, kept out of the
  // unrolled fast path (an out-of-line call would put the sums on the
  // stack)
#pragma unroll 1
  for (int b = 0; b < kVec; ++b) {
    const uint32_t x = (V::word(v, b >> 2) >> (8 * (b & 3))) & 0xFFu;
    if (x <= 27u) {
      *fix += kFixOne >> x;
    } else {
      *tiny += static_cast<double>(exp2_neg(x));
    }
  }
}

// Packed layout: adds the eight 2^(15 - x) terms of w to `part`, exactly
// (a vector's sum is at most 32 * 2^15), and its nonzero nibbles to nz.
__device__ __forceinline__ void packed_word_stats(uint32_t w, uint32_t* part,
                                                  int* nz) {
  *nz += __popc(nonzero_nibbles(w));
  const uint32_t even = w & 0x0F0F0F0Fu;
  const uint32_t odd = (w >> 4) & 0x0F0F0F0Fu;
  uint32_t t = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // the shift wraps at 32: bits 5-7 are 0
    t += __funnelshift_r(0x8000u, 0u, even >> (8 * k)) +
         __funnelshift_r(0x8000u, 0u, odd >> (8 * k));
  }
  *part += t;
}

// Adds the harmonic terms of one kVec-byte vector of either layout to fix
// (units of 2^-27 byte, 2^-15 packed) and tiny (byte registers > 27), and
// its nonzero registers to nz.
template <bool kPacked, int kVec>
__device__ __forceinline__ void add_vec_stats(const typename Vec<kVec>::T& v,
                                              unsigned long long* fix,
                                              double* tiny, int* nz) {
  if constexpr (kPacked) {
    uint32_t part = 0u;
#pragma unroll
    for (int k = 0; k < kVec / 4; ++k) {
      packed_word_stats(Vec<kVec>::word(v, k), &part, nz);
    }
    *fix += part;
  } else {
    byte_vec_stats<kVec>(v, fix, tiny, nz);
  }
}

// The sum of add_vec_stats's terms, rounded to float32 once (exact until
// then: fix < 2^43 for rows of up to 2^16 registers).
template <bool kPacked>
__device__ __forceinline__ float harmonic_finish(unsigned long long fix,
                                                 double tiny) {
  if constexpr (kPacked) {  // fix <= 2^16 * 2^15: exact in 32 bits
    return __uint2float_rn(static_cast<uint32_t>(fix)) *
           3.0517578125e-05f;  // exact: times 2^-15
  } else {
    return __double2float_rn(
        __dadd_rn(__dmul_rn(static_cast<double>(fix), 1.0 / kFixOne), tiny));
  }
}

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

// Sum of v over the warp, by a fixed xor-shuffle tree (int, unsigned,
// 64-bit integers, float or double).
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
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
// `smem`: the launch's dynamic shared memory, which counts in what fits.
template <auto kKernel>
unsigned int persistent_grid(int threads, int64_t blocks, int per_sm,
                             size_t smem = 0) {
  // what fits, cached for the last (threads, shared memory) asked: both
  // are launch arguments of a tuned kernel
  static thread_local int fit_threads = 0;
  static thread_local size_t fit_smem = ~size_t{0};
  static thread_local int fit = 1;
  if (threads != fit_threads || smem != fit_smem) {
    int f = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f, kKernel, threads, smem);
    fit = f < 1 ? 1 : f;
    fit_threads = threads;
    fit_smem = smem;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t cap =
      static_cast<int64_t>(sms > 0 ? sms : 1) * (per_sm < fit ? per_sm : fit);
  if (blocks < 1) return 1u;
  return static_cast<unsigned int>(blocks < cap ? blocks : cap);
}

}  // namespace repro
