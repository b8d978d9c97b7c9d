// Shared device helpers for the DegreeSketch kernels (sm_90a).
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

__device__ __forceinline__ float warp_sum(float v) {
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

}  // namespace repro
