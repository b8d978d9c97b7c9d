// ertl_stats: Eq. 19 count statistics of given register-row pairs.
//
// Replaces repro/kernels/ertl_stats.py `ertl_stats` (the Pallas kernel).
// For each pair i of rows (a[i], b[i]) of two uint8[E, r] panels it writes
// stats[i, 5, q+2], the count histograms over register value k,
//   [a<b counted at a, a>b at a, b<a at b, b>a at b, a==b at a],
// the O(E * r) front of every T~(xy) estimate of the triangle queries
// (core/intersection.py mle_cardinalities). Counts are integers, so the
// result equals the plain version exactly.
//
// What bounds it on the H100: bytes. 2r bytes are read and 5(q+2) floats
// written per pair: at p=8 that is 512 B in and 1,160 B out, so the
// output dominates; each register costs a few integer operations and at
// most two shared-memory atomics.
//
// Design: one warp per pair, kWarps pairs per block (the launcher's
// `pair_block`, 4, 8, 16 or 32; each is its own instantiation, so the
// pair index stays compile-time arithmetic; kernels/autotune.py holds the
// default, 8, and the sweep), as intersection_stats but on rows the
// caller has already gathered. Each lane reads both rows
// a 32-bit word at a time (the wrapper guarantees r >= 8 and 8-byte
// aligned panels), counts each register pair into a 5*(q+2) slice of
// shared-memory integer histograms (repro::eq19_add, shared with
// intersection_stats.cu), and the warp writes the slice out as float32.
// Register values outside [0, q+2) count in no bin.
//
// Packed layout (ertl_stats_packed): rows of r/2 bytes, each 32-bit word
// split into its eight nibbles in registers; half the bytes in, the same
// histograms out, bins 16..q+1 empty.
#include "common.cuh"

namespace {

// width: bytes per row (r, or r / 2 packed), a power of two >= 8; kWarps:
// pairs a block, one a warp.
template <bool kPacked, int kWarps>
__global__ void ertl_stats_kernel(const uint8_t* __restrict__ a,
                                  const uint8_t* __restrict__ b,
                                  float* __restrict__ stats, int64_t n_pairs,
                                  int width, int q) {
  using L = repro::Lanes<kPacked>;
  extern __shared__ int hist_all[];
  const int nb = q + 2;
  const int hsize = 5 * nb;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* hist = hist_all + warp * hsize;
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (pair >= n_pairs) return;  // whole warp leaves; no block barrier below
  for (int i = lane; i < hsize; i += 32) hist[i] = 0;
  __syncwarp();
  const uint32_t* wa = reinterpret_cast<const uint32_t*>(a + pair * width);
  const uint32_t* wb = reinterpret_cast<const uint32_t*>(b + pair * width);
  for (int i = lane; i < (width >> 2); i += 32) {
    const uint32_t va = wa[i];
    const uint32_t vb = wb[i];
#pragma unroll
    for (int k = 0; k < L::kPerWord; ++k)
      repro::eq19_add((va >> (L::kBits * k)) & L::kMask,
                      (vb >> (L::kBits * k)) & L::kMask, nb, hist);
  }
  __syncwarp();
  float* out = stats + pair * hsize;
  for (int i = lane; i < hsize; i += 32) out[i] = static_cast<float>(hist[i]);
}

template <bool kPacked, int kWarps>
int launch(const uint8_t* a, const uint8_t* b, float* stats, int64_t n_pairs,
           int width, int q, cudaStream_t stream) {
  // at most 32 x 5 x 65 ints (q <= 63): under the 48 KB default
  const size_t smem = static_cast<size_t>(kWarps) * 5 * (q + 2) * sizeof(int);
  const int64_t blocks = (n_pairs + kWarps - 1) / kWarps;
  ertl_stats_kernel<kPacked, kWarps>
      <<<static_cast<unsigned int>(blocks), kWarps * 32, smem, stream>>>(
          a, b, stats, n_pairs, width, q);
  return static_cast<int>(cudaGetLastError());
}

// pair_block: pairs a block, 4, 8, 16 or 32 (cudaErrorInvalidValue
// otherwise, nothing launched).
template <bool kPacked>
int launch_any(const uint8_t* a, const uint8_t* b, float* stats,
               int64_t n_pairs, int width, int q, int pair_block,
               cudaStream_t stream) {
  if (pair_block != 4 && pair_block != 8 && pair_block != 16 &&
      pair_block != 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs == 0) return 0;
  switch (pair_block) {
    case 4:
      return launch<kPacked, 4>(a, b, stats, n_pairs, width, q, stream);
    case 8:
      return launch<kPacked, 8>(a, b, stats, n_pairs, width, q, stream);
    case 16:
      return launch<kPacked, 16>(a, b, stats, n_pairs, width, q, stream);
    default:
      return launch<kPacked, 32>(a, b, stats, n_pairs, width, q, stream);
  }
}

}  // namespace

// pair_block: pairs a block, 4, 8, 16 or 32.
extern "C" int ertl_stats(const uint8_t* a, const uint8_t* b, float* stats,
                          int64_t n_pairs, int r, int q, int pair_block,
                          cudaStream_t stream) {
  return launch_any<false>(a, b, stats, n_pairs, r, q, pair_block, stream);
}

// r: registers per row; the packed rows are r / 2 bytes (r >= 16).
extern "C" int ertl_stats_packed(const uint8_t* a, const uint8_t* b,
                                 float* stats, int64_t n_pairs, int r, int q,
                                 int pair_block, cudaStream_t stream) {
  return launch_any<true>(a, b, stats, n_pairs, r >> 1, q, pair_block,
                          stream);
}
