// hll_estimate_stats: per-row HLL harmonic statistics.
//
// Replaces repro/kernels/hll_estimate.py `hll_estimate_stats` (the Pallas
// kernel): for each sketch row, s = sum_i 2^-reg_i and z = #zero
// registers, written as float32[N, 2]. The estimator combination
// (Flajolet / linear counting / beta) stays outside: it is O(N) scalar
// work.
//
// What bounds it on the H100: bytes. Every register byte is read once
// (1 GiB for 4M vertices at p=8) and 8 bytes are written per row. The
// per-byte arithmetic has to stay a few instructions, or issue, not the
// memory, sets the time.
//
// Design: a group of g lanes per row, each lane issuing kLoads 16-byte
// loads of its row before it reduces any (p=8: 4 lanes x 64 bytes, 8 rows
// a warp), a persistent grid of at most kBlocksPerSM resident blocks per
// SM striding over row groups (the block size is the launcher's
// `threads`, 128, 256 or 512, read from blockDim in the kernel;
// kernels/autotune.py holds the default, 512, and the sweep), log2(g) shuffle levels per row and one
// float2 store. Per 32-bit word (repro::add_vec_stats, shared with the
// pair and set kernels):
// * z counts the nonzero bytes with one carry-free add and a popcount;
// * s is summed exactly in fixed point: when carry-free adds show every
//   byte of a vector <= 27, each term 2^(27 - x) is one wrapping funnel shift
//   of 2^27 by the word shifted to that byte, and the terms of a 16-byte
//   vector add in 32 bits before one 64-bit add. A vector holding a
//   larger byte (a few in a real panel; foreign bytes too) takes one
//   rolled loop over its bytes instead, whose terms x > 27 add their
//   float32 2^-x in float64.
// The row's sum is rounded to float32 once, so s does not depend on the
// order of summation; the plain version sums in float64 and rounds once,
// which equals it bit for bit while every register is <= 52 - p. A panel
// that is only 8-byte aligned, or rows of 8 bytes, take 8-byte loads
// instead. The wrapper guarantees rows of a
// power of two >= 8 bytes and an 8-byte-aligned panel.
//
// Packed layout (hll_estimate_stats_packed): the row is r/2 bytes, eight
// 4-bit registers a word. The even and odd nibbles are split into byte
// lanes, and each term 2^(15 - x) is one wrapping funnel shift of 0x8000
// by the nibble (its byte lane holds no other bit below bit 5). s is the
// exact integer sum, rounded to float once (repro::harmonic_finish), so
// the kernel equals the plain version bit for bit, and equals the byte
// kernel on the unpacked panel (both are the exact sum rounded once).
// The bytes bound halves.
#include "common.cuh"

namespace {

// Design constants, swept on the card by scripts/sweep_rowstats.py.
constexpr int kVecBytes = 16;    // load width (8 where alignment forbids 16)
constexpr int kLoads = 4;        // loads of its row a lane has in flight
constexpr int kMaxThreads = 512;  // the largest block the launcher takes
constexpr int kBlocksPerSM = 8;  // persistent grid

// row_vecs: kVec-byte vectors per row; g = 1 << g_log2 lanes per row;
// regs_per_row: registers per row (the zero count is regs_per_row - nz).
template <bool kPacked, int kVec>
__global__ void __launch_bounds__(kMaxThreads)
    estimate_kernel(const uint8_t* __restrict__ regs, float2* __restrict__ out,
                    int64_t n_rows, int row_vecs, int g_log2,
                    int regs_per_row) {
  using V = repro::Vec<kVec>;
  const int g = 1 << g_log2;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (g - 1);
  const int per_warp = 32 >> g_log2;
  const int loads = row_vecs < kLoads ? row_vecs : kLoads;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const typename V::T* vecs = reinterpret_cast<const typename V::T*>(regs);
  // `first` is warp-uniform, so every lane reaches the shuffles below
  for (int64_t first = warp * per_warp; first < n_rows;
       first += warps * per_warp) {
    const int64_t row = first + (lane >> g_log2);
    unsigned long long fix = 0;  // byte: units of 2^-27; packed: 2^-15
    double tiny = 0.0;           // byte registers > 27
    int nz = 0;
    if (row < n_rows) {
      const typename V::T* v = vecs + row * row_vecs;
      for (int i = sub; i < row_vecs; i += g * kLoads) {
        typename V::T buf[kLoads];
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          if (j < loads) buf[j] = v[i + j * g];
        }
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          if (j < loads) {
            repro::add_vec_stats<kPacked, kVec>(buf[j], &fix, &tiny, &nz);
          }
        }
      }
    }
    for (int o = g >> 1; o > 0; o >>= 1) {
      fix += __shfl_xor_sync(0xFFFFFFFFu, fix, o);
      nz += __shfl_xor_sync(0xFFFFFFFFu, nz, o);
    }
    if (!kPacked && __any_sync(0xFFFFFFFFu, tiny != 0.0)) {
      for (int o = g >> 1; o > 0; o >>= 1) {
        tiny += __shfl_xor_sync(0xFFFFFFFFu, tiny, o);
      }
    }
    if (sub == 0 && row < n_rows) {
      out[row] = make_float2(repro::harmonic_finish<kPacked>(fix, tiny),
                             static_cast<float>(regs_per_row - nz));
    }
  }
}

template <bool kPacked, int kVec>
int launch(const uint8_t* regs, float* out, int64_t n_rows, int row_bytes,
           int regs_per_row, int threads, cudaStream_t stream) {
  const int row_vecs = row_bytes / kVec;
  const int g_log2 = repro::group_log2(row_vecs, kLoads);
  const int64_t rows_per_block = (threads / 32) * (32 >> g_log2);
  const unsigned int blocks =
      repro::persistent_grid<estimate_kernel<kPacked, kVec>>(
          threads, (n_rows + rows_per_block - 1) / rows_per_block,
          kBlocksPerSM);
  estimate_kernel<kPacked, kVec><<<blocks, threads, 0, stream>>>(
      regs, reinterpret_cast<float2*>(out), n_rows, row_vecs, g_log2,
      regs_per_row);
  return static_cast<int>(cudaGetLastError());
}

// threads: the block size, 128, 256 or 512 (cudaErrorInvalidValue
// otherwise, nothing launched).
template <bool kPacked>
int launch_any(const uint8_t* regs, float* out, int64_t n_rows, int row_bytes,
               int regs_per_row, int threads, cudaStream_t stream) {
  if (threads != 128 && threads != 256 && threads != kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const bool wide = kVecBytes == 16 && row_bytes % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(regs) % 16 == 0;
  return wide ? launch<kPacked, 16>(regs, out, n_rows, row_bytes,
                                    regs_per_row, threads, stream)
              : launch<kPacked, 8>(regs, out, n_rows, row_bytes, regs_per_row,
                                   threads, stream);
}

}  // namespace

// threads: the block size, 128, 256 or 512.
extern "C" int hll_estimate_stats(const uint8_t* regs, float* out,
                                  int64_t n_rows, int r, int threads,
                                  cudaStream_t stream) {
  return launch_any<false>(regs, out, n_rows, r, r, threads, stream);
}

// r: registers per row; the packed row is r / 2 bytes (r >= 16).
extern "C" int hll_estimate_stats_packed(const uint8_t* regs, float* out,
                                         int64_t n_rows, int r, int threads,
                                         cudaStream_t stream) {
  return launch_any<true>(regs, out, n_rows, r >> 1, r, threads, stream);
}
