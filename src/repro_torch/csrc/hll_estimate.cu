// hll_estimate_stats: per-row HLL harmonic statistics.
//
// Replaces repro/kernels/hll_estimate.py `hll_estimate_stats` (the Pallas
// kernel): for each sketch row, s = sum_i 2^-reg_i and z = #zero
// registers, written as float32[N, 2]. The estimator combination
// (Flajolet / linear counting / beta) stays outside: it is O(N) scalar
// work.
//
// What bounds it on the H100: bytes. Every register byte is read once
// (1 GiB for 4M vertices at p=8) and 8 bytes are written per row, with a
// handful of integer operations per byte, far below the card's
// operations-per-byte balance.
//
// Design: one warp per row, grid-stride over rows. Lanes read the row
// with 8-byte vector loads (p=8: the warp covers the 256-byte row in one
// request), build 2^-x exactly from the exponent bits instead of calling
// exp2f, and reduce s and z with warp shuffles. The wrapper guarantees
// r >= 8 and an 8-byte-aligned panel.
//
// Packed layout (hll_estimate_stats_packed): the row is r/2 bytes, read as
// 4-byte words (p=8: 32 lanes cover the 128-byte row in one request),
// each word split into its eight nibbles in registers. s is summed
// exactly as the integer sum 2^(15 - x) and rounded to float once
// (repro::Harmonic<true>), so the kernel equals the plain version bit for
// bit, and equals the byte kernel on the unpacked panel wherever that one
// is exact (every p <= 9). The bytes bound halves.
#include "common.cuh"

namespace {

__global__ void hll_estimate_kernel(const uint8_t* __restrict__ regs,
                                    float* __restrict__ out, int64_t n_rows,
                                    int r) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t row =
           (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       row < n_rows; row += warps) {
    const uint8_t* base = regs + row * r;
    float s = 0.f;
    int z = 0;
    const uint2* v = reinterpret_cast<const uint2*>(base);
    for (int i = lane; i < (r >> 3); i += 32) {
      const uint2 w = v[i];
      repro::add_word_stats(w.x, &s, &z);
      repro::add_word_stats(w.y, &s, &z);
    }
    s = repro::warp_sum(s);
    z = repro::warp_sum(z);
    if (lane == 0) {
      out[2 * row] = s;
      out[2 * row + 1] = static_cast<float>(z);
    }
  }
}

// width: bytes per packed row (r / 2), a power of two >= 8.
__global__ void hll_estimate_packed_kernel(const uint8_t* __restrict__ regs,
                                           float* __restrict__ out,
                                           int64_t n_rows, int width) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t row =
           (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       row < n_rows; row += warps) {
    const uint32_t* v = reinterpret_cast<const uint32_t*>(regs + row * width);
    uint32_t s = 0u;
    int z = 0;
    for (int i = lane; i < (width >> 2); i += 32)
      repro::add_lane_stats<true>(v[i], &s, &z);
    s = repro::warp_sum(s);
    z = repro::warp_sum(z);
    if (lane == 0) {
      out[2 * row] = repro::Harmonic<true>::finish(s);
      out[2 * row + 1] = static_cast<float>(z);
    }
  }
}

}  // namespace

extern "C" int hll_estimate_stats(const uint8_t* regs, float* out,
                                  int64_t n_rows, int r, cudaStream_t stream) {
  if (n_rows == 0) return 0;
  constexpr int kThreads = 256;
  hll_estimate_kernel<<<repro::grid_for(n_rows * 32, kThreads), kThreads, 0,
                        stream>>>(regs, out, n_rows, r);
  return static_cast<int>(cudaGetLastError());
}

// r: registers per row; the packed row is r / 2 bytes (r >= 16).
extern "C" int hll_estimate_stats_packed(const uint8_t* regs, float* out,
                                         int64_t n_rows, int r,
                                         cudaStream_t stream) {
  if (n_rows == 0) return 0;
  constexpr int kThreads = 256;
  hll_estimate_packed_kernel<<<repro::grid_for(n_rows * 32, kThreads),
                               kThreads, 0, stream>>>(regs, out, n_rows,
                                                      r >> 1);
  return static_cast<int>(cudaGetLastError());
}
