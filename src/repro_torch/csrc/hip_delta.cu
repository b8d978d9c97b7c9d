// hip_delta_rows: batch-HIP increments between two hop panels.
//
// Replaces repro/kernels/hip_delta.py `hip_delta_rows` (the Pallas
// kernel): for each row of the byte-layout panels prev = D^{t-1} and
// cur = D^t, out[row] = sum_j [cur_j > prev_j] * 2^prev_j as float32 --
// the ADS family's per-hop HIP increment. A register that fell
// contributes nothing.
//
// What bounds it on the H100: bytes. Both panels are read once (2 GiB for
// 4M vertices at p=8) and 4 bytes are written per row, with a few integer
// operations per register byte.
//
// Design: a group of g lanes per row (g = r/32 clamped to [1, 32], so
// each lane covers at least 32 bytes: four 8-byte loads per panel in
// flight), 32/g rows per warp, grid-stride over row groups; the ragged
// last group masks its missing rows. A word pair whose bytes did not grow
// (__vcmpgtu4 == 0) is skipped. The sum is exact: 2^x for x < 32 adds
// into a 64-bit `lo`, for 32 <= x < 64 into a 64-bit `hi` in units of
// 2^32 (each below 2^48 for r <= 2^16), and x >= 64 (never stored by an
// ADS config) into a double `big`. The group reduces the three with a
// fixed xor-shuffle tree (no atomics) and lane 0 rounds
// ((hi * 2^32 + lo) + big) in double, then to float32 once -- the same
// operations as ref.hip_delta_ref, so kernel and plain version agree bit
// for bit. The wrapper guarantees r >= 8 and 8-byte-aligned panels.
#include "common.cuh"

namespace {

// Adds the terms of the four register pairs of one 32-bit word.
__device__ __forceinline__ void add_word(uint32_t p, uint32_t c,
                                         unsigned long long* lo,
                                         unsigned long long* hi, double* big) {
  if (__vcmpgtu4(c, p) == 0u) return;  // no register of the word grew
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t x = (p >> (8 * k)) & 0xFFu;
    const uint32_t y = (c >> (8 * k)) & 0xFFu;
    const bool grew = y > x;
    *lo += (grew && x < 32u) ? (1ull << x) : 0ull;
    *hi += (grew && x >= 32u && x < 64u) ? (1ull << (x - 32u)) : 0ull;
    if (grew && x >= 64u) {  // 2^x exactly, from the exponent bits
      *big += __longlong_as_double(static_cast<long long>(x + 1023u) << 52);
    }
  }
}

__global__ void hip_delta_kernel(const uint8_t* __restrict__ prev,
                                 const uint8_t* __restrict__ cur,
                                 float* __restrict__ out, int64_t n_rows,
                                 int r, int g) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (g - 1);  // lane within its row's group
  const int per_warp = 32 / g;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int words = r >> 3;  // 8-byte words per row
  // `first` is warp-uniform, so every lane reaches the shuffles below
  for (int64_t first = warp * per_warp; first < n_rows;
       first += warps * per_warp) {
    const int64_t row = first + lane / g;
    unsigned long long lo = 0, hi = 0;
    double big = 0.0;
    if (row < n_rows) {
      const uint2* pv = reinterpret_cast<const uint2*>(prev + row * r);
      const uint2* cv = reinterpret_cast<const uint2*>(cur + row * r);
#pragma unroll 4
      for (int i = sub; i < words; i += g) {
        const uint2 a = pv[i];
        const uint2 b = cv[i];
        add_word(a.x, b.x, &lo, &hi, &big);
        add_word(a.y, b.y, &lo, &hi, &big);
      }
    }
    for (int o = g >> 1; o > 0; o >>= 1) {
      lo += __shfl_xor_sync(0xFFFFFFFFu, lo, o);
      hi += __shfl_xor_sync(0xFFFFFFFFu, hi, o);
      big += __shfl_xor_sync(0xFFFFFFFFu, big, o);
    }
    if (sub == 0 && row < n_rows) {
      const double whole = __dadd_rn(
          __dmul_rn(static_cast<double>(hi), 4294967296.0),
          static_cast<double>(lo));
      out[row] = __double2float_rn(__dadd_rn(whole, big));
    }
  }
}

}  // namespace

extern "C" int hip_delta_rows(const uint8_t* prev, const uint8_t* cur,
                              float* out, int64_t n_rows, int r,
                              cudaStream_t stream) {
  if (n_rows == 0) return 0;
  constexpr int kThreads = 256;
  const int g = r >= 1024 ? 32 : (r >= 64 ? r / 32 : 1);
  const int64_t warps = (n_rows + 32 / g - 1) / (32 / g);
  hip_delta_kernel<<<repro::grid_for(warps * 32, kThreads), kThreads, 0,
                     stream>>>(prev, cur, out, n_rows, r, g);
  return static_cast<int>(cudaGetLastError());
}
