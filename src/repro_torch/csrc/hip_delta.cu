// hip_delta_rows: batch-HIP increments between two hop panels.
//
// Replaces repro/kernels/hip_delta.py `hip_delta_rows` (the Pallas
// kernel): for each row of the byte-layout panels prev = D^{t-1} and
// cur = D^t, out[row] = sum_j [cur_j > prev_j] * 2^prev_j as float32 --
// the ADS family's per-hop HIP increment. A register that fell
// contributes nothing.
//
// What bounds it on the H100: bytes. Both panels are read once (2 GiB for
// 4M vertices at p=8) and 4 bytes are written per row; the per-byte
// arithmetic has to stay a few instructions, or issue sets the time.
//
// Design: a group of g lanes per row, each lane issuing kLoads 16-byte
// loads of each panel before it adds any (p=8: 8 lanes x 32 bytes of
// each panel, 4 rows a warp), a persistent grid of at most kBlocksPerSM
// resident blocks per SM striding over row groups. The block size is the
// launcher's `threads`, 128, 256 or 512; it caps the registers through
// __launch_bounds__, so each is its own instantiation (kernels/autotune.py
// holds the default, 256, and the sweep). Per 16-byte vector:
// * fast path, when all its prev bytes are below 30 (a carry-free add a
//   word tests it), per 32-bit word pair: the grew mask of the four bytes
//   comes from one carry-free subtraction, a byte that did not grow gets
//   a shift amount >= 32, and each term is one clamping funnel shift of
//   1; the four terms (each below 2^30) are summed in 32 bits and added
//   to the 64-bit `lo` once;
// * general path, one rolled loop over the bytes of a vector with a prev
//   byte >= 30 (a few in a real panel): 2^x for x < 32 adds into `lo`,
//   for 32 <= x < 64 into a 64-bit `hi` in units of 2^32 (each below
//   2^48 for r <= 2^16), and x >= 64 (never stored by an ADS config)
//   into a double `big`.
// No word is skipped, so lanes do not diverge on which words grew. The
// group reduces `lo` with a fixed xor-shuffle tree, and `hi` and `big`
// only when a lane of the warp holds one (a warp vote). Lane 0 of the
// group rounds ((hi * 2^32 + lo) + big) in double, then to float32 once
// -- the same operations as ref.hip_delta_ref, so kernel and plain
// version agree bit for bit. A panel that is only 8-byte aligned, or rows
// of 8 bytes, take 8-byte loads. The wrapper guarantees rows of a power
// of two >= 8 bytes and 8-byte-aligned panels.
#include "common.cuh"

namespace {

// Design constants, swept on the card by scripts/sweep_rowstats.py.
constexpr int kVecBytes = 16;    // load width (8 where alignment forbids 16)
constexpr int kLoads = 2;        // loads of each panel a lane has in flight
constexpr int kBlocksPerSM = 8;  // persistent grid

// Fast path of one word pair whose prev bytes are all below 30: the sum
// of its four terms, each below 2^30.
__device__ __forceinline__ uint32_t fast_word(uint32_t p, uint32_t c) {
  // bit 7 of a byte: cur > prev. Every prev byte is below 30, so
  // (c | 0x80) - p - 1 stays in [98, 254]: no borrow crosses a byte, and
  // for c < 128 its bit 7 is c > p; c >= 128 grew by its own bit 7.
  const uint32_t grew = (((c | 0x80808080u) - p - 0x01010101u) | c) &
                        0x80808080u;
  // shift amounts: prev, plus 32 where the byte did not grow
  const uint32_t amt = p | ((~grew >> 2) & 0x20202020u);
  uint32_t t = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // 1 << amt, 0 for amt >= 32 (clamped)
    t += __funnelshift_lc(0u, 1u, __byte_perm(amt, 0u, 0x4440u + k));
  }
  return t;
}

// Adds the terms of the register pairs of one vector of each panel.
template <int kVec>
__device__ __forceinline__ void add_vec(const typename repro::Vec<kVec>::T& a,
                                        const typename repro::Vec<kVec>::T& b,
                                        unsigned long long* lo,
                                        unsigned long long* hi, double* big) {
  using V = repro::Vec<kVec>;
  constexpr int kWords = kVec / 4;
  uint32_t wide = 0u;  // bit 7 of a byte: some prev byte is >= 30
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const uint32_t p = V::word(a, k);
    wide |= ((p & 0x7F7F7F7Fu) + 0x62626262u) | p;  // carries out of no byte
  }
  if ((wide & 0x80808080u) == 0u) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      *lo += fast_word(V::word(a, k), V::word(b, k));
    }
    return;
  }
  // a prev byte >= 30 somewhere in the vector: one rolled loop, kept out
  // of the unrolled fast path
#pragma unroll 1
  for (int i = 0; i < kVec; ++i) {
    const int sh = 8 * (i & 3);
    const uint32_t x = (V::word(a, i >> 2) >> sh) & 0xFFu;
    const uint32_t y = (V::word(b, i >> 2) >> sh) & 0xFFu;
    if (y <= x) continue;
    if (x < 32u) {
      *lo += 1ull << x;
    } else if (x < 64u) {
      *hi += 1ull << (x - 32u);
    } else {  // 2^x exactly, from the exponent bits
      *big += __longlong_as_double(static_cast<long long>(x + 1023u) << 52);
    }
  }
}

// row_vecs: kVec-byte vectors per row; g = 1 << g_log2 lanes per row;
// kThreads: the block size.
template <int kVec, int kThreads>
__global__ void __launch_bounds__(kThreads)
    hip_delta_kernel(const uint8_t* __restrict__ prev,
                     const uint8_t* __restrict__ cur, float* __restrict__ out,
                     int64_t n_rows, int row_vecs, int g_log2) {
  using V = repro::Vec<kVec>;
  const int g = 1 << g_log2;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (g - 1);
  const int per_warp = 32 >> g_log2;
  const int loads = row_vecs < kLoads ? row_vecs : kLoads;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const typename V::T* pvecs = reinterpret_cast<const typename V::T*>(prev);
  const typename V::T* cvecs = reinterpret_cast<const typename V::T*>(cur);
  // `first` is warp-uniform, so every lane reaches the shuffles below
  for (int64_t first = warp * per_warp; first < n_rows;
       first += warps * per_warp) {
    const int64_t row = first + (lane >> g_log2);
    unsigned long long lo = 0, hi = 0;
    double big = 0.0;
    if (row < n_rows) {
      const typename V::T* pv = pvecs + row * row_vecs;
      const typename V::T* cv = cvecs + row * row_vecs;
      for (int i = sub; i < row_vecs; i += g * kLoads) {
        typename V::T a[kLoads], b[kLoads];
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          if (j < loads) {
            a[j] = pv[i + j * g];
            b[j] = cv[i + j * g];
          }
        }
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          if (j < loads) {
            add_vec<kVec>(a[j], b[j], &lo, &hi, &big);
          }
        }
      }
    }
    for (int o = g >> 1; o > 0; o >>= 1) {
      lo += __shfl_xor_sync(0xFFFFFFFFu, lo, o);
    }
    if (__any_sync(0xFFFFFFFFu, hi != 0ull || big != 0.0)) {
      for (int o = g >> 1; o > 0; o >>= 1) {
        hi += __shfl_xor_sync(0xFFFFFFFFu, hi, o);
        big += __shfl_xor_sync(0xFFFFFFFFu, big, o);
      }
    }
    if (sub == 0 && row < n_rows) {
      const double whole = __dadd_rn(
          __dmul_rn(static_cast<double>(hi), 4294967296.0),
          static_cast<double>(lo));
      out[row] = __double2float_rn(__dadd_rn(whole, big));
    }
  }
}

template <int kVec, int kThreads>
int launch(const uint8_t* prev, const uint8_t* cur, float* out,
           int64_t n_rows, int r, cudaStream_t stream) {
  const int row_vecs = r / kVec;
  const int g_log2 = repro::group_log2(row_vecs, kLoads);
  const int64_t rows_per_block = (kThreads / 32) * (32 >> g_log2);
  const unsigned int blocks =
      repro::persistent_grid<hip_delta_kernel<kVec, kThreads>>(
          kThreads, (n_rows + rows_per_block - 1) / rows_per_block,
          kBlocksPerSM);
  hip_delta_kernel<kVec, kThreads><<<blocks, kThreads, 0, stream>>>(
      prev, cur, out, n_rows, row_vecs, g_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int kThreads>
int launch_any(const uint8_t* prev, const uint8_t* cur, float* out,
               int64_t n_rows, int r, cudaStream_t stream) {
  const bool wide = kVecBytes == 16 && r % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(prev) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(cur) % 16 == 0;
  return wide ? launch<16, kThreads>(prev, cur, out, n_rows, r, stream)
              : launch<8, kThreads>(prev, cur, out, n_rows, r, stream);
}

}  // namespace

// threads: the block size, 128, 256 or 512 (cudaErrorInvalidValue
// otherwise, nothing launched).
extern "C" int hip_delta_rows(const uint8_t* prev, const uint8_t* cur,
                              float* out, int64_t n_rows, int r, int threads,
                              cudaStream_t stream) {
  if (threads != 128 && threads != 256 && threads != 512)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  switch (threads) {
    case 128:
      return launch_any<128>(prev, cur, out, n_rows, r, stream);
    case 256:
      return launch_any<256>(prev, cur, out, n_rows, r, stream);
    default:
      return launch_any<512>(prev, cur, out, n_rows, r, stream);
  }
}
