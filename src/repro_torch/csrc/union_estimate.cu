// union_estimate_stats: fused union cardinality statistics.
//
// Replaces repro/kernels/union_estimate.py `union_estimate_stats` (the
// Pallas kernel). For each set row of a padded id panel ids[B, L] with
// validity mask[B, L], it max-merges the member rows regs[ids[set, l]] of
// the unmasked lanes and reduces the merged row to (s, z) = (sum 2^-x,
// #zero registers), written as float32[B, 2]. The merged row never
// leaves the chip. A masked lane merges nothing: it never reads the row
// its padding id names (row 0). A fully masked set reduces to the empty
// sketch, (s, z) = (r, r). Duplicate ids are merged twice, harmlessly.
//
// What bounds it on the H100: bytes. Each unmasked member's row is read
// once (r bytes), plus 5 bytes of id and mask per lane and 8 bytes out
// per set; the merge is one __vmaxu4 per 4 registers.
//
// Design: one warp per set, eight sets per block. The warp walks the row
// in chunks of 256 bytes, each lane owning one 8-byte word of the chunk
// (the wrapper guarantees r >= 8 and an 8-byte-aligned panel). For each
// chunk it walks the set's lanes 32 at a time: each lane loads one id and
// mask entry, a ballot gives the unmasked lanes, and their ids are
// broadcast by shuffle, so masked lanes cost no row read. Merged words
// stay in registers; their 2^-x terms and zero counts add to per-lane
// sums, which the warp reduces with a fixed shuffle tree. s is summed in
// double and rounded once: a merged row of many sketches holds only large
// register values, no term dominates, and a float running sum over a
// p=16 row drifts by 3e-5 (measured on the H100). There are no atomics,
// so the same inputs give the same bits on every launch (query_batch's
// answers equal union_size's bit for bit).
//
// Packed layout (union_estimate_stats_packed): rows of r/2 bytes, read as
// 4-byte words (p=8: one word per lane covers the 128-byte row), merged
// with repro::nib_max4, and s summed exactly as the integer
// sum 2^(15 - x) (repro::Harmonic<true>), rounded to float once. That sum
// equals the byte kernel's double sum on the unpacked rows, which is
// exact there too.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;

// One lane's slice of a row, its merge and its statistics, per layout.
template <bool kPacked>
struct RowWord {
  using Word = uint2;  // eight registers
  using Sum = double;
  static constexpr int kShift = 3;  // log2 bytes per word
  __device__ static __forceinline__ Word zero() { return make_uint2(0u, 0u); }
  __device__ static __forceinline__ Word merge(Word a, Word b) {
    return make_uint2(__vmaxu4(a.x, b.x), __vmaxu4(a.y, b.y));
  }
  __device__ static __forceinline__ void stats(Word a, Sum* s, int* z) {
    repro::add_word_stats(a.x, s, z);
    repro::add_word_stats(a.y, s, z);
  }
  __device__ static __forceinline__ float finish(Sum s) {
    return static_cast<float>(s);
  }
};

template <>
struct RowWord<true> {
  using Word = uint32_t;  // eight 4-bit registers
  using Sum = uint32_t;
  static constexpr int kShift = 2;
  __device__ static __forceinline__ Word zero() { return 0u; }
  __device__ static __forceinline__ Word merge(Word a, Word b) {
    return repro::nib_max4(a, b);
  }
  __device__ static __forceinline__ void stats(Word a, Sum* s, int* z) {
    repro::add_lane_stats<true>(a, s, z);
  }
  __device__ static __forceinline__ float finish(Sum s) {
    return repro::Harmonic<true>::finish(s);
  }
};

// width: bytes per row (r, or r / 2 packed), a power of two >= 8.
template <bool kPacked>
__global__ void union_estimate_kernel(const uint8_t* __restrict__ regs,
                                      const int32_t* __restrict__ ids,
                                      const uint8_t* __restrict__ mask,
                                      float* __restrict__ out, int64_t n_sets,
                                      int64_t n_rows, int lanes, int width) {
  using R = RowWord<kPacked>;
  using Word = typename R::Word;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t set = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (set >= n_sets) return;  // whole warp leaves; no block barrier below
  const int32_t* set_ids = ids + set * lanes;
  const uint8_t* set_mask = mask + set * lanes;
  const int words = width >> R::kShift;
  typename R::Sum s = 0;
  int z = 0;
  for (int w0 = 0; w0 < words; w0 += 32) {
    const int w = w0 + lane;
    Word acc = R::zero();
    for (int g = 0; g < lanes; g += 32) {
      const bool mine = g + lane < lanes;
      const int row =
          mine ? static_cast<int>(repro::clamp_row(set_ids[g + lane], n_rows))
               : 0;
      unsigned live = __ballot_sync(kFull, mine && set_mask[g + lane] != 0);
      while (live != 0u) {  // uniform across the warp
        const int j = __ffs(live) - 1;
        live &= live - 1u;
        const int src = __shfl_sync(kFull, row, j);
        if (w < words) {
          const Word v = reinterpret_cast<const Word*>(
              regs + static_cast<int64_t>(src) * width)[w];
          acc = R::merge(acc, v);
        }
      }
    }
    if (w < words) R::stats(acc, &s, &z);
  }
  s = repro::warp_sum(s);
  z = repro::warp_sum(z);
  if (lane == 0) {
    out[2 * set] = R::finish(s);
    out[2 * set + 1] = static_cast<float>(z);
  }
}

template <bool kPacked>
int launch(const uint8_t* regs, const int32_t* ids, const uint8_t* mask,
           float* out, int64_t n_sets, int64_t n_rows, int lanes, int width,
           cudaStream_t stream) {
  if (n_sets == 0) return 0;
  const int64_t blocks = (n_sets + kWarps - 1) / kWarps;
  union_estimate_kernel<kPacked>
      <<<static_cast<unsigned int>(blocks), kWarps * 32, 0, stream>>>(
          regs, ids, mask, out, n_sets, n_rows, lanes, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int union_estimate_stats(const uint8_t* regs, const int32_t* ids,
                                    const uint8_t* mask, float* out,
                                    int64_t n_sets, int64_t n_rows, int lanes,
                                    int r, cudaStream_t stream) {
  return launch<false>(regs, ids, mask, out, n_sets, n_rows, lanes, r,
                       stream);
}

// r: registers per row; the packed row is r / 2 bytes (r >= 16).
extern "C" int union_estimate_stats_packed(const uint8_t* regs,
                                           const int32_t* ids,
                                           const uint8_t* mask, float* out,
                                           int64_t n_sets, int64_t n_rows,
                                           int lanes, int r,
                                           cudaStream_t stream) {
  return launch<true>(regs, ids, mask, out, n_sets, n_rows, lanes, r >> 1,
                      stream);
}
