// intersection_stats: fused per-pair statistics for the T~(xy) estimator.
//
// Replaces repro/kernels/intersection_stats.py `intersection_stats` (the
// Pallas kernel). For each pair (a, b) = (regs[pa], regs[pb]) it writes
//   stats[pair, 5, q+2]: the Eq. 19 count histograms over register value k,
//     [a<b counted at a, a>b at a, b<a at b, b>a at b, a==b at a];
//   sz[pair, 3, 2]: (sum 2^-x, #zeros) of A, B and max(A, B),
// everything the MLE / inclusion-exclusion tail reads, so the gathered
// rows never go back to device memory.
//
// What bounds it on the H100: bytes. Two gathered rows are read per pair
// (2r bytes) and 5(q+2)+6 floats written, about 1.7 KB per pair at p=8,
// with a few integer operations per register.
//
// Design: a group of g lanes per pair (p=8: 16 lanes, two pairs a warp;
// packed 8 lanes, four pairs), each lane loading kLoads 16-byte vectors of
// both rows before it counts any, on a persistent grid of at most
// kBlocksPerSM blocks per SM. A warp takes at most the launcher's
// `max_pairs` pairs at once (1, 2, 4 or 8; kernels/autotune.py holds the
// default, 4, and the sweep): a narrow row takes more lanes a pair rather
// than more pairs. It is read at launch only. Each warp holds its pairs' 5(q+2) bins in
// shared memory. Per 32-bit word:
// * the zeros of A, B and A∪B are counted with one carry-free add and a
//   popcount each (repro::nonzero_regs), and the three bins at value 0
//   that take the zero registers, [a<b at a=0], [b<a at b=0] and
//   [a==b at 0], are set from those counts by one lane a pair
//   (#(a=0<b) = zA - zU, #(b=0<a) = zB - zU, #(a=b=0) = zU), so zero
//   registers take no atomic;
// * every other register pair takes one or two shared atomics
//   (eq19_add_nonzero); aggregating equal bins first
//   (__match_any_sync) measured 1.6-2.5x slower on an H100;
// * (s, z) of A, B and A∪B are exact (repro::add_vec_stats: fixed point,
//   rounded to float32 once), so sz[:, 0, 0] equals hll_estimate_stats of
//   row pa bit for bit whatever the lanes' layout.
// A warp zeroes its bins while its pairs' first loads are in flight and
// writes them back with 16-byte stores, which need not finish before it
// goes on to its next pairs. Register values outside [0, q+2) count in no
// bin, as a one-hot over arange(q + 2) would.
//
// Packed layout (intersection_stats_packed): rows of r/2 bytes, eight
// 4-bit registers a word, merged with repro::nib_max4; the sums are the
// exact integers sum 2^(15 - x) rounded to float once, so they equal the
// plain version bit for bit. Bins 16..q+1 stay empty: a packed register
// is at most 15.
#include "common.cuh"

namespace {

// Design constants, swept on the card by scripts/sweep_pairsets.py.
constexpr int kVecBytes = 16;        // load width (8 where alignment forbids)
constexpr int kLoads = 1;            // vectors of each row in flight a lane
constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;      // persistent grid
constexpr int kMinBlocks = 4;        // blocks an SM must hold (caps registers)
// false skips the histogram atomics: a timing ablation, output unchecked
constexpr bool kHistAtomics = true;

constexpr unsigned kFull = 0xFFFFFFFFu;

// Eq. 19 update of one register pair (x, y), nb = q + 2 bins a
// histogram, one shared atomic per bin hit; the bins at value 0
// ([x<y at x=0], [y<x at y=0], [x==y at 0]) are left out: the caller
// sets them from the zero counts.
__device__ __forceinline__ void eq19_add_nonzero(uint32_t x, uint32_t y,
                                                 uint32_t nb, int* hist) {
  if (x < y) {
    if (x != 0u && x < nb) atomicAdd(hist + x, 1);
    if (y < nb) atomicAdd(hist + 3 * nb + y, 1);
  } else if (x > y) {
    if (x < nb) atomicAdd(hist + nb + x, 1);
    if (y != 0u && y < nb) atomicAdd(hist + 2 * nb + y, 1);
  } else if (x != 0u && x < nb) {
    atomicAdd(hist + 4 * nb + x, 1);
  }
}

// Counts the register pairs of words a and b in hist.
template <bool kPacked>
__device__ __forceinline__ void count_word(uint32_t a, uint32_t b,
                                           uint32_t nb, int* hist) {
  using L = repro::Lanes<kPacked>;
#pragma unroll
  for (int k = 0; k < L::kPerWord; ++k) {
    eq19_add_nonzero((a >> (L::kBits * k)) & L::kMask,
                     (b >> (L::kBits * k)) & L::kMask, nb, hist);
  }
}

// Exact (s, z) sums of one row: see repro::add_vec_stats.
struct RowSums {
  unsigned long long fix;
  double tiny;
  int nz;
};

// row_vecs: kVec-byte vectors per row; g = 1 << g_log2 lanes per pair;
// regs_per_row: registers per row; slice: ints of shared bins per warp (a
// multiple of 4): the warp's pairs' 5 * (q + 2) bins, back to back.
template <bool kPacked, int kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    intersection_stats_kernel(const uint8_t* __restrict__ regs,
                              const int32_t* __restrict__ pa,
                              const int32_t* __restrict__ pb,
                              float* __restrict__ stats,
                              float* __restrict__ sz, int64_t n_pairs,
                              int64_t n_rows, int row_vecs, int g_log2,
                              int regs_per_row, int q, int slice) {
  using V = repro::Vec<kVec>;
  using T = typename V::T;
  extern __shared__ int4 bins_all[];
  const uint32_t nb = static_cast<uint32_t>(q + 2);
  const int hsize = 5 * (q + 2);
  const int g = 1 << g_log2;
  const int per_warp = 32 >> g_log2;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (g - 1);
  const int slot = lane >> g_log2;
  int4* bins4 = bins_all + (threadIdx.x >> 5) * (slice >> 2);
  int* bins = reinterpret_cast<int*>(bins4);
  int* hist = bins + slot * hsize;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const T* vecs = reinterpret_cast<const T*>(regs);
  const int step = g * kLoads;
  // `first` is warp-uniform, so every lane reaches the collectives below
  for (int64_t first = warp * per_warp; first < n_pairs;
       first += warps * per_warp) {
    const int64_t pair = first + slot;
    const bool mine = pair < n_pairs;
    // callers validate ids; clamp like a jnp gather so a stray id stays
    // in bounds
    const T* va = vecs + (mine ? repro::clamp_row(pa[pair], n_rows) : 0) *
                             static_cast<int64_t>(row_vecs);
    const T* vb = vecs + (mine ? repro::clamp_row(pb[pair], n_rows) : 0) *
                             static_cast<int64_t>(row_vecs);
    T next_a[kLoads], next_b[kLoads];
    auto load = [&](int i) {
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        if (i + j * g < row_vecs) {
          next_a[j] = va[i + j * g];
          next_b[j] = vb[i + j * g];
        }
      }
    };
    if (mine) load(sub);
    // zero the warp's bins while the first loads are in flight
    for (int i = lane; i < (slice >> 2); i += 32) {
      bins4[i] = make_int4(0, 0, 0, 0);
    }
    __syncwarp();
    RowSums sa = {0, 0.0, 0}, sb = {0, 0.0, 0}, su = {0, 0.0, 0};
    for (int i0 = 0; i0 < row_vecs; i0 += step) {
      const int i = i0 + sub;
      T cur_a[kLoads], cur_b[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        cur_a[j] = next_a[j];
        cur_b[j] = next_b[j];
      }
      if (mine && i + step < row_vecs) load(i + step);
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const bool valid = mine && i + j * g < row_vecs;
        if (valid) {
          const T u = repro::reg_max<kPacked>(cur_a[j], cur_b[j]);
          repro::add_vec_stats<kPacked, kVec>(cur_a[j], &sa.fix, &sa.tiny,
                                              &sa.nz);
          repro::add_vec_stats<kPacked, kVec>(cur_b[j], &sb.fix, &sb.tiny,
                                              &sb.nz);
          repro::add_vec_stats<kPacked, kVec>(u, &su.fix, &su.tiny, &su.nz);
        }
        if (kHistAtomics && valid) {
#pragma unroll
          for (int k = 0; k < kVec / 4; ++k) {
            count_word<kPacked>(V::word(cur_a[j], k), V::word(cur_b[j], k),
                                nb, hist);
          }
        }
      }
    }
    // the group's sums; the tails only where a byte above 27 showed up
    for (int o = g >> 1; o > 0; o >>= 1) {
      sa.fix += __shfl_xor_sync(kFull, sa.fix, o);
      sb.fix += __shfl_xor_sync(kFull, sb.fix, o);
      su.fix += __shfl_xor_sync(kFull, su.fix, o);
      sa.nz += __shfl_xor_sync(kFull, sa.nz, o);
      sb.nz += __shfl_xor_sync(kFull, sb.nz, o);
      su.nz += __shfl_xor_sync(kFull, su.nz, o);
    }
    if (!kPacked && __any_sync(kFull, sa.tiny != 0.0 || sb.tiny != 0.0 ||
                                          su.tiny != 0.0)) {
      for (int o = g >> 1; o > 0; o >>= 1) {
        sa.tiny += __shfl_xor_sync(kFull, sa.tiny, o);
        sb.tiny += __shfl_xor_sync(kFull, sb.tiny, o);
        su.tiny += __shfl_xor_sync(kFull, su.tiny, o);
      }
    }
    if (mine && sub == 0) {
      const int za = regs_per_row - sa.nz;
      const int zb = regs_per_row - sb.nz;
      const int zu = regs_per_row - su.nz;
      // the bins at value 0 (no atomic touches them)
      hist[0] = za - zu;
      hist[2 * nb] = zb - zu;
      hist[4 * nb] = zu;
      float2* o = reinterpret_cast<float2*>(sz + pair * 6);
      o[0] = make_float2(repro::harmonic_finish<kPacked>(sa.fix, sa.tiny),
                         static_cast<float>(za));
      o[1] = make_float2(repro::harmonic_finish<kPacked>(sb.fix, sb.tiny),
                         static_cast<float>(zb));
      o[2] = make_float2(repro::harmonic_finish<kPacked>(su.fix, su.tiny),
                         static_cast<float>(zu));
    }
    __syncwarp();
    // write the warp's pairs' bins back, contiguous in stats: scalars up
    // to a 16-byte boundary, then 16-byte stores
    auto bin = [&](int i) { return static_cast<float>(bins[i]); };
    const int64_t left = n_pairs - first;
    const int total = (left < per_warp ? static_cast<int>(left) : per_warp) *
                      hsize;
    float* out = stats + first * hsize;
    const int head = min(
        total, static_cast<int>((16u - (reinterpret_cast<uintptr_t>(out) &
                                        15u)) & 15u) >> 2);
    if (lane < head) out[lane] = bin(lane);
    const int body = (total - head) >> 2;
    float4* out4 = reinterpret_cast<float4*>(out + head);
    for (int c = lane; c < body; c += 32) {
      const int i = head + 4 * c;
      out4[c] = make_float4(bin(i), bin(i + 1), bin(i + 2), bin(i + 3));
    }
    for (int i = head + 4 * body + lane; i < total; i += 32) out[i] = bin(i);
    __syncwarp();  // the bins are zeroed again for the next pairs
  }
}

// max_pairs: the most pairs a warp takes at once (it caps the bins a warp
// holds): a row that leaves more lanes idle takes more lanes a pair.
template <bool kPacked, int kVec>
int launch(const uint8_t* regs, const int32_t* pa, const int32_t* pb,
           float* stats, float* sz, int64_t n_pairs, int64_t n_rows,
           int row_bytes, int regs_per_row, int q, int max_pairs,
           cudaStream_t stream) {
  constexpr auto kernel = intersection_stats_kernel<kPacked, kVec>;
  const int row_vecs = row_bytes / kVec;
  int g_log2 = repro::group_log2(row_vecs, kLoads);
  while ((32 >> g_log2) > max_pairs) ++g_log2;
  const int per_warp = 32 >> g_log2;
  const int slice = (per_warp * 5 * (q + 2) + 3) & ~3;
  const size_t smem = static_cast<size_t>(kThreads / 32) * slice * sizeof(int);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const int64_t per_block = static_cast<int64_t>(kThreads / 32) * per_warp;
  const unsigned int blocks =
      repro::persistent_grid<intersection_stats_kernel<kPacked, kVec>>(
          kThreads, (n_pairs + per_block - 1) / per_block, kBlocksPerSM,
          smem);
  kernel<<<blocks, kThreads, smem, stream>>>(regs, pa, pb, stats, sz, n_pairs,
                                             n_rows, row_vecs, g_log2,
                                             regs_per_row, q, slice);
  return static_cast<int>(cudaGetLastError());
}

// max_pairs: 1, 2, 4 or 8 (cudaErrorInvalidValue otherwise, nothing
// launched).
template <bool kPacked>
int launch_any(const uint8_t* regs, const int32_t* pa, const int32_t* pb,
               float* stats, float* sz, int64_t n_pairs, int64_t n_rows,
               int row_bytes, int regs_per_row, int q, int max_pairs,
               cudaStream_t stream) {
  if (max_pairs != 1 && max_pairs != 2 && max_pairs != 4 && max_pairs != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs == 0) return 0;
  const bool wide = kVecBytes == 16 && row_bytes % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(regs) % 16 == 0;
  return wide ? launch<kPacked, 16>(regs, pa, pb, stats, sz, n_pairs, n_rows,
                                    row_bytes, regs_per_row, q, max_pairs,
                                    stream)
              : launch<kPacked, 8>(regs, pa, pb, stats, sz, n_pairs, n_rows,
                                   row_bytes, regs_per_row, q, max_pairs,
                                   stream);
}

}  // namespace

// max_pairs: the most pairs a warp takes at once, 1, 2, 4 or 8.
extern "C" int intersection_stats(const uint8_t* regs, const int32_t* pa,
                                  const int32_t* pb, float* stats, float* sz,
                                  int64_t n_pairs, int64_t n_rows, int r,
                                  int q, int max_pairs, cudaStream_t stream) {
  return launch_any<false>(regs, pa, pb, stats, sz, n_pairs, n_rows, r, r, q,
                           max_pairs, stream);
}

// r: registers per row; the packed row is r / 2 bytes (r >= 16).
extern "C" int intersection_stats_packed(const uint8_t* regs,
                                         const int32_t* pa, const int32_t* pb,
                                         float* stats, float* sz,
                                         int64_t n_pairs, int64_t n_rows,
                                         int r, int q, int max_pairs,
                                         cudaStream_t stream) {
  return launch_any<true>(regs, pa, pb, stats, sz, n_pairs, n_rows, r >> 1, r,
                          q, max_pairs, stream);
}
