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
// Design: one warp per pair, eight pairs per block. Each lane reads both
// rows a 32-bit word at a time (one 128-byte request per warp step; the
// wrapper guarantees r >= 8 and an 8-byte-aligned panel), so each row is
// read once. The five histograms are built with shared-memory
// integer atomics in a 5*(q+2) slice per warp (q + 2 = 66 - p bins, sized
// at launch from q; repro::eq19_add, shared with ertl_stats.cu), then
// written out as float32; the three (s, z) pairs are reduced with warp
// shuffles. Register values outside [0, q+2) count in no bin, as a
// one-hot over arange(q + 2) would.
//
// Packed layout (intersection_stats_packed): rows of r/2 bytes, each
// 32-bit word split into its eight nibbles in registers (p=8: one word
// per lane). The three harmonic sums are kept exactly as integers
// sum 2^(15 - x) and rounded to float once (repro::Harmonic<true>), so
// they equal the plain version bit for bit. Bins 16..q+1 stay empty: a
// packed register is at most 15.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

template <bool kPacked>
struct PairSums {
  using H = repro::Harmonic<kPacked>;
  typename H::Sum sa, sb, su;
  int za, zb, zu;

  __device__ __forceinline__ void add(uint32_t x, uint32_t y, int nb,
                                      int* hist) {
    repro::eq19_add(x, y, nb, hist);
    const uint32_t u = x > y ? x : y;
    sa += H::term(x);
    sb += H::term(y);
    su += H::term(u);
    za += x == 0u;
    zb += y == 0u;
    zu += u == 0u;
  }
};

// width: bytes per row (r, or r / 2 packed), a power of two >= 8.
template <bool kPacked>
__global__ void intersection_stats_kernel(const uint8_t* __restrict__ regs,
                                          const int32_t* __restrict__ pa,
                                          const int32_t* __restrict__ pb,
                                          float* __restrict__ stats,
                                          float* __restrict__ sz,
                                          int64_t n_pairs, int64_t n_rows,
                                          int width, int q) {
  using L = repro::Lanes<kPacked>;
  using H = repro::Harmonic<kPacked>;
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
  // callers validate ids; clamp like a jnp gather so a stray id stays in
  // bounds
  const int64_t ia = repro::clamp_row(pa[pair], n_rows);
  const int64_t ib = repro::clamp_row(pb[pair], n_rows);
  PairSums<kPacked> t = {};
  const uint32_t* wa = reinterpret_cast<const uint32_t*>(regs + ia * width);
  const uint32_t* wb = reinterpret_cast<const uint32_t*>(regs + ib * width);
  for (int i = lane; i < (width >> 2); i += 32) {
    const uint32_t va = wa[i];
    const uint32_t vb = wb[i];
#pragma unroll
    for (int k = 0; k < L::kPerWord; ++k)
      t.add((va >> (L::kBits * k)) & L::kMask,
            (vb >> (L::kBits * k)) & L::kMask, nb, hist);
  }
  t.sa = repro::warp_sum(t.sa);
  t.sb = repro::warp_sum(t.sb);
  t.su = repro::warp_sum(t.su);
  t.za = repro::warp_sum(t.za);
  t.zb = repro::warp_sum(t.zb);
  t.zu = repro::warp_sum(t.zu);
  __syncwarp();
  float* out = stats + pair * hsize;
  for (int i = lane; i < hsize; i += 32) out[i] = static_cast<float>(hist[i]);
  if (lane == 0) {
    float* o = sz + pair * 6;
    o[0] = H::finish(t.sa);
    o[1] = static_cast<float>(t.za);
    o[2] = H::finish(t.sb);
    o[3] = static_cast<float>(t.zb);
    o[4] = H::finish(t.su);
    o[5] = static_cast<float>(t.zu);
  }
}

template <bool kPacked>
int launch(const uint8_t* regs, const int32_t* pa, const int32_t* pb,
           float* stats, float* sz, int64_t n_pairs, int64_t n_rows,
           int width, int q, cudaStream_t stream) {
  if (n_pairs == 0) return 0;
  const size_t smem = static_cast<size_t>(kWarps) * 5 * (q + 2) * sizeof(int);
  const int64_t blocks = (n_pairs + kWarps - 1) / kWarps;
  intersection_stats_kernel<kPacked>
      <<<static_cast<unsigned int>(blocks), kWarps * 32, smem, stream>>>(
          regs, pa, pb, stats, sz, n_pairs, n_rows, width, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int intersection_stats(const uint8_t* regs, const int32_t* pa,
                                  const int32_t* pb, float* stats, float* sz,
                                  int64_t n_pairs, int64_t n_rows, int r,
                                  int q, cudaStream_t stream) {
  return launch<false>(regs, pa, pb, stats, sz, n_pairs, n_rows, r, q,
                       stream);
}

// r: registers per row; the packed row is r / 2 bytes (r >= 16).
extern "C" int intersection_stats_packed(const uint8_t* regs,
                                         const int32_t* pa, const int32_t* pb,
                                         float* stats, float* sz,
                                         int64_t n_pairs, int64_t n_rows,
                                         int r, int q, cudaStream_t stream) {
  return launch<true>(regs, pa, pb, stats, sz, n_pairs, n_rows, r >> 1, q,
                      stream);
}
