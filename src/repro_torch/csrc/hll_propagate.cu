// hll_propagate: one Algorithm 2 pass, row gather-max over edges.
//
// Replaces repro/kernels/hll_propagate.py `hll_propagate` (the Pallas
// kernel): out starts as a copy of regs (the wrapper clones it), then for
// every directed edge e, out[dst[e]] = max(out[dst[e]], regs[src[e]]),
// always reading the frozen input panel D^{t-1}, never out. An in-place
// merge would let one pass reach two hops.
//
// What bounds it on the H100: scattered row traffic. Each edge reads a
// whole source row (r bytes) and read-modify-writes a whole destination
// row, both at random places in panels far larger than L2, so the pass
// moves about 2 * E * r bytes against a panel of V * r; the bytes bound of
// reading regs, src and dst once and writing out once is far lower.
//
// Design: one thread per (edge, 32-bit word of the row), so a row's words
// go to neighbouring threads and each row access is one coalesced run of
// r bytes. The word of regs[src] is merged into out[dst] with a
// compare-and-swap loop on __vmaxu4 (four byte-wise maxima at once), and
// the atomic is skipped when the merge would change nothing, which is
// most of the time once sketches saturate. A zero source word and a
// self-edge (including the (0, 0) padding slots) are no-ops and skipped.
//
// Packed layout (hll_propagate_packed): the row is r/2 bytes, so a 32-bit
// word holds eight 4-bit registers and a row half as many words; the merge
// is repro::nib_max4 (a byte-wise max would be wrong on packed bytes).
// Both skips stay valid: a zero word is the empty row in both layouts, and
// merged == old means no nibble grew.
#include "common.cuh"

namespace {

template <bool kPacked>
__device__ __forceinline__ uint32_t merge_word(uint32_t a, uint32_t b) {
  return kPacked ? repro::nib_max4(a, b) : __vmaxu4(a, b);
}

template <bool kPacked>
__global__ void hll_propagate_kernel(const uint32_t* __restrict__ regs,
                                     uint32_t* __restrict__ out,
                                     const int32_t* __restrict__ src,
                                     const int32_t* __restrict__ dst,
                                     int64_t n_edges, int64_t n_rows,
                                     int word_shift) {
  const int64_t words = static_cast<int64_t>(1) << word_shift;
  const int64_t total = n_edges << word_shift;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int64_t e = i >> word_shift;
    const int64_t w = i & (words - 1);
    const int64_t s = src[e];
    const int64_t d = dst[e];
    if (s == d || s < 0 || d < 0 || s >= n_rows || d >= n_rows) continue;
    const uint32_t v = regs[(s << word_shift) + w];
    if (v == 0u) continue;
    uint32_t* o = out + (d << word_shift) + w;
    uint32_t old = *o;
    for (;;) {
      const uint32_t merged = merge_word<kPacked>(old, v);
      if (merged == old) break;
      const uint32_t seen = atomicCAS(o, old, merged);
      if (seen == old) break;
      old = seen;
    }
  }
}

// width: bytes per row, a power of two >= 8.
template <bool kPacked>
int launch(const uint8_t* regs, uint8_t* out, const int32_t* src,
           const int32_t* dst, int64_t n_edges, int64_t n_rows, int width,
           cudaStream_t stream) {
  if (n_edges == 0) return 0;
  int word_shift = 0;
  while ((4 << word_shift) < width) ++word_shift;
  constexpr int kThreads = 256;
  hll_propagate_kernel<kPacked>
      <<<repro::grid_for(n_edges << word_shift, kThreads), kThreads, 0,
         stream>>>(reinterpret_cast<const uint32_t*>(regs),
                   reinterpret_cast<uint32_t*>(out), src, dst, n_edges,
                   n_rows, word_shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hll_propagate(const uint8_t* regs, uint8_t* out,
                             const int32_t* src, const int32_t* dst,
                             int64_t n_edges, int64_t n_rows, int r,
                             cudaStream_t stream) {
  return launch<false>(regs, out, src, dst, n_edges, n_rows, r, stream);
}

// r: registers per row; the packed row is r / 2 bytes (r >= 16).
extern "C" int hll_propagate_packed(const uint8_t* regs, uint8_t* out,
                                    const int32_t* src, const int32_t* dst,
                                    int64_t n_edges, int64_t n_rows, int r,
                                    cudaStream_t stream) {
  return launch<true>(regs, out, src, dst, n_edges, n_rows, r >> 1, stream);
}
