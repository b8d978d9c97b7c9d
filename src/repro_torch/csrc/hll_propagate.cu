// hll_propagate: one Algorithm 2 pass, a row gather-max over a dst-sorted
// edge routing.
//
// Replaces repro/kernels/hll_propagate.py `hll_propagate` (the Pallas
// kernel): out starts as a copy of regs (the wrapper clones it), then for
// every directed edge e, out[dst[e]] = max(out[dst[e]], regs[src[e]]),
// always reading the frozen input panel D^{t-1}, never out. An in-place
// merge would let one pass reach two hops.
//
// What bounds it on the H100: scattered row reads. Each edge gathers a
// whole source row (r bytes) from a panel far larger than L2 (1 GiB at
// 4M vertices, p=8), so the pass reads about E * r bytes at random; the
// bytes bound of reading regs, src and dst once and writing out once is
// far lower. A push (one thread per edge word, a compare-and-swap into
// out[dst]) also read-modify-writes the destination row per edge, which
// doubles those bytes, and a hub's in-edges contend on the same words.
//
// Design: a pull over a routing sorted by dst (the wrapper checks the
// order; kernels/hll_propagate.py `sort_routing` builds it), which halves
// those bytes: each destination row is read once and written at most
// once. The sorted list is cut into fixed runs of kRunEdges edges, one run
// per group of lanes, so a hub whose in-degree runs to tens of thousands
// is spread over many groups and every group does the same work. A group
// is a whole warp for rows of 128 to 512 bytes (4-, 8- or 16-byte lanes:
// one warp load per edge), so a warp never diverges on its segment ends;
// rows wider than 512 bytes are walked in 512-byte chunks of 16-byte
// lanes, and rows narrower than 128 bytes take sub-warp groups of one
// four-byte lane per row word. The group walks its run in order and keeps the running
// maximum of the current destination's in-rows in registers, loading
// kBatch source rows before it folds any (several loads in flight per
// lane). At the end of each destination segment:
//   - a segment wholly inside the run owns out[d]: one plain store of
//     max(regs[d], acc), skipped when nothing grew;
//   - a segment that crosses the run's start or end shares out[d] with
//     the neighbouring run: each word is merged with a compare-and-swap
//     loop, skipped when the word is zero or the merge changes nothing.
// So atomics appear only at run ends, and the result does not depend on
// the order of the merges (max is commutative and idempotent). A
// self-edge (including the (0, 0) padding slots) loads nothing.
//
// Packed layout (hll_propagate_packed): the row is r/2 bytes, a 32-bit
// word holds eight 4-bit registers, and the merge is repro::nib_max4 (a
// byte-wise max would be wrong on packed bytes). Both skips stay valid:
// a zero word is the empty row in both layouts, and merged == old means
// no nibble grew.
//
// Two panels (hll_propagate_into, hll_propagate_into_packed): the port's
// kernel for repro/kernels/packing.py `scatter_max_rows`, the plain jnp
// merge step of the sharded schedules (a ring step's in-flight block, an
// all-gathered panel, a replica pre-pass), which has no Pallas kernel.
// out[dst[e]] = max(out[dst[e]], src_panel[src[e]]) in place, over the
// same dst-sorted runs and segments. Three things differ, and the
// template's kInto switches them: the base of a segment's store is
// out[d] itself (read with a plain load: only this group writes it), not
// a frozen copy; src indexes src_panel (n_src rows) and dst indexes out
// (n_out rows), two different vertex sets, so src == dst is a real edge
// and nothing is skipped; and src_panel must be another allocation than
// out (the wrapper checks), so the read-only path may cache it.
#include "common.cuh"

namespace {

// Directed edges a group walks, and source rows a lane loads before it
// folds them: chosen by measurement on the H100
// (scripts/sweep_propagate.py; PERF.md).
constexpr int64_t kRunEdges = 1024;
constexpr int kBatch = 8;
constexpr int kThreads = 256;

template <int kWords>
struct Vec {
  uint32_t w[kWords];
};

template <int kWords>
__device__ __forceinline__ Vec<kWords> zero_vec() {
  Vec<kWords> v;
#pragma unroll
  for (int i = 0; i < kWords; ++i) v.w[i] = 0u;
  return v;
}

// 16-, 8- or 4-byte read (kWords = 4, 2, 1) of the frozen panel.
template <int kWords>
__device__ __forceinline__ Vec<kWords> load_vec(const uint32_t* p) {
  Vec<kWords> v;
  if constexpr (kWords == 4) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    v.w[0] = x.x;
    v.w[1] = x.y;
    v.w[2] = x.z;
    v.w[3] = x.w;
  } else if constexpr (kWords == 2) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    v.w[0] = x.x;
    v.w[1] = x.y;
  } else {
    v.w[0] = __ldg(p);
  }
  return v;
}

template <int kWords>
__device__ __forceinline__ void store_vec(uint32_t* p, const Vec<kWords>& v) {
  if constexpr (kWords == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  } else if constexpr (kWords == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v.w[0], v.w[1]);
  } else {
    *p = v.w[0];
  }
}

template <bool kPacked, int kWords>
__device__ __forceinline__ void merge_vec(Vec<kWords>* acc,
                                          const Vec<kWords>& v) {
#pragma unroll
  for (int i = 0; i < kWords; ++i)
    acc->w[i] = repro::reg_max<kPacked>(acc->w[i], v.w[i]);
}

// Plain (coherent) read of kWords words of out: the two-panel kernel
// reads the base of a segment it owns from the panel it writes.
template <int kWords>
__device__ __forceinline__ Vec<kWords> load_out(const uint32_t* p) {
  Vec<kWords> v;
  if constexpr (kWords == 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    v.w[0] = x.x;
    v.w[1] = x.y;
    v.w[2] = x.z;
    v.w[3] = x.w;
  } else if constexpr (kWords == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    v.w[0] = x.x;
    v.w[1] = x.y;
  } else {
    v.w[0] = *p;
  }
  return v;
}

// Folds the segment maximum `acc` of destination d into out[d] (this
// lane's kWords words at `off`). `shared`: the segment crosses a run end.
// The base is the frozen regs[d] (out starts as its copy), or with kInto
// out[d] itself.
template <bool kPacked, bool kInto, int kWords>
__device__ __forceinline__ void flush(const uint32_t* __restrict__ regs,
                                      uint32_t* __restrict__ out, int64_t d,
                                      int64_t n_rows, int64_t row_words,
                                      int64_t off, const Vec<kWords>& acc,
                                      bool shared) {
  if (d < 0 || d >= n_rows) return;
  uint32_t* o = out + d * row_words + off;
  if (!shared) {
    const Vec<kWords> old =
        kInto ? load_out<kWords>(o)
              : load_vec<kWords>(regs + d * row_words + off);
    Vec<kWords> merged = old;
    merge_vec<kPacked>(&merged, acc);
    bool grew = false;
#pragma unroll
    for (int i = 0; i < kWords; ++i) grew |= merged.w[i] != old.w[i];
    if (grew) store_vec(o, merged);
    return;
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint32_t v = acc.w[i];
    if (v == 0u) continue;
    uint32_t old = o[i];
    for (;;) {
      const uint32_t merged = repro::reg_max<kPacked>(old, v);
      if (merged == old) break;
      const uint32_t seen = atomicCAS(o + i, old, merged);
      if (seen == old) break;
      old = seen;
    }
  }
}

// lanes: lanes per group (a power of two <= 32); chunks: row chunks of
// lanes * kWords words. dst must be non-decreasing. regs has n_src rows
// and out n_rows (the same panel shape unless kInto).
template <bool kPacked, bool kInto, int kWords>
__global__ void __launch_bounds__(kThreads)
    hll_propagate_kernel(const uint32_t* __restrict__ regs,
                         uint32_t* __restrict__ out,
                         const int32_t* __restrict__ src,
                         const int32_t* __restrict__ dst, int64_t n_edges,
                         int64_t n_src, int64_t n_rows, int64_t row_words,
                         int lanes, int64_t chunks) {
  const int lane = threadIdx.x & 31;
  const int groups_per_warp = 32 / lanes;
  const int64_t group =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32 *
          groups_per_warp +
      lane / lanes;
  const int64_t n_groups =
      static_cast<int64_t>(gridDim.x) * blockDim.x / 32 * groups_per_warp;
  const int64_t n_runs = (n_edges + kRunEdges - 1) / kRunEdges;
  const int64_t lane_off = static_cast<int64_t>(lane % lanes) * kWords;
  for (int64_t run = group; run < n_runs; run += n_groups) {
    const int64_t e0 = run * kRunEdges;
    const int64_t e1 = e0 + kRunEdges < n_edges ? e0 + kRunEdges : n_edges;
    const int32_t d_first = dst[e0];
    const int32_t d_last = dst[e1 - 1];
    // the first (last) segment continues into the previous (next) run
    const bool open_lo = e0 > 0 && dst[e0 - 1] == d_first;
    const bool open_hi = e1 < n_edges && dst[e1] == d_last;
    for (int64_t c = 0; c < chunks; ++c) {
      const int64_t off = c * lanes * kWords + lane_off;
      int32_t cur = d_first;
      Vec<kWords> acc = zero_vec<kWords>();
      for (int64_t e = e0; e < e1; e += kBatch) {
        Vec<kWords> rows[kBatch];
        int32_t ds[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          rows[b] = zero_vec<kWords>();
          ds[b] = -1;
          if (e + b < e1) {
            const int32_t s = src[e + b];
            ds[b] = dst[e + b];
            if ((kInto || s != ds[b]) && s >= 0 && s < n_src)
              rows[b] = load_vec<kWords>(
                  regs + static_cast<int64_t>(s) * row_words + off);
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (e + b >= e1) break;
          if (ds[b] != cur) {
            flush<kPacked, kInto>(regs, out, cur, n_rows, row_words, off,
                                  acc, open_lo && cur == d_first);
            cur = ds[b];
            acc = zero_vec<kWords>();
          }
          merge_vec<kPacked>(&acc, rows[b]);
        }
      }
      flush<kPacked, kInto>(regs, out, cur, n_rows, row_words, off, acc,
                            (open_lo && cur == d_first) ||
                                (open_hi && cur == d_last));
    }
  }
}

template <bool kPacked, bool kInto, int kWords>
void launch_words(const uint32_t* regs, uint32_t* out, const int32_t* src,
                  const int32_t* dst, int64_t n_edges, int64_t n_src,
                  int64_t n_rows, int64_t row_words, cudaStream_t stream) {
  const int64_t lanes64 = row_words / kWords < 32 ? row_words / kWords : 32;
  const int lanes = static_cast<int>(lanes64);
  const int64_t chunks = row_words / (lanes64 * kWords);
  const int64_t n_runs = (n_edges + kRunEdges - 1) / kRunEdges;
  // a run takes `lanes` threads
  hll_propagate_kernel<kPacked, kInto, kWords>
      <<<repro::grid_for(n_runs * lanes, kThreads), kThreads, 0, stream>>>(
          regs, out, src, dst, n_edges, n_src, n_rows, row_words, lanes,
          chunks);
}

// width: bytes per row, a power of two >= 8. regs has n_src rows, out
// n_rows.
template <bool kPacked, bool kInto>
int launch(const uint8_t* regs, uint8_t* out, const int32_t* src,
           const int32_t* dst, int64_t n_edges, int64_t n_src,
           int64_t n_rows, int width, cudaStream_t stream) {
  if (n_edges == 0) return 0;
  const auto* r = reinterpret_cast<const uint32_t*>(regs);
  auto* o = reinterpret_cast<uint32_t*>(out);
  const int64_t row_words = width / 4;
  // one warp per row up to 512 bytes (4-, 8- or 16-byte lanes), 16-byte
  // lanes in 512-byte chunks beyond (the wrapper checks that the panel is
  // 16-byte aligned)
  const int words = row_words >= 128 ? 4 : (row_words >= 64 ? 2 : 1);
  if (words == 4) {
    launch_words<kPacked, kInto, 4>(r, o, src, dst, n_edges, n_src, n_rows,
                                    row_words, stream);
  } else if (words == 2) {
    launch_words<kPacked, kInto, 2>(r, o, src, dst, n_edges, n_src, n_rows,
                                    row_words, stream);
  } else {
    launch_words<kPacked, kInto, 1>(r, o, src, dst, n_edges, n_src, n_rows,
                                    row_words, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hll_propagate(const uint8_t* regs, uint8_t* out,
                             const int32_t* src, const int32_t* dst,
                             int64_t n_edges, int64_t n_rows, int r,
                             cudaStream_t stream) {
  return launch<false, false>(regs, out, src, dst, n_edges, n_rows, n_rows, r,
                              stream);
}

// r: registers per row; the packed row is r / 2 bytes (r >= 16).
extern "C" int hll_propagate_packed(const uint8_t* regs, uint8_t* out,
                                    const int32_t* src, const int32_t* dst,
                                    int64_t n_edges, int64_t n_rows, int r,
                                    cudaStream_t stream) {
  return launch<true, false>(regs, out, src, dst, n_edges, n_rows, n_rows,
                             r >> 1, stream);
}

// out (n_out rows) max= src_panel (n_src rows) over a dst-sorted routing,
// in place.
extern "C" int hll_propagate_into(const uint8_t* src_panel, uint8_t* out,
                                  const int32_t* src, const int32_t* dst,
                                  int64_t n_edges, int64_t n_src,
                                  int64_t n_out, int r, cudaStream_t stream) {
  return launch<false, true>(src_panel, out, src, dst, n_edges, n_src, n_out,
                             r, stream);
}

extern "C" int hll_propagate_into_packed(const uint8_t* src_panel,
                                         uint8_t* out, const int32_t* src,
                                         const int32_t* dst, int64_t n_edges,
                                         int64_t n_src, int64_t n_out, int r,
                                         cudaStream_t stream) {
  return launch<true, true>(src_panel, out, src, dst, n_edges, n_src, n_out,
                            r >> 1, stream);
}
