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
// is spread over many groups and every group does the same work (the run
// length is the launcher's `run_edges`, one of 256, 512, 1024 and 2048:
// each is its own instantiation, so the run arithmetic stays
// compile-time; kernels/autotune.py holds the default, 1024, and the
// sweep). A group
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
// out[dst[e]] = max(out[dst[e]], src_panel[src[e]]) in place, over
// dst-sorted runs and segments as above, with three differences: the base
// of a segment's store is out[d] itself (only this group writes it), not
// a frozen copy; src indexes src_panel (n_src rows) and dst indexes out
// (n_out rows), two different vertex sets, so src == dst is a real edge
// and nothing is skipped; and src_panel is another allocation than out
// (the wrapper checks), so the read-only path may cache it.
//
// What bounds it on the H100: latency, not bytes. The sharded schedules
// hand it short routings (a ring step of 4 shards at scale 22 is 7.9M
// edges, a replica pre-pass 3.6M), and the one-panel kernel's runs of
// 1,024 edges left fewer runs than the card holds warps: each warp walked
// its run one batch of dependent loads (index, then row) at a time. A
// ring step whose source block fits in L2 ran no faster
// (scripts/sweep_propagate.py, PERF.md), and more rows in flight per lane
// lost whenever they cost registers: warps resident, and each warp's
// chain of index, row and fold per batch, set the pace. Rows staged
// through a cp.async ring in shared memory (no registers held, the base
// copied with the segment's last row) ran 1.7-2.2x slower at every shape,
// and as slow over an L2-sized source block: the shuffles, copy groups
// and shared-memory read-back of each edge cost more than the latency
// they hid.
//
// Design (hll_propagate_into_kernel):
//   - the run length is an argument: the wrapper derives it from the edge
//     count and the SM count (kernels/hll_propagate.py `run_edges`), so
//     the grid holds several waves of runs;
//   - the registers are capped by __launch_bounds__ (kIntoMinBlocks*: 32
//     a lane on the byte layout, 40 packed) and a lane holds only
//     kIntoMaxBatch source rows in flight, so an SM holds 64 (48) warps;
//     the few spills go to L1;
//   - packed rows are folded on split nibble planes.
#include "common.cuh"

namespace {

// Source rows a lane loads before it folds them, and the block size:
// chosen by measurement on the H100 (scripts/sweep_propagate.py;
// PERF.md). The edges a group walks, kRunEdges, are a template argument
// (the launcher's run_edges).
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
// The base is the frozen regs[d] (out starts as its copy).
template <bool kPacked, int kWords>
__device__ __forceinline__ void flush(const uint32_t* __restrict__ regs,
                                      uint32_t* __restrict__ out, int64_t d,
                                      int64_t n_rows, int64_t row_words,
                                      int64_t off, const Vec<kWords>& acc,
                                      bool shared) {
  if (d < 0 || d >= n_rows) return;
  uint32_t* o = out + d * row_words + off;
  if (!shared) {
    const Vec<kWords> old = load_vec<kWords>(regs + d * row_words + off);
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
// lanes * kWords words; kRunEdges: directed edges a group walks. dst must
// be non-decreasing.
template <bool kPacked, int kWords, int kRunEdges>
__global__ void __launch_bounds__(kThreads)
    hll_propagate_kernel(const uint32_t* __restrict__ regs,
                         uint32_t* __restrict__ out,
                         const int32_t* __restrict__ src,
                         const int32_t* __restrict__ dst, int64_t n_edges,
                         int64_t n_rows, int64_t row_words, int lanes,
                         int64_t chunks) {
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
            if (s != ds[b] && s >= 0 && s < n_rows)
              rows[b] = load_vec<kWords>(
                  regs + static_cast<int64_t>(s) * row_words + off);
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (e + b >= e1) break;
          if (ds[b] != cur) {
            flush<kPacked>(regs, out, cur, n_rows, row_words, off, acc,
                           open_lo && cur == d_first);
            cur = ds[b];
            acc = zero_vec<kWords>();
          }
          merge_vec<kPacked>(&acc, rows[b]);
        }
      }
      flush<kPacked>(regs, out, cur, n_rows, row_words, off, acc,
                     (open_lo && cur == d_first) ||
                         (open_hi && cur == d_last));
    }
  }
}

template <bool kPacked, int kWords, int kRunEdges>
void launch_words(const uint32_t* regs, uint32_t* out, const int32_t* src,
                  const int32_t* dst, int64_t n_edges, int64_t n_rows,
                  int64_t row_words, cudaStream_t stream) {
  const int64_t lanes64 = row_words / kWords < 32 ? row_words / kWords : 32;
  const int lanes = static_cast<int>(lanes64);
  const int64_t chunks = row_words / (lanes64 * kWords);
  const int64_t n_runs = (n_edges + kRunEdges - 1) / kRunEdges;
  // a run takes `lanes` threads
  hll_propagate_kernel<kPacked, kWords, kRunEdges>
      <<<repro::grid_for(n_runs * lanes, kThreads), kThreads, 0, stream>>>(
          regs, out, src, dst, n_edges, n_rows, row_words, lanes, chunks);
}

// The run length's instantiation; false for a length outside the grid.
template <bool kPacked, int kWords>
bool launch_run(const uint32_t* regs, uint32_t* out, const int32_t* src,
                const int32_t* dst, int64_t n_edges, int64_t n_rows,
                int64_t row_words, int run_edges, cudaStream_t stream) {
  switch (run_edges) {
    case 256:
      launch_words<kPacked, kWords, 256>(regs, out, src, dst, n_edges,
                                         n_rows, row_words, stream);
      return true;
    case 512:
      launch_words<kPacked, kWords, 512>(regs, out, src, dst, n_edges,
                                         n_rows, row_words, stream);
      return true;
    case 1024:
      launch_words<kPacked, kWords, 1024>(regs, out, src, dst, n_edges,
                                          n_rows, row_words, stream);
      return true;
    case 2048:
      launch_words<kPacked, kWords, 2048>(regs, out, src, dst, n_edges,
                                          n_rows, row_words, stream);
      return true;
    default:
      return false;
  }
}

// width: bytes per row, a power of two >= 8; run_edges: one of 256, 512,
// 1024 and 2048 (cudaErrorInvalidValue otherwise, nothing launched).
template <bool kPacked>
int launch(const uint8_t* regs, uint8_t* out, const int32_t* src,
           const int32_t* dst, int64_t n_edges, int64_t n_rows, int width,
           int run_edges, cudaStream_t stream) {
  if (run_edges != 256 && run_edges != 512 && run_edges != 1024 &&
      run_edges != 2048)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_edges == 0) return 0;
  const auto* r = reinterpret_cast<const uint32_t*>(regs);
  auto* o = reinterpret_cast<uint32_t*>(out);
  const int64_t row_words = width / 4;
  // one warp per row up to 512 bytes (4-, 8- or 16-byte lanes), 16-byte
  // lanes in 512-byte chunks beyond (the wrapper checks that the panel is
  // 16-byte aligned)
  const int words = row_words >= 128 ? 4 : (row_words >= 64 ? 2 : 1);
  if (words == 4) {
    launch_run<kPacked, 4>(r, o, src, dst, n_edges, n_rows, row_words,
                           run_edges, stream);
  } else if (words == 2) {
    launch_run<kPacked, 2>(r, o, src, dst, n_edges, n_rows, row_words,
                           run_edges, stream);
  } else {
    launch_run<kPacked, 1>(r, o, src, dst, n_edges, n_rows, row_words,
                           run_edges, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The two-panel merge. Design constants, chosen by measurement on the H100
// (scripts/sweep_propagate.py; PERF.md): the block size; the blocks per
// SM that the register budget must allow on each layout; the registers of
// source rows a lane holds (kIntoRowRegs / kWords rows in flight, at most
// kIntoMaxBatch).
constexpr int kIntoThreads = 256;
constexpr int kIntoMinBlocksByte = 8;
constexpr int kIntoMinBlocksPacked = 6;
constexpr int kIntoRowRegs = 8;
constexpr int kIntoMaxBatch = 4;

// source rows a lane loads before it folds them
template <int kWords>
__host__ __device__ constexpr int into_batch() {
  return kIntoRowRegs / kWords >= kIntoMaxBatch
             ? kIntoMaxBatch
             : (kIntoRowRegs / kWords > 1 ? kIntoRowRegs / kWords : 1);
}

// The running maximum of one segment's source rows, kWords words. The
// packed layout keeps it as its two nibble planes (low and high nibbles,
// each widened to a byte), so each folded word costs two masks, a shift
// and two byte maxima rather than a whole nib_max4.
template <bool kPacked, int kWords>
struct Acc {
  static constexpr bool kPlanes = kPacked;
  uint32_t lo[kWords];
  uint32_t hi[kPlanes ? kWords : 1];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      lo[i] = 0u;
      if constexpr (kPlanes) hi[i] = 0u;
    }
  }
  __device__ __forceinline__ void fold(const Vec<kWords>& v) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      if constexpr (kPlanes) {
        lo[i] = __vmaxu4(lo[i], v.w[i] & 0x0F0F0F0Fu);
        hi[i] = __vmaxu4(hi[i], (v.w[i] >> 4) & 0x0F0F0F0Fu);
      } else {
        lo[i] = repro::reg_max<kPacked>(lo[i], v.w[i]);
      }
    }
  }
  __device__ __forceinline__ uint32_t word(int i) const {
    if constexpr (kPlanes) return lo[i] | (hi[i] << 4);
    return lo[i];
  }
};

// Folds the segment maximum `acc` of destination d into out[d], this
// lane's kWords words at `o`; `base` is a read of those words, made at
// the segment's end. A segment wholly inside the run owns out[d], so
// `base` is exact: one plain store of the maximum, skipped when nothing
// grew. A segment that crosses a run end (`shared`) merges each word with
// a compare-and-swap loop whose first guess is `base`: out only grows, so
// a stale guess costs one more round, and a merge that changes nothing
// against it changes nothing against the current word either.
template <bool kPacked, int kWords>
__device__ __forceinline__ void flush_into(uint32_t* o,
                                           const Acc<kPacked, kWords>& acc,
                                           const Vec<kWords>& base,
                                           bool shared) {
  if (!shared) {
    Vec<kWords> merged;
    bool grew = false;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      merged.w[i] = repro::reg_max<kPacked>(base.w[i], acc.word(i));
      grew |= merged.w[i] != base.w[i];
    }
    if (grew) store_vec(o, merged);
    return;
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint32_t v = acc.word(i);
    if (v == 0u) continue;
    uint32_t old = base.w[i];
    for (;;) {
      const uint32_t merged = repro::reg_max<kPacked>(old, v);
      if (merged == old) break;
      const uint32_t seen = atomicCAS(o + i, old, merged);
      if (seen == old) break;
      old = seen;
    }
  }
}

// out[dst[e]] max= src_panel[src[e]] over dst-sorted runs of run_edges
// edges, one run per group of `lanes` lanes (kWords words each, `chunks`
// row chunks). No edge is skipped: src and dst index different panels.
// Inside a run, edges are counted in 32 bits (run_edges < 2^31).
template <bool kPacked, int kWords>
__global__ void __launch_bounds__(kIntoThreads, kPacked
                                                    ? kIntoMinBlocksPacked
                                                    : kIntoMinBlocksByte)
    hll_propagate_into_kernel(const uint32_t* __restrict__ src_panel,
                              uint32_t* __restrict__ out,
                              const int32_t* __restrict__ src,
                              const int32_t* __restrict__ dst,
                              int64_t n_edges, int64_t n_src, int64_t n_out,
                              int64_t row_words, int lanes, int64_t chunks,
                              int64_t run_edges) {
  constexpr int kB = into_batch<kWords>();
  // a row id r is live when 0 <= r < n: one unsigned compare (ids are int32)
  const uint32_t src_lim =
      static_cast<uint32_t>(n_src < (int64_t{1} << 31) ? n_src
                                                       : int64_t{1} << 31);
  const uint32_t out_lim =
      static_cast<uint32_t>(n_out < (int64_t{1} << 31) ? n_out
                                                       : int64_t{1} << 31);
  const int lane = threadIdx.x & 31;
  const int groups_per_warp = 32 / lanes;
  const int64_t group =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32 *
          groups_per_warp +
      lane / lanes;
  const int64_t n_groups =
      static_cast<int64_t>(gridDim.x) * blockDim.x / 32 * groups_per_warp;
  const int64_t n_runs = (n_edges + run_edges - 1) / run_edges;
  const int64_t lane_off = static_cast<int64_t>(lane % lanes) * kWords;
  for (int64_t run = group; run < n_runs; run += n_groups) {
    const int64_t e0 = run * run_edges;
    const int len = static_cast<int>(
        e0 + run_edges < n_edges ? run_edges : n_edges - e0);
    const int32_t* const src_r = src + e0;
    const int32_t* const dst_r = dst + e0;
    const int32_t d_first = dst_r[0];
    const int32_t d_last = dst_r[len - 1];
    // the first (last) segment continues into the previous (next) run
    const bool open_lo = e0 > 0 && dst_r[-1] == d_first;
    const bool open_hi = e0 + len < n_edges && dst_r[len] == d_last;
    for (int64_t c = 0; c < chunks; ++c) {
      uint32_t* const out_c = out + c * lanes * kWords + lane_off;
      const uint32_t* const src_c = src_panel + c * lanes * kWords + lane_off;
      auto row_of = [&](int32_t d) {
        return out_c + static_cast<int64_t>(d) * row_words;
      };
      int32_t cur = d_first;
      Acc<kPacked, kWords> acc;
      acc.clear();
      for (int i = 0; i < len; i += kB) {
        Vec<kWords> rows[kB];
        int32_t ds[kB];
#pragma unroll
        for (int b = 0; b < kB; ++b) {
          rows[b] = zero_vec<kWords>();
          ds[b] = -1;
          if (i + b < len) {
            const int32_t s = src_r[i + b];
            ds[b] = dst_r[i + b];
            if (static_cast<uint32_t>(s) < src_lim)
              rows[b] = load_vec<kWords>(src_c +
                                         static_cast<int64_t>(s) * row_words);
          }
        }
#pragma unroll
        for (int b = 0; b < kB; ++b) {
          if (i + b >= len) break;
          if (ds[b] != cur) {
            if (static_cast<uint32_t>(cur) < out_lim)
              flush_into<kPacked>(row_of(cur), acc,
                                  load_out<kWords>(row_of(cur)),
                                  open_lo && cur == d_first);
            cur = ds[b];
            acc.clear();
          }
          acc.fold(rows[b]);
        }
      }
      if (static_cast<uint32_t>(cur) < out_lim)
        flush_into<kPacked>(row_of(cur), acc, load_out<kWords>(row_of(cur)),
                            (open_lo && cur == d_first) ||
                                (open_hi && cur == d_last));
    }
  }
}

template <bool kPacked, int kWords>
void launch_into_words(const uint32_t* src_panel, uint32_t* out,
                       const int32_t* src, const int32_t* dst,
                       int64_t n_edges, int64_t n_src, int64_t n_out,
                       int64_t row_words, int64_t run_edges,
                       cudaStream_t stream) {
  const int64_t lanes64 = row_words / kWords < 32 ? row_words / kWords : 32;
  const int lanes = static_cast<int>(lanes64);
  const int64_t chunks = row_words / (lanes64 * kWords);
  const int64_t n_runs = (n_edges + run_edges - 1) / run_edges;
  hll_propagate_into_kernel<kPacked, kWords>
      <<<repro::grid_for(n_runs * lanes, kIntoThreads), kIntoThreads, 0,
         stream>>>(src_panel, out, src, dst, n_edges, n_src, n_out,
                   row_words, lanes, chunks, run_edges);
}

// width: bytes per row, a power of two >= 8; run_edges >= 1.
template <bool kPacked>
int launch_into(const uint8_t* src_panel, uint8_t* out, const int32_t* src,
                const int32_t* dst, int64_t n_edges, int64_t n_src,
                int64_t n_out, int width, int64_t run_edges,
                cudaStream_t stream) {
  if (run_edges < 1 || run_edges >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_edges == 0) return 0;
  const auto* s = reinterpret_cast<const uint32_t*>(src_panel);
  auto* o = reinterpret_cast<uint32_t*>(out);
  const int64_t row_words = width / 4;
  // one warp per row up to 512 bytes, as the one-panel kernel
  const int words = row_words >= 128 ? 4 : (row_words >= 64 ? 2 : 1);
  if (words == 4) {
    launch_into_words<kPacked, 4>(s, o, src, dst, n_edges, n_src, n_out,
                                  row_words, run_edges, stream);
  } else if (words == 2) {
    launch_into_words<kPacked, 2>(s, o, src, dst, n_edges, n_src, n_out,
                                  row_words, run_edges, stream);
  } else {
    launch_into_words<kPacked, 1>(s, o, src, dst, n_edges, n_src, n_out,
                                  row_words, run_edges, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// run_edges: directed edges a group walks, 256, 512, 1024 or 2048.
extern "C" int hll_propagate(const uint8_t* regs, uint8_t* out,
                             const int32_t* src, const int32_t* dst,
                             int64_t n_edges, int64_t n_rows, int r,
                             int run_edges, cudaStream_t stream) {
  return launch<false>(regs, out, src, dst, n_edges, n_rows, r, run_edges,
                       stream);
}

// r: registers per row; the packed row is r / 2 bytes (r >= 16).
extern "C" int hll_propagate_packed(const uint8_t* regs, uint8_t* out,
                                    const int32_t* src, const int32_t* dst,
                                    int64_t n_edges, int64_t n_rows, int r,
                                    int run_edges, cudaStream_t stream) {
  return launch<true>(regs, out, src, dst, n_edges, n_rows, r >> 1,
                      run_edges, stream);
}

// out (n_out rows) max= src_panel (n_src rows) over a dst-sorted routing,
// in place, in runs of run_edges edges (kernels/hll_propagate.py
// `run_edges` chooses it from the edge count and the card's SMs).
extern "C" int hll_propagate_into(const uint8_t* src_panel, uint8_t* out,
                                  const int32_t* src, const int32_t* dst,
                                  int64_t n_edges, int64_t n_src,
                                  int64_t n_out, int r, int64_t run_edges,
                                  cudaStream_t stream) {
  return launch_into<false>(src_panel, out, src, dst, n_edges, n_src, n_out,
                            r, run_edges, stream);
}

extern "C" int hll_propagate_into_packed(const uint8_t* src_panel,
                                         uint8_t* out, const int32_t* src,
                                         const int32_t* dst, int64_t n_edges,
                                         int64_t n_src, int64_t n_out, int r,
                                         int64_t run_edges,
                                         cudaStream_t stream) {
  return launch_into<true>(src_panel, out, src, dst, n_edges, n_src, n_out,
                           r >> 1, run_edges, stream);
}
