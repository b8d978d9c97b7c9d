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
// per set; the merge is one __vmaxu4 per 4 registers. What kept it far
// from that bound was latency: a warp that walks a set's members one row
// at a time waits out one memory latency per member, and the longest set
// of the panel sets the kernel's time.
//
// Design: a block of kWarps warps owns kWarps consecutive sets (kWarps is
// the launcher's `set_block`, 4, 8 or 16: it sizes __launch_bounds__ and
// the static shared arrays, so each is its own instantiation;
// kernels/autotune.py holds the default, 8, and the sweep). Each
// set's id row is cut into 32-lane windows, and the block's windows form a
// queue in window-major order (every set's first window, then every
// set's second, ...), from which each warp takes kAhead windows at a time
// (a shared-memory counter), loading their mask bytes and ids together.
// So the warps of a block share its sets' live windows whatever their
// lengths: a short set costs one warp one window, and a long set is
// spread over every warp of its block. In a window, a ballot of the mask
// gives the live lanes, whose row ids are compacted into shared memory by
// rank. The warp is split into lane groups of g lanes, each lane owning
// one 16-byte vector of a g-vector column chunk of the row (p=8: 16
// lanes, so two groups; packed 8 lanes, four groups). Each group takes
// its next kMembers live ids, issues their row loads, then merges them,
// so a warp has 32 / g * kMembers rows in flight. The groups' partial
// rows are merged by shuffles, then into the set's chunk in shared memory
// with a 32-bit compare-and-swap of the register-wise max, which no order
// of arrival changes. After a barrier, warp w reduces set w's merged
// chunk to exact sums (repro::add_vec_stats: byte `s` in fixed point,
// packed as the integer sum 2^(15 - x), rounded to float32 once). Rows
// wider than one chunk (p >= 10 byte) repeat this per chunk. The result
// depends on the set's members only, so the same inputs give the same
// bits on every launch and in every panel (query_batch's answers equal
// union_size's bit for bit), and packed sums equal the byte kernel's on
// the unpacked rows.
#include "common.cuh"

namespace {

// Design constants, swept on the card by scripts/sweep_pairsets.py.
constexpr int kVecBytes = 16;  // load width (8 where alignment forbids 16)
constexpr int kMembers = 4;    // member rows in flight a lane group
constexpr int kAhead = 2;      // id windows a warp takes, and loads, at once
// id windows up to which a warp owns its set (panels of L <= 32 * this);
// wider panels share each block's windows among its warps
constexpr int kOwnWindows = 2;
// blocks each SM must hold at once (__launch_bounds__: caps registers)
constexpr int kMinBlocks = 1;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint4 shfl_xor(const uint4& v, int o) {
  return make_uint4(__shfl_xor_sync(kFull, v.x, o),
                    __shfl_xor_sync(kFull, v.y, o),
                    __shfl_xor_sync(kFull, v.z, o),
                    __shfl_xor_sync(kFull, v.w, o));
}
__device__ __forceinline__ uint2 shfl_xor(const uint2& v, int o) {
  return make_uint2(__shfl_xor_sync(kFull, v.x, o),
                    __shfl_xor_sync(kFull, v.y, o));
}

// Register-wise max of v into the shared word *p: a compare-and-swap loop
// (values only grow, so a stale first read only costs a retry).
template <bool kPacked>
__device__ __forceinline__ void shared_max(uint32_t* p, uint32_t v) {
  uint32_t old = *p;
  while (true) {
    const uint32_t want = repro::reg_max<kPacked>(old, v);
    if (want == old) return;
    const uint32_t seen = atomicCAS(p, old, want);
    if (seen == old) return;
    old = seen;
  }
}

// Merges the live member rows of one 32-lane id window into acc (each
// lane its vector `col + sub` of the row): the ballot's live lanes are
// compacted into the warp's `slots` by rank, and each lane group loads
// kMembers rows at a time before it merges them. Warp-uniform; returns
// false, merging nothing, for a window with no live lane.
template <bool kPacked, typename T>
__device__ __forceinline__ bool merge_window(bool live, int32_t id,
                                             int64_t n_rows, int* slots,
                                             const T* vecs, int row_vecs,
                                             int col, int g_log2, T* acc) {
  const int lane = threadIdx.x & 31;
  const unsigned ballot = __ballot_sync(kFull, live);
  if (ballot == 0u) return false;
  if (live) {
    slots[__popc(ballot & ((1u << lane) - 1u))] =
        static_cast<int>(repro::clamp_row(id, n_rows));
  }
  __syncwarp();
  const int count = __popc(ballot);
  const int groups = 32 >> g_log2;
  const int64_t at = col + (lane & ((1 << g_log2) - 1));
  for (int m = (lane >> g_log2) * kMembers; m < count;
       m += groups * kMembers) {
    T rows[kMembers];
#pragma unroll
    for (int j = 0; j < kMembers; ++j) {
      if (m + j < count) {
        rows[j] = vecs[static_cast<int64_t>(slots[m + j]) * row_vecs + at];
      }
    }
#pragma unroll
    for (int j = 0; j < kMembers; ++j) {
      if (m + j < count) *acc = repro::reg_max<kPacked>(*acc, rows[j]);
    }
  }
  __syncwarp();  // the slots are rewritten by the next window
  return true;
}

// kShared false: each warp owns one set and walks its windows, kAhead at a
// time, merging in registers; no shared chunk and no block barrier. kShared
// true: the block's windows form a queue that all its warps take from,
// partial rows merged into each set's chunk in shared memory.
// row_vecs: kVec-byte vectors per row; g = 1 << g_log2 lanes a group, the
// column chunk's vectors (min(32, row_vecs)); regs_per_row: registers per
// row (the zero count is regs_per_row - nz); kWarps: sets a block, and
// warps sharing them.
template <bool kPacked, int kVec, bool kShared, int kWarps>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    union_estimate_kernel(const uint8_t* __restrict__ regs,
                          const int32_t* __restrict__ ids,
                          const uint8_t* __restrict__ mask,
                          float2* __restrict__ out, int64_t n_sets,
                          int64_t n_rows, int lanes, int row_vecs,
                          int g_log2, int regs_per_row) {
  using V = repro::Vec<kVec>;
  using T = typename V::T;
  __shared__ T merged[kShared ? kWarps : 1][32];  // each set's chunk
  __shared__ int slots[kWarps][32];  // a warp's compacted member rows
  __shared__ int next_item;          // the block's window queue
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = 1 << g_log2;
  const int64_t set0 = static_cast<int64_t>(blockIdx.x) * kWarps;
  const int here = static_cast<int>(
      n_sets - set0 < kWarps ? n_sets - set0 : kWarps);
  if (!kShared && warp >= here) return;  // whole warps; no block barrier
  const int windows = (lanes + 31) >> 5;
  // queue items, window-major: item t is window t / here of set t % here,
  // so the warps meet every set's first window before any set's second;
  // a warp that owns its set walks items warp, warp + here, ...
  const int items = here * windows;
  const T* vecs = reinterpret_cast<const T*>(regs);
  const T zero = {};
  unsigned long long fix = 0;  // warp w's set's sums, lanes < g
  double tiny = 0.0;
  int nz = 0;
  for (int col = 0; col < row_vecs; col += g) {
    if constexpr (kShared) {
      merged[warp][lane] = zero;
      if (threadIdx.x == 0) next_item = 0;
      __syncthreads();
    }
    T acc = zero;  // own: the set's partial chunk
    for (int w0 = 0;; w0 += kAhead) {  // warp-uniform
      int t0 = (w0 * here) + warp;
      if (kShared) {
        if (lane == 0) t0 = atomicAdd(&next_item, kAhead);
        t0 = __shfl_sync(kFull, t0, 0);
      }
      if (t0 >= items) break;
      // the items' mask bytes and ids, loaded together before any is used
      const int step = kShared ? 1 : here;
      bool live[kAhead];
      int32_t id[kAhead];
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        const int t = t0 + a * step;
        const int at = (t / here) * 32 + lane;  // lane of the id row
        live[a] = false;
        if (t < items && at < lanes) {
          const int64_t i = (set0 + t % here) * lanes + at;
          live[a] = mask[i] != 0;
          id[a] = ids[i];
        }
      }
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        T part = zero;
        T* into = kShared ? &part : &acc;
        if (!merge_window<kPacked>(live[a], id[a], n_rows, slots[warp], vecs,
                                   row_vecs, col, g_log2, into) ||
            !kShared) {
          continue;
        }
        // the groups' partial rows, then into the set's shared chunk
        for (int o = g; o < 32; o <<= 1) {
          part = repro::reg_max<kPacked>(part, shfl_xor(part, o));
        }
        if (lane < g) {
          uint32_t* dst = reinterpret_cast<uint32_t*>(
              &merged[kShared ? (t0 + a) % here : 0][lane]);
#pragma unroll
          for (int k = 0; k < kVec / 4; ++k) {
            const uint32_t v = V::word(part, k);
            if (v != 0u) shared_max<kPacked>(dst + k, v);
          }
        }
      }
    }
    if constexpr (kShared) {
      __syncthreads();
      acc = merged[warp][lane];
      __syncthreads();  // merged is zeroed for the next chunk
    } else {
      for (int o = g; o < 32; o <<= 1) {
        acc = repro::reg_max<kPacked>(acc, shfl_xor(acc, o));
      }
    }
    if (warp < here && lane < g) {
      repro::add_vec_stats<kPacked, kVec>(acc, &fix, &tiny, &nz);
    }
  }
  if (warp >= here) return;  // whole warps leave; no barrier follows
  fix = repro::warp_sum(fix);
  nz = repro::warp_sum(nz);
  if (!kPacked && __any_sync(kFull, tiny != 0.0)) tiny = repro::warp_sum(tiny);
  if (lane == 0) {
    out[set0 + warp] = make_float2(repro::harmonic_finish<kPacked>(fix, tiny),
                                   static_cast<float>(regs_per_row - nz));
  }
}

template <bool kPacked, int kVec, int kWarps>
int launch(const uint8_t* regs, const int32_t* ids, const uint8_t* mask,
           float* out, int64_t n_sets, int64_t n_rows, int lanes,
           int row_bytes, int regs_per_row, cudaStream_t stream) {
  const int row_vecs = row_bytes / kVec;
  int g_log2 = 0;
  while (g_log2 < 5 && (2 << g_log2) <= row_vecs) ++g_log2;
  const unsigned int blocks =
      static_cast<unsigned int>((n_sets + kWarps - 1) / kWarps);
  auto* kernel = lanes <= 32 * kOwnWindows
                     ? union_estimate_kernel<kPacked, kVec, false, kWarps>
                     : union_estimate_kernel<kPacked, kVec, true, kWarps>;
  kernel<<<blocks, kWarps * 32, 0, stream>>>(
      regs, ids, mask, reinterpret_cast<float2*>(out), n_sets, n_rows, lanes,
      row_vecs, g_log2, regs_per_row);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPacked, int kWarps>
int launch_vec(const uint8_t* regs, const int32_t* ids, const uint8_t* mask,
               float* out, int64_t n_sets, int64_t n_rows, int lanes,
               int row_bytes, int regs_per_row, cudaStream_t stream) {
  const bool wide = kVecBytes == 16 && row_bytes % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(regs) % 16 == 0;
  return wide ? launch<kPacked, 16, kWarps>(regs, ids, mask, out, n_sets,
                                            n_rows, lanes, row_bytes,
                                            regs_per_row, stream)
              : launch<kPacked, 8, kWarps>(regs, ids, mask, out, n_sets,
                                           n_rows, lanes, row_bytes,
                                           regs_per_row, stream);
}

// set_block: sets a block, 4, 8 or 16 (cudaErrorInvalidValue otherwise,
// nothing launched).
template <bool kPacked>
int launch_any(const uint8_t* regs, const int32_t* ids, const uint8_t* mask,
               float* out, int64_t n_sets, int64_t n_rows, int lanes,
               int row_bytes, int regs_per_row, int set_block,
               cudaStream_t stream) {
  if (set_block != 4 && set_block != 8 && set_block != 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_sets == 0) return 0;
  switch (set_block) {
    case 4:
      return launch_vec<kPacked, 4>(regs, ids, mask, out, n_sets, n_rows,
                                    lanes, row_bytes, regs_per_row, stream);
    case 8:
      return launch_vec<kPacked, 8>(regs, ids, mask, out, n_sets, n_rows,
                                    lanes, row_bytes, regs_per_row, stream);
    default:
      return launch_vec<kPacked, 16>(regs, ids, mask, out, n_sets, n_rows,
                                     lanes, row_bytes, regs_per_row, stream);
  }
}

}  // namespace

// set_block: sets a block, 4, 8 or 16.
extern "C" int union_estimate_stats(const uint8_t* regs, const int32_t* ids,
                                    const uint8_t* mask, float* out,
                                    int64_t n_sets, int64_t n_rows, int lanes,
                                    int r, int set_block,
                                    cudaStream_t stream) {
  return launch_any<false>(regs, ids, mask, out, n_sets, n_rows, lanes, r, r,
                           set_block, stream);
}

// r: registers per row; the packed row is r / 2 bytes (r >= 16).
extern "C" int union_estimate_stats_packed(const uint8_t* regs,
                                           const int32_t* ids,
                                           const uint8_t* mask, float* out,
                                           int64_t n_sets, int64_t n_rows,
                                           int lanes, int r, int set_block,
                                           cudaStream_t stream) {
  return launch_any<true>(regs, ids, mask, out, n_sets, n_rows, lanes, r >> 1,
                          r, set_block, stream);
}
