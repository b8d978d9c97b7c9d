// hll_accumulate: fused hash + HLL scatter-max (Algorithm 1 INSERT).
//
// Replaces repro/kernels/hll_accumulate.py `hll_accumulate` (the Pallas
// kernel). For every edge e with mask[e] (every edge when mask is null):
//   regs[rows[e], bucket(keys[e])] = max(., rho(keys[e])),
// with bucket/rho computed in registers from the raw key, and the panel
// updated in place.
//
// What bounds it on the H100: not bytes in bulk but scattered read-modify-
// writes. Each edge reads 8 bytes of stream (row, key) and touches one
// register byte at a random place in a panel far larger than L2 (1 GiB at
// 4M vertices, p=8), so each update costs a 32-byte sector round trip and
// an atomic; a launch over a few thousand edges is bound by its own
// latency and the launch itself.
//
// Design: the TPU kernel walks the edge block sequentially because the TPU
// has no atomics. Here the engine hands one launch a whole ingest chunk
// (millions of directed edges), and each thread carries kEdgesPerThread of
// them: a warp takes a tile of kTile = 32 * kEdgesPerThread edges, lane l
// edge k * 32 + l of the tile, so every load is coalesced. The tile is the
// launcher's `edge_block`, one of 64, 128, 256 and 512 (2 to 16 edges a
// thread): it sizes the unrolled register arrays, so each is its own
// instantiation (kernels/autotune.py holds the default, 128, and the
// sweep). A thread loads all
// its ids and keys, hashes them in registers, and issues all its register
// word reads before any compare-and-swap, so several round trips are in
// flight per thread. CUDA has no 8-bit atomicMax, so the byte max is a
// compare-and-swap loop on the aligned 32-bit word that holds the
// register. Updates to the same word from one warp are aggregated first:
// __match_any_sync groups the lanes by word (the row-sorted forward half
// of a chunk puts a row's edges in neighbouring lanes), each lane's update
// word (rho at its byte) is folded with __vmaxu4 through a per-warp
// shared-memory stage, and only the group's lowest lane runs the loop.
// Registers only grow, so a stale read can only be smaller than the
// truth: the loop stops as soon as the merge changes nothing, and a
// register already large enough is never written. The result does not
// depend on the order of updates, because max is commutative.
//
// Packed layout (hll_accumulate_packed): the row is r/2 bytes and the
// register one nibble, register b at byte b mod r/2, in the high nibble
// when b >= r/2 (split-half, kernels/packing.py). The update is
// min(rho, 15) at that nibble and the fold is repro::nib_max4. Registers
// grow monotonically in both layouts, so the early exit stays valid.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// mask may be null: every edge is live. kEdgesPerThread: edges a lane
// carries, so a warp's tile is 32 * kEdgesPerThread edges.
template <bool kPacked, int kEdgesPerThread>
__global__ void __launch_bounds__(kThreads)
    hll_accumulate_kernel(uint32_t* __restrict__ regs,
                          const int32_t* __restrict__ rows,
                          const uint32_t* __restrict__ keys,
                          const bool* __restrict__ mask, int64_t n_edges,
                          int64_t n_rows, int p, uint32_t s_hi,
                          uint32_t s_lo) {
  constexpr int64_t kTile = 32 * kEdgesPerThread;
  __shared__ uint32_t stage[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // log2 of the row width in bytes
  const int row_shift = kPacked ? p - 1 : p;
  const int64_t n_tiles = (n_edges + kTile - 1) / kTile;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
  // the tile loop is warp-uniform, as __match_any_sync needs
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       t < n_tiles; t += n_warps) {
    int64_t row[kEdgesPerThread];
    uint32_t key[kEdgesPerThread];
    bool live[kEdgesPerThread];
#pragma unroll
    for (int k = 0; k < kEdgesPerThread; ++k) {
      const int64_t e = t * kTile + k * 32 + lane;
      live[k] = e < n_edges && (mask == nullptr || mask[e]);
      row[k] = live[k] ? rows[e] : 0;
      key[k] = live[k] ? keys[e] : 0u;
      // callers validate ids; a stray one is dropped, never written
      live[k] = live[k] && row[k] >= 0 && row[k] < n_rows;
    }
    int64_t word[kEdgesPerThread];
    uint32_t upd[kEdgesPerThread];
    uint32_t old[kEdgesPerThread];
#pragma unroll
    for (int k = 0; k < kEdgesPerThread; ++k) {
      uint32_t bucket, rho;
      repro::bucket_rho(key[k], p, s_hi, s_lo, &bucket, &rho);
      const uint32_t col = bucket & ((1u << row_shift) - 1u);
      const int64_t byte = (row[k] << row_shift) + col;
      uint32_t shift = static_cast<uint32_t>(byte & 3) * 8u;
      if (kPacked) {
        shift += 4u * (bucket >> row_shift);  // high nibble: b >= r/2
        rho = rho < 15u ? rho : 15u;
      }
      word[k] = byte >> 2;
      upd[k] = live[k] ? rho << shift : 0u;
    }
#pragma unroll
    for (int k = 0; k < kEdgesPerThread; ++k)
      old[k] = live[k] ? regs[word[k]] : 0u;
#pragma unroll
    for (int k = 0; k < kEdgesPerThread; ++k) {
      const unsigned long long id =
          live[k] ? static_cast<unsigned long long>(word[k]) : ~0ull;
      const unsigned int peers = __match_any_sync(0xFFFFFFFFu, id);
      stage[warp][lane] = upd[k];
      __syncwarp();
      if (live[k] && lane == __ffs(peers) - 1) {
        uint32_t v = 0u;
        for (unsigned int m = peers; m != 0u; m &= m - 1u)
          v = repro::reg_max<kPacked>(v, stage[warp][__ffs(m) - 1]);
        uint32_t cur = old[k];
        for (;;) {
          const uint32_t merged = repro::reg_max<kPacked>(cur, v);
          if (merged == cur) break;
          const uint32_t seen = atomicCAS(regs + word[k], cur, merged);
          if (seen == cur) break;
          cur = seen;
        }
      }
      __syncwarp();
    }
  }
}

template <bool kPacked, int kEdgesPerThread>
void launch_tile(uint8_t* regs, const int32_t* rows, const uint32_t* keys,
                 const bool* mask, int64_t n_edges, int64_t n_rows, int p,
                 uint32_t s_hi, uint32_t s_lo, cudaStream_t stream) {
  constexpr int64_t kTile = 32 * kEdgesPerThread;
  const int64_t n_tiles = (n_edges + kTile - 1) / kTile;
  hll_accumulate_kernel<kPacked, kEdgesPerThread>
      <<<repro::grid_for(n_tiles * 32, kThreads), kThreads, 0, stream>>>(
          reinterpret_cast<uint32_t*>(regs), rows, keys, mask, n_edges,
          n_rows, p, s_hi, s_lo);
}

// edge_block: a warp's tile, 64, 128, 256 or 512 edges
// (cudaErrorInvalidValue otherwise, nothing launched).
template <bool kPacked>
int launch(uint8_t* regs, const int32_t* rows, const uint32_t* keys,
           const bool* mask, int64_t n_edges, int64_t n_rows, int p,
           uint32_t s_hi, uint32_t s_lo, int edge_block,
           cudaStream_t stream) {
  if (edge_block != 64 && edge_block != 128 && edge_block != 256 &&
      edge_block != 512)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_edges == 0) return 0;
  switch (edge_block) {
    case 64:
      launch_tile<kPacked, 2>(regs, rows, keys, mask, n_edges, n_rows, p,
                              s_hi, s_lo, stream);
      break;
    case 128:
      launch_tile<kPacked, 4>(regs, rows, keys, mask, n_edges, n_rows, p,
                              s_hi, s_lo, stream);
      break;
    case 256:
      launch_tile<kPacked, 8>(regs, rows, keys, mask, n_edges, n_rows, p,
                              s_hi, s_lo, stream);
      break;
    default:
      launch_tile<kPacked, 16>(regs, rows, keys, mask, n_edges, n_rows, p,
                               s_hi, s_lo, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mask: bool[n_edges], or null when every edge is live; edge_block: a
// warp's tile of edges, 64, 128, 256 or 512.
extern "C" int hll_accumulate(uint8_t* regs, const int32_t* rows,
                              const uint32_t* keys, const bool* mask,
                              int64_t n_edges, int64_t n_rows, int p,
                              uint32_t s_hi, uint32_t s_lo, int edge_block,
                              cudaStream_t stream) {
  return launch<false>(regs, rows, keys, mask, n_edges, n_rows, p, s_hi,
                       s_lo, edge_block, stream);
}

// The panel is uint8[n_rows, 2^(p-1)]; p >= 4 (the wrapper checks).
extern "C" int hll_accumulate_packed(uint8_t* regs, const int32_t* rows,
                                     const uint32_t* keys, const bool* mask,
                                     int64_t n_edges, int64_t n_rows, int p,
                                     uint32_t s_hi, uint32_t s_lo,
                                     int edge_block, cudaStream_t stream) {
  return launch<true>(regs, rows, keys, mask, n_edges, n_rows, p, s_hi, s_lo,
                      edge_block, stream);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
