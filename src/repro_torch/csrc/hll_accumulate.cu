// hll_accumulate: fused hash + HLL scatter-max (Algorithm 1 INSERT).
//
// Replaces repro/kernels/hll_accumulate.py `hll_accumulate` (the Pallas
// kernel). For every edge e with mask[e]:
//   regs[rows[e], bucket(keys[e])] = max(., rho(keys[e])),
// with bucket/rho computed in registers from the raw key, and the panel
// updated in place.
//
// What bounds it on the H100: not bytes in bulk but scattered read-modify-
// writes. Each edge reads 9 bytes of stream (row, key, mask) and touches
// one register byte at a random place in a panel far larger than L2
// (1 GiB at 4M vertices, p=8), so each update costs a 32-byte sector
// round trip and an atomic.
//
// Design: the TPU kernel walks the edge block sequentially because the TPU
// has no atomics; here one thread takes one directed edge. CUDA has no
// 8-bit atomicMax, so the byte max is a compare-and-swap loop on the
// aligned 32-bit word that holds the register. Registers only grow, so a
// stale read can only be smaller than the truth: the loop stops as soon
// as the byte it sees is already >= rho, which is the common case once a
// sketch fills up. The result does not depend on the order of updates,
// because max is commutative.
//
// Packed layout (hll_accumulate_packed): the row is r/2 bytes and the
// register one nibble, register b at byte b mod r/2, in the high nibble
// when b >= r/2 (split-half, kernels/packing.py). The value is
// min(rho, 15), and the same compare-and-swap loop compares and replaces
// that nibble of the 32-bit word. Registers grow monotonically in both
// layouts, so the early exit stays valid.
#include "common.cuh"

namespace {

template <bool kPacked>
__global__ void hll_accumulate_kernel(uint8_t* __restrict__ regs,
                                      const int32_t* __restrict__ rows,
                                      const uint32_t* __restrict__ keys,
                                      const bool* __restrict__ mask,
                                      int64_t n_edges, int64_t n_rows, int p,
                                      uint32_t s_hi, uint32_t s_lo) {
  // log2 of the row width in bytes
  const int row_shift = kPacked ? p - 1 : p;
  const unsigned int lane_mask = repro::Lanes<kPacked>::kMask;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n_edges; e += stride) {
    if (!mask[e]) continue;
    const int64_t row = rows[e];
    if (row < 0 || row >= n_rows) continue;  // callers validate ids
    uint32_t bucket, rho;
    repro::bucket_rho(keys[e], p, s_hi, s_lo, &bucket, &rho);
    const uint32_t col = bucket & ((1u << row_shift) - 1u);
    const int64_t byte = (row << row_shift) + col;
    unsigned int* word = reinterpret_cast<unsigned int*>(regs) + (byte >> 2);
    unsigned int shift = static_cast<unsigned int>(byte & 3) * 8u;
    if (kPacked) {
      shift += 4u * (bucket >> row_shift);  // high nibble: b >= r/2
      rho = rho < 15u ? rho : 15u;
    }
    unsigned int old = *word;
    while (((old >> shift) & lane_mask) < rho) {
      const unsigned int want =
          (old & ~(lane_mask << shift)) | (rho << shift);
      const unsigned int seen = atomicCAS(word, old, want);
      if (seen == old) break;
      old = seen;
    }
  }
}

template <bool kPacked>
int launch(uint8_t* regs, const int32_t* rows, const uint32_t* keys,
           const bool* mask, int64_t n_edges, int64_t n_rows, int p,
           uint32_t s_hi, uint32_t s_lo, cudaStream_t stream) {
  if (n_edges == 0) return 0;
  constexpr int kThreads = 256;
  hll_accumulate_kernel<kPacked>
      <<<repro::grid_for(n_edges, kThreads), kThreads, 0, stream>>>(
          regs, rows, keys, mask, n_edges, n_rows, p, s_hi, s_lo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hll_accumulate(uint8_t* regs, const int32_t* rows,
                              const uint32_t* keys, const bool* mask,
                              int64_t n_edges, int64_t n_rows, int p,
                              uint32_t s_hi, uint32_t s_lo,
                              cudaStream_t stream) {
  return launch<false>(regs, rows, keys, mask, n_edges, n_rows, p, s_hi,
                       s_lo, stream);
}

// The panel is uint8[n_rows, 2^(p-1)]; p >= 4 (the wrapper checks).
extern "C" int hll_accumulate_packed(uint8_t* regs, const int32_t* rows,
                                     const uint32_t* keys, const bool* mask,
                                     int64_t n_edges, int64_t n_rows, int p,
                                     uint32_t s_hi, uint32_t s_lo,
                                     cudaStream_t stream) {
  return launch<true>(regs, rows, keys, mask, n_edges, n_rows, p, s_hi, s_lo,
                      stream);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
