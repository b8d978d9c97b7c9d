// intersection_newton: the damped Newton ascent of Ertl's intersection
// MLE, every iteration of every pair in one launch.
//
// Replaces no Pallas kernel: the JAX package takes the gradient and the
// 3x3 Hessian of repro/core/intersection.py `log_likelihood` by jax.grad /
// jax.hessian under vmap inside a lax.scan. The port's plain version
// (kernels/intersection_newton.py `plain`) runs the same loop eagerly,
// about 500 launches an iteration over [B, q+2] temporaries. This kernel
// keeps each pair's iterate in registers for all `iters` steps.
//
// Per pair, with t = exp(theta) / r, each iteration computes
//  * the gradient g[3] and Hessian H[3][3] of the log-likelihood in theta
//    from the pair's Eq. 19 histograms stats[pair, 5, q+2], derived as
//    `grad_hess` of the plain version derives them: a term log(max(y,
//    1e-38)) contributes 0 where y sits at the floor, the k = 0 entries
//    are -t and -(ta + tb + tx), u_{q+1} = 0 and d_{q+1} = 2^-q;
//  * the Hessian-overflow flag of `hessian_overflows`: if some floored
//    log argument y of the iterate (5 x (q+2) of them) has y * y below
//    float32's smallest normal, the pair keeps its iterate;
//  * mu = 1e-3 + 1e-3 max|H_ii| (NaN if one is NaN), delta solving
//    (mu I - H) delta = g by LU with partial pivoting (a singular system
//    gives a non-finite delta), delta clamped to [-1.5, 1.5] with NaN kept
//    NaN, and theta + delta taken only if its three entries are finite.
// Exactly `iters` iterations, no early exit; iters = 0 writes theta0.
// float32 with precise expf / expm1f and IEEE division and reciprocals;
// the 1e-38 floor is subnormal and stays non-zero (the library is built
// without flush to zero).
//
// What bounds it on the H100: arithmetic. The histograms, 5(q+2) floats a
// pair (1,160 bytes at p = 8), are read once; then each iteration costs 6
// expf / expm1f evaluations a bin for the overflow test and, if it passes,
// 5 more and a few dozen other operations a bin holding counts.
//
// Design: one warp per pair, kWarps pairs a block. Lane l holds bins l and
// l + 32 (q + 2 <= 64, so p >= 2) with their counts, u_k and d_k in
// registers for every iteration. An iteration first takes the bins' log
// arguments and the overflow test (a warp vote, the second bins first); a
// rejected step needs no derivatives, and the pairs the flag holds still
// (about half of a graph's edge pairs at p = 8) pay for the test alone.
// Otherwise each lane sums its bins' terms into the 17 sums behind g and
// H, a xor-shuffle tree reduces them over the warp (every lane ends with
// the same bits: each level adds the same two values on both lanes), and
// every lane assembles g and H from the sums in the plain version's order
// and takes the 3x3 step itself, so nothing is broadcast. A bin whose five
// counts are all 0 adds no terms: while the test passes (every y >=
// 1.08e-19) each term of a bin k >= 1 is finite (|g| <= 2 d / y, |h| <=
// 8 d^2 / y + g^2, far below FLT_MAX), so 0 * term is 0 (k = 0 takes the
// constants -1 and 0). At p = 8 a graph's pairs use fewer than 32 of the
// 58 bins, so the lanes' second bins skip together. The summation order
// over bins, the reciprocals and the compiler's fused multiply-adds round
// otherwise than the plain version; the tests hold the two to float32
// rounding.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;                      // pairs a block
constexpr int kBins = 2;                       // bins a lane
constexpr float kTiny = 1e-38f;                // the log floor (subnormal)
constexpr float kNormMin = 1.17549435e-38f;    // float32's smallest normal
constexpr unsigned kFull = 0xFFFFFFFFu;

// The sums a pair's g and H are assembled from, over its bins k:
// per single-rate term m (in the plain version's order: histogram rows 0,
// 3, 1, 2 at rates ta + tx, tb, ta, tb + tx) sum c f1 and sum c f2, then
// for the equal-register term sum c4 f1_i (i = 0..2) and sum c4 h_ij
// (ij = 00, 01, 02, 11, 12, 22).
constexpr int kEqG = 8;
constexpr int kEqH = 11;
constexpr int kSums = 17;

__device__ __forceinline__ int sym(int i, int j) {  // 00 01 02 11 12 22
  const int a = i < j ? i : j;
  const int b = i < j ? j : i;
  return a == 0 ? b : (a == 1 ? 2 + b : 5);
}

// max(y, tiny) as torch.maximum takes it: NaN stays NaN.
__device__ __forceinline__ float floored(float y) {
  return y < kTiny ? kTiny : y;
}

// A bin's log arguments at the iterate: z_m = -s_m d and y_m =
// -expm1(z_m) at the four single rates s_m, and the equal-register
// argument Y = Ya Yb + W Yx with Yx = -expm1(-tx d), W = exp(-(ta + tb +
// tx) d).
struct BinLogs {
  float z[4], y[4], yx, w, yeq;
};

// Fills v for a bin of weight d; returns its overflow test (some floored
// y with y * y below float32's smallest normal).
__device__ __forceinline__ bool bin_logs(float d, float ta, float tb,
                                         float tx, BinLogs* v) {
  const float rate[4] = {ta + tx, tb, ta, tb + tx};
  bool flag = false;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    v->z[m] = -rate[m] * d;
    v->y[m] = -expm1f(v->z[m]);
    const float y = floored(v->y[m]);
    flag |= y * y < kNormMin;
  }
  v->yx = -expm1f(-tx * d);
  v->w = expf(-(ta + tb + tx) * d);
  v->yeq = v->y[0] * v->y[3] + v->w * v->yx;
  const float y = floored(v->yeq);
  return flag || y * y < kNormMin;
}

// Adds the terms of a bin (counts c[5], weights u, d, log arguments v) to
// the sums s, for an iterate the overflow test passed. Each log's
// derivatives divide by its floored argument: one reciprocal an argument,
// multiplied in.
__device__ __forceinline__ void add_terms(const float (&c)[5], float u,
                                          float d, bool k0, float tx,
                                          const BinLogs& v,
                                          float (&s)[kSums]) {
  constexpr int kRow[4] = {0, 3, 1, 2};
  float e[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    e[m] = expf(v.z[m]);
    const bool live = v.y[m] > kTiny;
    const float ry = 1.0f / floored(v.y[m]);
    const float g = live ? d * e[m] * ry : 0.0f;
    const float h = live ? -d * d * e[m] * ry - g * g : 0.0f;
    const float f1 = k0 ? -1.0f : -u + g;
    const float f2 = k0 ? 0.0f : h;
    s[2 * m] += c[kRow[m]] * f1;
    s[2 * m + 1] += c[kRow[m]] * f2;
  }
  // equal registers: Y = Ya Yb + W Yx over (ta, tb, tx)
  const float ea = e[0], eb = e[3], ya = v.y[0], yb = v.y[3];
  const float w = v.w, yx = v.yx;
  const float ex = expf(-tx * d);
  const float dd = d * d;
  const float b1[3] = {d * ea * yb - d * w * yx, d * eb * ya - d * w * yx,
                       d * ea * yb + d * eb * ya - d * w * yx + d * w * ex};
  const float cross = dd * ea * eb + dd * w * yx;
  const float b2[6] = {
      -dd * ea * yb + dd * w * yx,                                  // 00
      cross,                                                        // 01
      -dd * ea * yb + cross - dd * w * ex,                          // 02
      -dd * eb * ya + dd * w * yx,                                  // 11
      -dd * eb * ya + cross - dd * w * ex,                          // 12
      -dd * ea * yb - dd * eb * ya + 2.0f * dd * ea * eb + dd * w * yx -
          3.0f * dd * w * ex};                                      // 22
  const bool live = v.yeq > kTiny;
  const float ry = 1.0f / floored(v.yeq);
  float g[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g[i] = live ? b1[i] * ry : 0.0f;
    s[kEqG + i] += c[4] * (k0 ? -1.0f : -u + g[i]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = i; j < 3; ++j) {
      const float h = live ? b2[sym(i, j)] * ry - g[i] * g[j] : 0.0f;
      s[kEqH + sym(i, j)] += c[4] * (k0 ? 0.0f : h);
    }
  }
}

// Row p of a (and b) swapped with row k: static indices only, so the
// matrix stays in registers.
__device__ __forceinline__ void swap_rows(float (&a)[3][3], float (&b)[3],
                                          int k, int p) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (i > k) {
      const bool sw = p == i;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float t = a[k][j];
        a[k][j] = sw ? a[i][j] : a[k][j];
        a[i][j] = sw ? t : a[i][j];
      }
      const float t = b[k];
      b[k] = sw ? b[i] : b[k];
      b[i] = sw ? t : b[i];
    }
  }
}

// Solves a x = b in place of b by LU with partial pivoting (the first
// largest |a_ik| pivots, as LAPACK's isamax picks it). A zero pivot
// divides by zero, so a singular system leaves non-finite entries.
__device__ __forceinline__ void solve3(float (&a)[3][3], float (&b)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int p = k;
    float best = fabsf(a[k][k]);
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      if (fabsf(a[i][k]) > best) {
        best = fabsf(a[i][k]);
        p = i;
      }
    }
    swap_rows(a, b, k, p);
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      const float l = a[i][k] / a[k][k];
#pragma unroll
      for (int j = k + 1; j < 3; ++j) a[i][j] -= l * a[k][j];
      b[i] -= l * b[k];
    }
  }
#pragma unroll
  for (int k = 2; k >= 0; --k) {
#pragma unroll
    for (int j = k + 1; j < 3; ++j) b[k] -= a[k][j] * b[j];
    b[k] /= a[k][k];
  }
}

// torch.clamp(x, -1.5, 1.5): NaN stays NaN (fminf / fmaxf would drop it).
__device__ __forceinline__ float clamp_step(float x) {
  return x < -1.5f ? -1.5f : (x > 1.5f ? 1.5f : x);
}

// torch.amax: NaN wins.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// 6 blocks an SM cap the registers at 80: 10.56 ms against 11.12 without
// the cap and 10.67 at 8 blocks (64 registers), 2^18 graph pairs, H100.
__global__ void __launch_bounds__(kWarps * 32, 6)
    intersection_newton_kernel(const float* __restrict__ theta0,
                               const float* __restrict__ stats,
                               float* __restrict__ theta_out,
                               int64_t n_pairs, float r, int q, int iters) {
  const int lane = threadIdx.x & 31;
  const int64_t pair =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (pair >= n_pairs) return;  // whole warp leaves; no block barrier below
  const int nb = q + 2;
  const float* st = stats + pair * 5 * nb;
  float c[kBins][5], u[kBins], d[kBins];
  bool valid[kBins], counted[kBins];
#pragma unroll
  for (int b = 0; b < kBins; ++b) {
    const int k = lane + 32 * b;
    valid[b] = k < nb;
    counted[b] = false;
#pragma unroll
    for (int row = 0; row < 5; ++row) {
      c[b][row] = valid[b] ? st[row * nb + k] : 0.0f;
      counted[b] = counted[b] || c[b][row] != 0.0f;  // NaN counts too
    }
    // u_k = 2^-k (u_{q+1} = 0); d_0 = 1, d_k = 2^-k, d_{q+1} = 2^-q
    const uint32_t kk = static_cast<uint32_t>(k);
    u[b] = k <= q ? repro::exp2_neg(kk) : 0.0f;
    d[b] = k == 0 ? 1.0f : repro::exp2_neg(k <= q ? kk : kk - 1u);
  }
  float th[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) th[i] = theta0[pair * 3 + i];

  for (int it = 0; it < iters; ++it) {
    float t[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = expf(th[i]) / r;
    // The overflow test, the lanes' second bins (the smallest weights,
    // where it most often fails) first. If the Hessian overflows, the step
    // is rejected whatever g and H are: none of them is needed.
    BinLogs v[kBins];
    bool rejected = false;
#pragma unroll
    for (int b = kBins - 1; b >= 0; --b) {
      const bool flag = valid[b] && bin_logs(d[b], t[0], t[1], t[2], &v[b]);
      if (__any_sync(kFull, flag)) {
        rejected = true;
        break;
      }
    }
    if (rejected) continue;
    float s[kSums];
#pragma unroll
    for (int i = 0; i < kSums; ++i) s[i] = 0.0f;
#pragma unroll
    for (int b = 0; b < kBins; ++b) {
      if (counted[b])
        add_terms(c[b], u[b], d[b], lane + 32 * b == 0, t[2], v[b], s);
    }
#pragma unroll
    for (int i = 0; i < kSums; ++i) s[i] = repro::warp_sum(s[i]);

    // g and H from the sums, in the plain version's order
    float g[3] = {0.0f, 0.0f, 0.0f};
    float h[3][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f},
                     {0.0f, 0.0f, 0.0f}};
    constexpr int kIdx[4][2] = {{0, 2}, {1, -1}, {0, -1}, {1, 2}};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float a1 = s[2 * m], a2 = s[2 * m + 1];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int i = kIdx[m][x];
        if (i < 0) continue;
        g[i] += a1 * t[i];
        h[i][i] += a1 * t[i];
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const int j = kIdx[m][y];
          if (j >= 0) h[i][j] += a2 * t[i] * t[j];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float a1 = s[kEqG + i];
      g[i] += a1 * t[i];
      h[i][i] += a1 * t[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) h[i][j] += s[kEqH + sym(i, j)] * t[i] * t[j];
    }

    // maximization: solve (mu I - H) delta = g; mu keeps it positive.
    // Two roundings, as the plain version's two tensor ops take them.
    const float hmax =
        nan_max(nan_max(fabsf(h[0][0]), fabsf(h[1][1])), fabsf(h[2][2]));
    const float mu = __fadd_rn(1e-3f, __fmul_rn(1e-3f, hmax));
    float a[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        a[i][j] = __fmul_rn(mu, i == j ? 1.0f : 0.0f) - h[i][j];
    }
    solve3(a, g);
    float next[3];
    bool ok = true;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      next[i] = th[i] + clamp_step(g[i]);  // trust region in log space
      ok = ok && isfinite(next[i]);
    }
    if (ok) {
#pragma unroll
      for (int i = 0; i < 3; ++i) th[i] = next[i];
    }
  }
  if (lane < 3)
    theta_out[pair * 3 + lane] =
        lane == 0 ? th[0] : (lane == 1 ? th[1] : th[2]);
}

}  // namespace

// theta0, theta: float32[n_pairs, 3]; stats: float32[n_pairs, 5, q + 2];
// r: registers a sketch (t = exp(theta) / r); q in [1, 62] (q + 2 bins fit
// two a lane); iters >= 0. cudaErrorInvalidValue and no launch otherwise.
extern "C" int intersection_newton(const float* theta0, const float* stats,
                                   float* theta, int64_t n_pairs, int r,
                                   int q, int iters, cudaStream_t stream) {
  if (q < 1 || q + 2 > 32 * kBins || r < 1 || iters < 0 || n_pairs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs == 0) return 0;
  const int64_t blocks = (n_pairs + kWarps - 1) / kWarps;
  intersection_newton_kernel<<<static_cast<unsigned int>(blocks), kWarps * 32,
                               0, stream>>>(theta0, stats, theta, n_pairs,
                                            static_cast<float>(r), q, iters);
  return static_cast<int>(cudaGetLastError());
}
