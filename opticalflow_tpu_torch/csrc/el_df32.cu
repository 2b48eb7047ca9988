// The double-float (df32) residual and operator of the reduced
// Euler-Lagrange system for Hopper (sm_90a): kernel B4.
//
// It has no Pallas counterpart.  It replaces what XLA fuses out of the JAX
// functions opticalflow_tpu/ops/elop.py::el_residual_df (:519) and
// el_matvec_df (:590), the refinement's residual and the operator of its
// correction solves; the port's plain versions are ops/elop.py::
// el_residual_df and el_matvec_df, which run it as ~1,200 torch ops a call.
// Two modes, each its own instance of one kernel template:
//   residual  r = b - A (x_hi + x_lo)
//   operator  y = A x: the residual with b = 0 and x_lo = 0, negated.
//
// Layout (packed once per solve by ops/cuda_kernels.py::pack_df32):
//   planes  (B, P, m, n) f32  hi and lo of each coefficient plane, plane 2k
//                             the hi of coefficient k, 2k + 1 its lo, in the
//                             order diag_x, diag_y, cross, adv_xm, adv_xp,
//                             adv_ym, adv_yp, gx, gy, quart, half_I, dIdx and
//                             (fixed mode only) dIdy: P = 24 with compat, 26
//                             without (in compat mode dIdy is dIdx)
//   scalars (B, 6)       f32  per-pair pairs (a_s, a_r, gD), hi then lo
//   rhs_hi, rhs_lo (B, 3, m, n) f32   residual mode only
//   x_hi, x_lo     (B, 3, m, n) f32   x_lo in residual mode only
//   out            (B, 3, m, n) f32
//
// Exactness.  The arithmetic is the plain version's, term by term: the three
// channel term lists of elop.el_residual_df in their order, its acc_sub as
// written (two_prod, the small terms left to right, two_sum, the tail), then
// the rounding of the pair, with the Dekker split and Knuth two-sum of
// ops/df32.py.  Those transforms are exact only if every product and sum is
// rounded on its own, so this source is built with -fmad=false
// (ops/cuda_kernels.py::ENTRY_POINTS): no contraction into fused
// multiply-adds.  No fast math, no flush to zero: the result equals the
// plain version's bit for bit, signed zeros and subnormals included.  The
// mirror extension of elop.extend_interior is applied once, at staging, to
// x_hi and x_lo apart: row -1 reads row 1, row m reads row m - 2, columns
// likewise, and only the four corners of the extended grid, where row and
// column are both mirrored, are doubled (exact).  Values computed once and
// reused are the same operations on the same operands as the plain
// version's, with one rewrite: a negated coefficient's split is the
// negated split, split(-c) = -split(c), exact under round-to-nearest; the
// two differ only in the sign of a zero low part, which cannot reach the
// product error (its partial sums are never -0), so the bits agree.
//
// What bounds it.  A pixel reads P coefficient planes and x and writes y:
// 120 bytes at P = 24 in operator mode, 156 in residual mode (+ x_lo and the
// two rhs planes).  The function's own count is 43 terms of 29 float
// operations (two_prod 17, the small terms 4, two_sum 6, the tail 2), and
// without fused multiply-adds each is an issue slot of its own: at ~1,250
// operations a pixel the issue time is about the bytes time.  So the design
// cuts repeated operations and index work as well as latency:
//   * mode at compile time: the operator instance carries no x_lo or rhs;
//     its c_hi * x_lo terms, with x_lo +0, are c_hi * 0 once per
//     coefficient (and once for a negated one) instead of once per term;
//   * field tiles in shared memory: a block of 32 x kWarps threads owns a
//     tile of 32 columns x kWarps * kRowsPerThread rows; it stages the
//     tile's three fields with a one-pixel halo, the mirror rule and the
//     doubled corners applied once, each value beside its Dekker split (and
//     in residual mode its x_lo) as one float4: each of the 23 neighbour
//     values a pixel reads is one 16-byte shared load with a constant
//     offset, and each field value is split once a tile instead of at each
//     of up to 9 pixels and 3 channels;
//   * each coefficient split once a pixel and each per-pair scalar once a
//     thread's tile (43 splits of the coefficient heads become 13 + 3);
//   * register-blocked rows: a thread computes kRowsPerThread output rows
//     of one column, one after another, each row's coefficient planes
//     read once, coalesced across the warp;
//   * occupancy: at most 128 registers a thread at 128 threads a block, so
//     that four or more blocks (16 warps) an SM hide the global loads (the
//     build holds five, 20 warps, on an H100).
// The per-term work that is left, two_prod's product error on the two
// splits, the small terms, two_sum and the tail, is ~20 operations: ~930 a
// pixel in operator mode.  One thread per pixel row, no atomics: results are
// deterministic.  The field values pass through registers on their way to
// shared memory (to be split), so they are staged with plain loads rather
// than cp.async; the fields are 12 of the 120 bytes a pixel.  Timed against
// this design on the card and not faster at every path shape (PERF.md):
// reading the next row's planes before computing a row, 2 rows a thread,
// and __launch_bounds__ at five blocks an SM.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;                         // tile columns = threads along x
constexpr int kWarps = 4;                         // threads along y (warps of a block)
constexpr int kRowsPerThread = 4;                 // output rows per thread
constexpr int kMinBlocks = 4;                     // blocks an SM: at most 128 registers
constexpr int kThreads = kCols * kWarps;
constexpr int kTileRows = kWarps * kRowsPerThread;
constexpr int kHaloW = kCols + 2;                 // staged columns
constexpr int kHalo = kHaloW * (kTileRows + 2);   // staged values of one field
constexpr float kSplit = 4097.0f;  // 2^12 + 1: Dekker's split of a 24-bit significand

// coefficient k's hi plane is 2k, its lo plane 2k + 1
enum Coef { kDiagX, kDiagY, kCross, kAdvXm, kAdvXp, kAdvYm, kAdvYp, kGx, kGy, kQuart, kHalfI,
            kDIdx, kDIdy };
enum Field { kUx, kUy, kG };

struct Pair {
  float hi, lo;
};

// A coefficient pair, the Dekker split (sh, sl) of its head, and the
// products of its head and of its negation with +0: the plain version's
// c_hi * x_lo in operator mode, where x_lo is the extension of zeros.
struct Coeff {
  float hi, lo, sh, sl, z, zn;
};

__device__ __forceinline__ Coeff coeff(float hi, float lo) {
  // df32.split
  const float c = kSplit * hi;
  const float sh = c - (c - hi);
  return {hi, lo, sh, hi - sh, hi * 0.0f, (-hi) * 0.0f};
}

// elop.el_residual_df's acc_sub with the coefficient c (its negation when
// kNeg) and the staged value v = (x, split(x), x_lo): acc -= coef * x.
template <bool kResidual, bool kNeg>
__device__ __forceinline__ void acc_sub(Pair& acc, const Coeff& c, const float4 v) {
  const float c_hi = kNeg ? -c.hi : c.hi;
  const float c_lo = kNeg ? -c.lo : c.lo;
  const float a_hi = kNeg ? -c.sh : c.sh;
  const float a_lo = kNeg ? -c.sl : c.sl;
  // df32.two_prod(c_hi, x) on the two splits
  const float p = c_hi * v.x;
  const float e = ((a_hi * v.y - p) + a_hi * v.z + a_lo * v.y) + a_lo * v.z;
  const float small = e + c_lo * v.x + (kResidual ? c_hi * v.w : (kNeg ? c.zn : c.z));
  // df32.two_sum(acc.hi, -p)
  const float b = -p;
  const float s = acc.hi + b;
  const float bb = s - acc.hi;
  const float e2 = (acc.hi - (s - bb)) + (b - bb);
  acc.hi = s;
  acc.lo = acc.lo + (e2 - small);
}

// The mirror rule of elop.extend_interior on one axis of length len >= 2,
// for an index in [-1, len].
__device__ __forceinline__ int fold(int k, int len) {
  return k < 0 ? -k : (k >= len ? 2 * len - 2 - k : k);
}

// The P planes' values at one pixel: plane k at at[k * plane].
template <int P>
__device__ __forceinline__ void load_row(float (&raw)[P], const float* __restrict__ at,
                                         size_t plane) {
#pragma unroll
  for (int k = 0; k < P; ++k, at += plane) raw[k] = *at;
}

template <bool kResidual, bool kFixed>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    el_df32_kernel(const float* __restrict__ planes, const float* __restrict__ scalars,
                   const float* __restrict__ rhs_hi, const float* __restrict__ rhs_lo,
                   const float* __restrict__ x_hi, const float* __restrict__ x_lo,
                   float* __restrict__ out, int m, int n, int tiles_x, int tiles) {
  constexpr int P = kFixed ? 26 : 24;
  __shared__ float4 stage[3][kHalo];  // per field: (x, split(x), x_lo) of the halo tile
  const int tile = blockIdx.x % tiles;
  const int b = blockIdx.x / tiles;
  const int i0 = (tile / tiles_x) * kTileRows;
  const int j0 = (tile % tiles_x) * kCols;
  const int tx = threadIdx.x;
  const int tid = threadIdx.y * kCols + tx;
  const size_t plane = static_cast<size_t>(m) * n;
  const size_t fields = 3 * plane * b;

  // the tile's mirror-extended fields, element (r, c) = extended interior
  // pixel (i0 - 1 + r, j0 - 1 + c), for r, c inside the extended grid
  for (int idx = tid; idx < kHalo; idx += kThreads) {
    const int r = idx / kHaloW;
    const int c = idx - r * kHaloW;
    const int fi = i0 - 1 + r, fj = j0 - 1 + c;
    if (fi > m || fj > n) continue;
    const bool corner = (fi < 0 || fi == m) && (fj < 0 || fj == n);
    const size_t at = fields + static_cast<size_t>(fold(fi, m)) * n + fold(fj, n);
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      float hi = x_hi[at + f * plane];
      float lo = kResidual ? x_lo[at + f * plane] : 0.0f;
      if (corner) {
        hi = hi * 2.0f;
        lo = lo * 2.0f;
      }
      const float s = kSplit * hi;  // df32.split of the extended value
      const float sh = s - (s - hi);
      stage[f][idx] = make_float4(hi, sh, hi - sh, lo);
    }
  }

  // the pair's scalars, split once
  const float* sc = scalars + 6 * b;
  const Coeff a_s = coeff(sc[0], sc[1]), a_r = coeff(sc[2], sc[3]), gD = coeff(sc[4], sc[5]);
  __syncthreads();

  const int j = j0 + tx;
  const int i_first = i0 + threadIdx.y * kRowsPerThread;
  const float* pl = planes + P * plane * b + static_cast<size_t>(i_first) * n + j;
#pragma unroll 1
  for (int rr = 0; rr < kRowsPerThread; ++rr) {
    const int lr = threadIdx.y * kRowsPerThread + rr;  // the row in the tile
    const int i = i0 + lr;
    if (i >= m || j >= n) break;  // rows only grow along the loop
    const size_t at = static_cast<size_t>(i) * n + j;
    float raw[P];  // the row's coefficient planes, read once, coalesced across the warp
    load_row<P>(raw, pl + static_cast<size_t>(rr) * n, plane);
    auto c = [&](int k) { return coeff(raw[2 * k], raw[2 * k + 1]); };
    const Coeff diag_x = c(kDiagX), diag_y = c(kDiagY), cross = c(kCross);
    const Coeff adv_xm = c(kAdvXm), adv_xp = c(kAdvXp);
    const Coeff adv_ym = c(kAdvYm), adv_yp = c(kAdvYp);
    const Coeff gx = c(kGx), gy = c(kGy), quart = c(kQuart);
    const Coeff half_I = c(kHalfI), dIdx = c(kDIdx);
    const Coeff dIdy = kFixed ? c(kDIdy) : dIdx;

    Pair r0{0.0f, 0.0f}, r1{0.0f, 0.0f}, r2{0.0f, 0.0f};
    if (kResidual) {
      r0 = {rhs_hi[fields + at], rhs_lo[fields + at]};
      r1 = {rhs_hi[fields + plane + at], rhs_lo[fields + plane + at]};
      r2 = {rhs_hi[fields + 2 * plane + at], rhs_lo[fields + 2 * plane + at]};
    }
    // the staged value of field f at (i + di, j + dj)
    const int o = (lr + 1) * kHaloW + tx + 1;
    auto x = [&](int f, int di, int dj) { return stage[f][o + di * kHaloW + dj]; };
    constexpr bool R = kResidual;

    // the term lists of elop.el_residual_df, in its order
    acc_sub<R, false>(r0, diag_x, x(kUx, 0, 0));
    acc_sub<R, false>(r0, cross, x(kUy, 0, 0));
    acc_sub<R, false>(r0, adv_xm, x(kUx, -1, 0));
    acc_sub<R, false>(r0, adv_xp, x(kUx, +1, 0));
    acc_sub<R, false>(r0, a_s, x(kUx, 0, -1));
    acc_sub<R, false>(r0, a_s, x(kUx, 0, +1));
    acc_sub<R, false>(r0, gx, x(kUy, 0, +1));
    acc_sub<R, true>(r0, gx, x(kUy, 0, -1));
    acc_sub<R, false>(r0, gy, x(kUy, +1, 0));
    acc_sub<R, true>(r0, gy, x(kUy, -1, 0));
    acc_sub<R, false>(r0, quart, x(kUy, -1, -1));
    acc_sub<R, false>(r0, quart, x(kUy, +1, +1));
    acc_sub<R, true>(r0, quart, x(kUy, -1, +1));
    acc_sub<R, true>(r0, quart, x(kUy, +1, -1));
    acc_sub<R, false>(r0, half_I, x(kG, -1, 0));
    acc_sub<R, true>(r0, half_I, x(kG, +1, 0));

    acc_sub<R, false>(r1, diag_y, x(kUy, 0, 0));
    acc_sub<R, false>(r1, cross, x(kUx, 0, 0));
    acc_sub<R, false>(r1, adv_ym, x(kUy, 0, -1));
    acc_sub<R, false>(r1, adv_yp, x(kUy, 0, +1));
    acc_sub<R, false>(r1, a_s, x(kUy, -1, 0));
    acc_sub<R, false>(r1, a_s, x(kUy, +1, 0));
    acc_sub<R, false>(r1, gy, x(kUx, +1, 0));
    acc_sub<R, true>(r1, gy, x(kUx, -1, 0));
    acc_sub<R, false>(r1, gx, x(kUx, 0, +1));
    acc_sub<R, true>(r1, gx, x(kUx, 0, -1));
    acc_sub<R, false>(r1, quart, x(kUx, -1, -1));
    acc_sub<R, false>(r1, quart, x(kUx, +1, +1));
    acc_sub<R, true>(r1, quart, x(kUx, -1, +1));
    acc_sub<R, true>(r1, quart, x(kUx, +1, -1));
    acc_sub<R, false>(r1, half_I, x(kG, 0, -1));
    acc_sub<R, true>(r1, half_I, x(kG, 0, +1));

    acc_sub<R, false>(r2, gD, x(kG, 0, 0));
    acc_sub<R, false>(r2, dIdx, x(kUx, 0, 0));
    acc_sub<R, false>(r2, dIdy, x(kUy, 0, 0));
    acc_sub<R, false>(r2, a_r, x(kG, -1, 0));
    acc_sub<R, false>(r2, a_r, x(kG, +1, 0));
    acc_sub<R, false>(r2, a_r, x(kG, 0, -1));
    acc_sub<R, false>(r2, a_r, x(kG, 0, +1));
    acc_sub<R, false>(r2, half_I, x(kUx, +1, 0));
    acc_sub<R, true>(r2, half_I, x(kUx, -1, 0));
    acc_sub<R, false>(r2, half_I, x(kUy, 0, +1));
    acc_sub<R, true>(r2, half_I, x(kUy, 0, -1));

    // df32.df_result, negated in operator mode
    const float y0 = r0.hi + r0.lo, y1 = r1.hi + r1.lo, y2 = r2.hi + r2.lo;
    out[fields + at] = kResidual ? y0 : -y0;
    out[fields + plane + at] = kResidual ? y1 : -y1;
    out[fields + 2 * plane + at] = kResidual ? y2 : -y2;
  }
}

template <bool kResidual, bool kFixed>
int launch(const float* planes, const float* scalars, const float* rhs_hi, const float* rhs_lo,
           const float* x_hi, const float* x_lo, float* out, int B, int m, int n,
           cudaStream_t stream) {
  const int tiles_x = (n + kCols - 1) / kCols;
  const long long tiles = static_cast<long long>(tiles_x) * ((m + kTileRows - 1) / kTileRows);
  const long long blocks = tiles * B;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  el_df32_kernel<kResidual, kFixed><<<static_cast<unsigned>(blocks), dim3(kCols, kWarps), 0,
                                      stream>>>(planes, scalars, rhs_hi, rhs_lo, x_hi, x_lo,
                                                out, m, n, tiles_x, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

template <bool kResidual, bool kFixed>
int resident(int* blocks_per_sm) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, el_df32_kernel<kResidual, kFixed>, kThreads, 0));
}

}  // namespace

// Launches kernel B4 on `stream` and returns the CUDA error of the launch;
// the caller checks shapes (P = 24 or 26, m, n >= 2), types and
// contiguity.  rhs_hi, rhs_lo and x_lo are read in residual mode only.
extern "C" int el_df32(const float* planes, const float* scalars, const float* rhs_hi,
                       const float* rhs_lo, const float* x_hi, const float* x_lo, float* out,
                       int B, int P, int m, int n, int residual, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (P == 26) {
    return residual ? launch<true, true>(planes, scalars, rhs_hi, rhs_lo, x_hi, x_lo, out, B, m, n, s)
                    : launch<false, true>(planes, scalars, rhs_hi, rhs_lo, x_hi, x_lo, out, B, m, n, s);
  }
  return residual ? launch<true, false>(planes, scalars, rhs_hi, rhs_lo, x_hi, x_lo, out, B, m, n, s)
                  : launch<false, false>(planes, scalars, rhs_hi, rhs_lo, x_hi, x_lo, out, B, m, n, s);
}

// The warps of kernel B4 resident on one SM of the current device at once,
// for P planes and the mode: blocks an SM (the occupancy calculator's, from
// the kernel's registers and shared memory) times its warps a block.
extern "C" int el_df32_warps_per_sm(int P, int residual, int* warps) {
  int blocks = 0;
  const int rc = P == 26 ? (residual ? resident<true, true>(&blocks) : resident<false, true>(&blocks))
                         : (residual ? resident<true, false>(&blocks) : resident<false, false>(&blocks));
  *warps = blocks * kWarps;
  return rc;
}
