// The double-float (df32) residual and operator of the reduced
// Euler-Lagrange system for Hopper (sm_90a): kernel B4.
//
// It has no Pallas counterpart.  It replaces what XLA fuses out of the JAX
// functions opticalflow_tpu/ops/elop.py::el_residual_df (:519) and
// el_matvec_df (:590), the refinement's residual and the operator of its
// correction solves; the port's plain versions are ops/elop.py::
// el_residual_df and el_matvec_df, which run it as ~1,200 torch ops a call.
// Two modes, one kernel:
//   residual  r = b - A (x_hi + x_lo)
//   operator  y = A x: the residual with b = 0 and x_lo = 0, negated.
// One thread computes the three channels of one interior pixel of one pair.
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
// mirror extension of elop.extend_interior is done by index, for x_hi and
// x_lo apart: row -1 reads row 1, row m reads row m - 2, columns likewise,
// and only the four corners of the extended grid, where row and column are
// both mirrored, are doubled (exact).
//
// What bounds it: memory.  A pixel reads P coefficient planes and x, and
// writes y: 120 bytes at P = 24 in operator mode, 156 in residual mode (+
// x_lo and the two rhs planes), against 43 terms of 29 float operations
// (two_prod 17, the small terms 4, two_sum 6, the tail 2).  This first
// version reads its operands straight from global memory, one pixel a
// thread, the 9-point neighbourhood through L1; tiling the fields through
// shared memory, or rebuilding the planes from the frames as B1 does, is
// later work (ROADMAP B).

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;  // threads of a block along a row
constexpr int kRows = 8;   // rows of a block
constexpr float kSplit = 4097.0f;  // 2^12 + 1: Dekker's split of a 24-bit significand

// coefficient k's hi plane is 2k, its lo plane 2k + 1
enum Coef { kDiagX, kDiagY, kCross, kAdvXm, kAdvXp, kAdvYm, kAdvYp, kGx, kGy, kQuart, kHalfI,
            kDIdx, kDIdy };
enum Field { kUx, kUy, kG };

struct Pair {
  float hi, lo;
};

// df32.two_prod: p = fl(a b), e its exact error, from the Dekker splits.
__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  p = a * b;
  const float ca = kSplit * a;
  const float a_hi = ca - (ca - a);
  const float a_lo = a - a_hi;
  const float cb = kSplit * b;
  const float b_hi = cb - (cb - b);
  const float b_lo = b - b_hi;
  e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo;
}

// elop.el_residual_df's acc_sub: acc -= coef * value.
__device__ __forceinline__ void acc_sub(Pair& acc, Pair coef, Pair value) {
  float p, e;
  two_prod(coef.hi, value.hi, p, e);
  const float small = e + coef.lo * value.hi + coef.hi * value.lo;
  // df32.two_sum(acc.hi, -p)
  const float b = -p;
  const float s = acc.hi + b;
  const float bb = s - acc.hi;
  const float e2 = (acc.hi - (s - bb)) + (b - bb);
  acc.hi = s;
  acc.lo = acc.lo + (e2 - small);
}

__device__ __forceinline__ Pair neg(Pair c) { return {-c.hi, -c.lo}; }

struct Pixel {
  const float* __restrict__ planes;  // this pair's P planes
  const float* __restrict__ x_hi;    // this pair's three field planes
  const float* __restrict__ x_lo;    // null in operator mode
  long long plane;                   // m * n
  int i, j, m, n;

  __device__ __forceinline__ Pair coef(int k) const {
    const long long at = static_cast<long long>(i) * n + j;
    return {planes[2 * k * plane + at], planes[(2 * k + 1) * plane + at]};
  }

  // The mirror-extended field at interior (i + di, j + dj), |di|, |dj| <= 1.
  __device__ __forceinline__ Pair field(int f, int di, int dj) const {
    int r = i + di, c = j + dj;
    const bool row_out = r < 0 || r >= m, col_out = c < 0 || c >= n;
    r = r < 0 ? -r : (r >= m ? 2 * m - 2 - r : r);
    c = c < 0 ? -c : (c >= n ? 2 * n - 2 - c : c);
    const long long at = f * plane + static_cast<long long>(r) * n + c;
    Pair v{x_hi[at], x_lo ? x_lo[at] : 0.0f};
    if (row_out && col_out) {  // a corner of the extended grid
      v.hi = v.hi * 2.0f;
      v.lo = v.lo * 2.0f;
    }
    return v;
  }
};

__global__ void __launch_bounds__(kCols* kRows)
    el_df32_kernel(const float* __restrict__ planes, const float* __restrict__ scalars,
                   const float* __restrict__ rhs_hi, const float* __restrict__ rhs_lo,
                   const float* __restrict__ x_hi, const float* __restrict__ x_lo,
                   float* __restrict__ out, int P, int m, int n, int tiles_x, int tiles,
                   int residual) {
  const int tile = blockIdx.x % tiles;
  const int b = blockIdx.x / tiles;
  const int i = (tile / tiles_x) * kRows + threadIdx.y;
  const int j = (tile % tiles_x) * kCols + threadIdx.x;
  if (i >= m || j >= n) return;
  const long long plane = static_cast<long long>(m) * n;
  const long long fields = 3 * plane * b;
  Pixel px{planes + P * plane * b, x_hi + fields, residual ? x_lo + fields : nullptr,
           plane, i, j, m, n};
  const float* s = scalars + 6 * b;
  const Pair a_s{s[0], s[1]}, a_r{s[2], s[3]}, gD{s[4], s[5]};
  const Pair diag_x = px.coef(kDiagX), diag_y = px.coef(kDiagY), cross = px.coef(kCross);
  const Pair adv_xm = px.coef(kAdvXm), adv_xp = px.coef(kAdvXp);
  const Pair adv_ym = px.coef(kAdvYm), adv_yp = px.coef(kAdvYp);
  const Pair gx = px.coef(kGx), gy = px.coef(kGy), quart = px.coef(kQuart);
  const Pair half_I = px.coef(kHalfI), dIdx = px.coef(kDIdx);
  const Pair dIdy = P == 26 ? px.coef(kDIdy) : dIdx;
  const long long at = static_cast<long long>(i) * n + j;

  Pair r[3];
  for (int q = 0; q < 3; ++q) {
    r[q] = residual ? Pair{rhs_hi[fields + q * plane + at], rhs_lo[fields + q * plane + at]}
                    : Pair{0.0f, 0.0f};
  }
  // the term lists of elop.el_residual_df, in its order
  acc_sub(r[0], diag_x, px.field(kUx, 0, 0));
  acc_sub(r[0], cross, px.field(kUy, 0, 0));
  acc_sub(r[0], adv_xm, px.field(kUx, -1, 0));
  acc_sub(r[0], adv_xp, px.field(kUx, +1, 0));
  acc_sub(r[0], a_s, px.field(kUx, 0, -1));
  acc_sub(r[0], a_s, px.field(kUx, 0, +1));
  acc_sub(r[0], gx, px.field(kUy, 0, +1));
  acc_sub(r[0], neg(gx), px.field(kUy, 0, -1));
  acc_sub(r[0], gy, px.field(kUy, +1, 0));
  acc_sub(r[0], neg(gy), px.field(kUy, -1, 0));
  acc_sub(r[0], quart, px.field(kUy, -1, -1));
  acc_sub(r[0], quart, px.field(kUy, +1, +1));
  acc_sub(r[0], neg(quart), px.field(kUy, -1, +1));
  acc_sub(r[0], neg(quart), px.field(kUy, +1, -1));
  acc_sub(r[0], half_I, px.field(kG, -1, 0));
  acc_sub(r[0], neg(half_I), px.field(kG, +1, 0));

  acc_sub(r[1], diag_y, px.field(kUy, 0, 0));
  acc_sub(r[1], cross, px.field(kUx, 0, 0));
  acc_sub(r[1], adv_ym, px.field(kUy, 0, -1));
  acc_sub(r[1], adv_yp, px.field(kUy, 0, +1));
  acc_sub(r[1], a_s, px.field(kUy, -1, 0));
  acc_sub(r[1], a_s, px.field(kUy, +1, 0));
  acc_sub(r[1], gy, px.field(kUx, +1, 0));
  acc_sub(r[1], neg(gy), px.field(kUx, -1, 0));
  acc_sub(r[1], gx, px.field(kUx, 0, +1));
  acc_sub(r[1], neg(gx), px.field(kUx, 0, -1));
  acc_sub(r[1], quart, px.field(kUx, -1, -1));
  acc_sub(r[1], quart, px.field(kUx, +1, +1));
  acc_sub(r[1], neg(quart), px.field(kUx, -1, +1));
  acc_sub(r[1], neg(quart), px.field(kUx, +1, -1));
  acc_sub(r[1], half_I, px.field(kG, 0, -1));
  acc_sub(r[1], neg(half_I), px.field(kG, 0, +1));

  acc_sub(r[2], gD, px.field(kG, 0, 0));
  acc_sub(r[2], dIdx, px.field(kUx, 0, 0));
  acc_sub(r[2], dIdy, px.field(kUy, 0, 0));
  acc_sub(r[2], a_r, px.field(kG, -1, 0));
  acc_sub(r[2], a_r, px.field(kG, +1, 0));
  acc_sub(r[2], a_r, px.field(kG, 0, -1));
  acc_sub(r[2], a_r, px.field(kG, 0, +1));
  acc_sub(r[2], half_I, px.field(kUx, +1, 0));
  acc_sub(r[2], neg(half_I), px.field(kUx, -1, 0));
  acc_sub(r[2], half_I, px.field(kUy, 0, +1));
  acc_sub(r[2], neg(half_I), px.field(kUy, 0, -1));

  for (int q = 0; q < 3; ++q) {
    const float v = r[q].hi + r[q].lo;  // df32.df_result
    out[fields + q * plane + at] = residual ? v : -v;
  }
}

}  // namespace

// Launches kernel B4 on `stream` and returns the CUDA error of the launch;
// the caller checks shapes (P = 24 or 26, m, n >= 2), types and
// contiguity.  rhs_hi, rhs_lo and x_lo are read in residual mode only.
extern "C" int el_df32(const float* planes, const float* scalars, const float* rhs_hi,
                       const float* rhs_lo, const float* x_hi, const float* x_lo, float* out,
                       int B, int P, int m, int n, int residual, void* stream) {
  const int tiles_x = (n + kCols - 1) / kCols;
  const long long tiles = static_cast<long long>(tiles_x) * ((m + kRows - 1) / kRows);
  const long long blocks = tiles * B;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  el_df32_kernel<<<static_cast<unsigned>(blocks), dim3(kCols, kRows), 0,
                   static_cast<cudaStream_t>(stream)>>>(
      planes, scalars, rhs_hi, rhs_lo, x_hi, x_lo, out, P, m, n, tiles_x,
      static_cast<int>(tiles), residual);
  return static_cast<int>(cudaGetLastError());
}
