// The fused reduced Euler-Lagrange stencil shared by the port's matvec
// kernels (Hopper, sm_90a): el_matvec.cu (mirror folds, TPU kernel B1),
// el_matvec_plain.cu (zero reads outside the interior, TPU kernel B2) and
// el_matvec_ext.cu (mesh tiles with their seams, TPU kernel B3).  All
// three instantiate one tiled kernel, el_tiles.cuh, with their staging
// rule as its parameter.
//
// Layout (no TPU container, no padding invariant):
//   I       (B, m+2, n+2) f32   normalised previous frames (B3: each block
//                               of the true frame with its one-pixel halo)
//   scalars (B, 2)        f32   per-pair (alpha_s, alpha_r)
//   u       (B, K, 3, m, n) f32 K field stacks per pair (K = 1 in the Krylov
//                               loop, 27 for the multigrid comb probes)
//   out     (B, K, 3, m, n) f32
//   compat                      dy rule of the whole call (1: dIdy = dIdx)
//
// What bounds it: memory.  One application moves 7 planes per field stack
// (I plus 3 field planes in, 3 out: 28 bytes a pixel) for ~110 flops a
// pixel, far below the card's flop/byte balance.  The per-pixel arithmetic
// (the coefficient rebuild and the 9-point / 3-field stencil) is the pair
// of inline functions `coefficients` and `apply` below; the 11 coefficient
// planes never touch device memory.  No atomics: results are
// deterministic.

#pragma once

#include <cuda_runtime.h>

namespace el_stencil {

// The coefficients of one output pixel, rebuilt from I as at
// pallas_kernels.py:445-463 (and :711-729): the 11 planes and the two
// derivatives the remodelling row reads.
struct Coeffs {
  float dIdx, dIdy, diag_x, diag_y, cross, adv_xm, adv_xp, adv_ym, adv_yp, gx, gy, quart, half_i;
};

// s[a][b] = I(i + a, j + b) of the full frame for output pixel (i, j).
__device__ __forceinline__ Coeffs coefficients(const float (&s)[3][3], float a_s, int compat) {
  Coeffs c;
  const float Ic = s[1][1];
  c.dIdx = 0.5f * (s[2][1] - s[0][1]);
  c.dIdy = compat ? c.dIdx : 0.5f * (s[1][2] - s[1][0]);
  const float dIdxx = s[2][1] + s[0][1] - 2.f * Ic;
  const float dIdyy = s[1][2] + s[1][0] - 2.f * Ic;
  const float dIdxy = 0.25f * (s[2][2] - s[2][0] - s[0][2] + s[0][0]);

  c.diag_x = Ic * (dIdxx - 2.f * Ic) - 4.f * a_s;
  c.diag_y = Ic * (dIdyy - 2.f * Ic) - 4.f * a_s;
  c.cross = Ic * dIdxy;
  c.adv_xm = Ic * (-c.dIdx + Ic) + a_s;
  c.adv_xp = Ic * (c.dIdx + Ic) + a_s;
  c.adv_ym = Ic * (-c.dIdy + Ic) + a_s;
  c.adv_yp = Ic * (c.dIdy + Ic) + a_s;
  c.gx = Ic * c.dIdx * 0.5f;
  c.gy = Ic * c.dIdy * 0.5f;
  c.quart = Ic * Ic * 0.25f;
  c.half_i = Ic * 0.5f;
  return c;
}

// The stencil, term for term as at pallas_kernels.py:527-556 (and
// :751-780).  ux/uy/g[a][b] = field at interior (i + a - 1, j + b - 1),
// as the caller's staging rule extends it; y = (y_ux, y_uy, y_g).
__device__ __forceinline__ void apply(const Coeffs& c, float a_s, float a_r,
                                      const float (&ux)[3][3], const float (&uy)[3][3],
                                      const float (&g)[3][3], float (&y)[3]) {
  y[0] = c.diag_x * ux[1][1]
      + c.cross * uy[1][1]
      + c.adv_xm * ux[0][1]
      + c.adv_xp * ux[2][1]
      + a_s * (ux[1][0] + ux[1][2])
      + c.gx * (uy[1][2] - uy[1][0])
      + c.gy * (uy[2][1] - uy[0][1])
      + c.quart * (uy[0][0] + uy[2][2] - uy[0][2] - uy[2][0])
      + c.half_i * (g[0][1] - g[2][1]);
  y[1] = c.diag_y * uy[1][1]
      + c.cross * ux[1][1]
      + c.adv_ym * uy[1][0]
      + c.adv_yp * uy[1][2]
      + a_s * (uy[0][1] + uy[2][1])
      + c.gy * (ux[2][1] - ux[0][1])
      + c.gx * (ux[1][2] - ux[1][0])
      + c.quart * (ux[0][0] + ux[2][2] - ux[0][2] - ux[2][0])
      + c.half_i * (g[1][0] - g[1][2]);
  y[2] = (-1.f - 4.f * a_r) * g[1][1]
      + c.dIdx * ux[1][1]
      + c.dIdy * uy[1][1]
      + a_r * (g[0][1] + g[2][1] + g[1][0] + g[1][2])
      + c.half_i * (ux[2][1] - ux[0][1])
      + c.half_i * (uy[1][2] - uy[1][0]);
}

}  // namespace el_stencil
