// The fused reduced Euler-Lagrange stencil shared by the port's matvec
// kernels (Hopper, sm_90a): el_matvec.cu (mirror folds, TPU kernel B1),
// el_matvec_plain.cu (zero reads outside the interior, TPU kernel B2) and
// el_matvec_ext.cu (a pre-extended field block, TPU kernel B3).
//
// Layout (no TPU container, no padding invariant):
//   I       (B, m+2, n+2) f32   normalised previous frames (B3: each block
//                               of the true frame with its one-pixel halo)
//   scalars (B, 2)        f32   per-pair (alpha_s, alpha_r)
//   u       (B, K, 3, m, n) f32 K field stacks per pair (K = 1 in the Krylov
//                               loop, 27 for the multigrid comb probes);
//                               B3: (B, K, 3, m+2, n+2), already extended
//   out     (B, K, 3, m, n) f32
//   compat                      dy rule of the whole call (1: dIdy = dIdx)
//
// What bounds it: memory.  One application moves 7 planes per field stack
// (I plus 3 field planes in, 3 out: 28 bytes a pixel) for ~110 flops a
// pixel, far below the card's flop/byte balance.  The per-pixel arithmetic
// (the coefficient rebuild and the 9-point / 3-field stencil) is the pair
// of inline functions `coefficients` and `apply` below, which all three
// kernels call; the 11 coefficient planes never touch device memory.
//
// B2 and B3 share one kernel here: a 32x8 block stages the I tile and the
// three u tiles, each with a one-pixel halo, in shared memory (coalesced
// row loads), and every thread then reads its 3x3 neighbourhoods from
// there, one thread per output pixel.  They differ only in where the halo
// tile comes from (the staging rule below), decided while staging, so the
// stencil itself has no selects.  B1 has its own kernel (el_matvec.cu):
// register-blocked strips, a ring of asynchronously staged tiles, and the
// coefficients built once per tile for all K field stacks.  No atomics:
// results are deterministic.

#pragma once

#include <cuda_runtime.h>

namespace el_stencil {

constexpr int kTileX = 32;  // columns (contiguous axis)
constexpr int kTileY = 8;   // rows
constexpr int kHaloW = kTileX + 2;
constexpr int kHaloH = kTileY + 2;

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

// Staging rule of the field's halo tile in the B2 / B3 kernel; each is its
// own `if constexpr` branch, so each kernel compiles only its own.
//   kZero: the plain stencil, field reads outside [0, m) x [0, n) are zero;
//   kExtended: u is already extended, (m+2, n+2) per plane; tile element
//     (r, c) is u_ext[i0 + r][j0 + c], with no folds and no select beyond
//     the ragged-edge bound.
enum Staging : int { kZero = 1, kExtended = 2 };

template <int kRule>
__global__ void __launch_bounds__(kTileX * kTileY)
el_matvec_kernel(const float* __restrict__ I, const float* __restrict__ scalars,
                 const float* __restrict__ u, float* __restrict__ out,
                 int K, int m, int n, int compat) {
  __shared__ float sI[kHaloH][kHaloW];
  __shared__ float sU[3][kHaloH][kHaloW];

  const int bk = blockIdx.z;  // pair * K + field stack
  const int b = bk / K;
  const int i0 = blockIdx.y * kTileY;
  const int j0 = blockIdx.x * kTileX;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const size_t plane = static_cast<size_t>(m) * n;
  const int ni = m + 2, nj = n + 2;
  const float* Ib = I + static_cast<size_t>(b) * ni * nj;
  // field plane: (m, n), or (m+2, n+2) pre-extended
  const size_t uplane = kRule == kExtended ? static_cast<size_t>(ni) * nj : plane;
  const float* ub = u + static_cast<size_t>(bk) * 3 * uplane;
  float* ob = out + static_cast<size_t>(bk) * 3 * plane;

  // Stage: tile element (r, c) holds frame pixel (i0 + r, j0 + c) of I and
  // the (extended) interior field value at (i0 - 1 + r, j0 - 1 + c), i.e.
  // extended pixel (i0 + r, j0 + c).
  for (int idx = ty * kTileX + tx; idx < kHaloH * kHaloW; idx += kTileX * kTileY) {
    const int r = idx / kHaloW;
    const int c = idx - r * kHaloW;
    const int fi = i0 + r, fj = j0 + c;
    sI[r][c] = (fi < ni && fj < nj) ? Ib[static_cast<size_t>(fi) * nj + fj] : 0.f;
    if constexpr (kRule == kZero) {
      const int si = i0 - 1 + r, sj = j0 - 1 + c;
      const bool ok = si >= 0 && si < m && sj >= 0 && sj < n;
      // (the offset is formed even where it is not read: a select on it
      // costs ~6% of the device time at K = 1)
      const size_t off = static_cast<size_t>(si) * n + sj;
#pragma unroll
      for (int q = 0; q < 3; ++q) sU[q][r][c] = ok ? ub[q * plane + off] : 0.f;
    } else {
      static_assert(kRule == kExtended, "unknown staging rule");
      const bool ok = fi < ni && fj < nj;
      const size_t off = static_cast<size_t>(fi) * nj + fj;
#pragma unroll
      for (int q = 0; q < 3; ++q) sU[q][r][c] = ok ? ub[q * uplane + off] : 0.f;
    }
  }
  __syncthreads();

  const int i = i0 + ty, j = j0 + tx;
  if (i >= m || j >= n) return;

  float s[3][3], ux[3][3], uy[3][3], g[3][3], y[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int bb = 0; bb < 3; ++bb) {
      s[a][bb] = sI[ty + a][tx + bb];
      ux[a][bb] = sU[0][ty + a][tx + bb];
      uy[a][bb] = sU[1][ty + a][tx + bb];
      g[a][bb] = sU[2][ty + a][tx + bb];
    }
  }
  const float a_s = scalars[2 * b];
  const float a_r = scalars[2 * b + 1];
  apply(coefficients(s, a_s, compat), a_s, a_r, ux, uy, g, y);

  const size_t o = static_cast<size_t>(i) * n + j;
  ob[o] = y[0];
  ob[plane + o] = y[1];
  ob[2 * plane + o] = y[2];
}

// Launches on `stream` and returns cudaGetLastError() of the launch; the
// caller checks shapes (B * K <= 65535: the grid's z limit) and contiguity.
template <int kRule>
int launch(const float* I, const float* scalars, const float* u, float* out, int B, int K,
           int m, int n, int compat, void* stream) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((n + kTileX - 1) / kTileX, (m + kTileY - 1) / kTileY, B * K);
  el_matvec_kernel<kRule><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      I, scalars, u, out, K, m, n, compat);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace el_stencil
