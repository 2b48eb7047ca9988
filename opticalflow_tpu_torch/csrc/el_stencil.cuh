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
// (I plus 3 field planes in, 3 out: 28 bytes a pixel) for ~150 flops a
// pixel, far below the card's flop/byte balance.  The design therefore
// reads every input element from device memory once: a 32x8 block stages
// the I tile and the three u tiles, each with a one-pixel halo, in shared
// memory (coalesced row loads), and every thread then reads its 3x3
// neighbourhoods from there.  The 11 coefficient planes never touch device
// memory: they are rebuilt in registers from the staged I tile.  The three
// kernels differ only in where the halo tile comes from (the staging rule
// below), which is decided while staging, so the stencil itself has no
// selects.  One thread per output pixel, no atomics: results are
// deterministic.

#pragma once

#include <cuda_runtime.h>

namespace el_stencil {

constexpr int kTileX = 32;  // columns (contiguous axis)
constexpr int kTileY = 8;   // rows
constexpr int kHaloW = kTileX + 2;
constexpr int kHaloH = kTileY + 2;

// Interior index of extended index e in [-1, len]; -1 when e lies beyond
// the one-pixel ring (only read by threads whose output is discarded).
__device__ __forceinline__ int fold(int e, int len, bool* mirrored) {
  *mirrored = (e == -1) || (e == len);
  if (e == -1) return 1;
  if (e == len) return len - 2;
  return (e >= 0 && e < len) ? e : -1;
}

// Staging rule of the field's halo tile; each is its own `if constexpr`
// branch, so each kernel compiles only its own.
//   kFold: the reduced system's mirror extension (elop.extend_interior:
//     row -1 reads row 1, row m reads row m-2, columns likewise, value
//     doubled where both indices were mirrored);
//   kZero: the plain stencil, field reads outside [0, m) x [0, n) are zero;
//   kExtended: u is already extended, (m+2, n+2) per plane; tile element
//     (r, c) is u_ext[i0 + r][j0 + c], with no folds and no select beyond
//     the ragged-edge bound.
enum Staging : int { kFold = 0, kZero = 1, kExtended = 2 };

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
    // (the offset is formed even where it is not read: a select on it costs
    // B1 ~6% of its device time at K = 1)
    if constexpr (kRule == kFold) {
      bool mr, mc;
      const int si = fold(i0 - 1 + r, m, &mr);
      const int sj = fold(j0 - 1 + c, n, &mc);
      const bool ok = si >= 0 && sj >= 0;
      const float f = (mr && mc) ? 2.f : 1.f;
      const size_t off = static_cast<size_t>(si) * n + sj;
#pragma unroll
      for (int q = 0; q < 3; ++q) sU[q][r][c] = ok ? f * ub[q * plane + off] : 0.f;
    } else if constexpr (kRule == kZero) {
      const int si = i0 - 1 + r, sj = j0 - 1 + c;
      const bool ok = si >= 0 && si < m && sj >= 0 && sj < n;
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

  const float a_s = scalars[2 * b];
  const float a_r = scalars[2 * b + 1];

  // I(i + a, j + bb) of the full frame for output pixel (i, j), a, bb in 0..2
#define SI(a, bb) sI[ty + (a)][tx + (bb)]
  // field q at interior (i + a - 1, j + bb - 1), as staged
#define UX(a, bb) sU[0][ty + (a)][tx + (bb)]
#define UY(a, bb) sU[1][ty + (a)][tx + (bb)]
#define G(a, bb) sU[2][ty + (a)][tx + (bb)]

  // coefficients, as rebuilt at pallas_kernels.py:445-463 (and :711-729)
  const float Ic = SI(1, 1);
  const float dIdx = 0.5f * (SI(2, 1) - SI(0, 1));
  const float dIdy = compat ? dIdx : 0.5f * (SI(1, 2) - SI(1, 0));
  const float dIdxx = SI(2, 1) + SI(0, 1) - 2.f * Ic;
  const float dIdyy = SI(1, 2) + SI(1, 0) - 2.f * Ic;
  const float dIdxy = 0.25f * (SI(2, 2) - SI(2, 0) - SI(0, 2) + SI(0, 0));

  const float diag_x = Ic * (dIdxx - 2.f * Ic) - 4.f * a_s;
  const float diag_y = Ic * (dIdyy - 2.f * Ic) - 4.f * a_s;
  const float cross = Ic * dIdxy;
  const float adv_xm = Ic * (-dIdx + Ic) + a_s;
  const float adv_xp = Ic * (dIdx + Ic) + a_s;
  const float adv_ym = Ic * (-dIdy + Ic) + a_s;
  const float adv_yp = Ic * (dIdy + Ic) + a_s;
  const float gx = Ic * dIdx * 0.5f;
  const float gy = Ic * dIdy * 0.5f;
  const float quart = Ic * Ic * 0.25f;
  const float half_i = Ic * 0.5f;

  // the stencil, term for term as at pallas_kernels.py:527-556 (and :751-780)
  const float y_ux = diag_x * UX(1, 1)
      + cross * UY(1, 1)
      + adv_xm * UX(0, 1)
      + adv_xp * UX(2, 1)
      + a_s * (UX(1, 0) + UX(1, 2))
      + gx * (UY(1, 2) - UY(1, 0))
      + gy * (UY(2, 1) - UY(0, 1))
      + quart * (UY(0, 0) + UY(2, 2) - UY(0, 2) - UY(2, 0))
      + half_i * (G(0, 1) - G(2, 1));
  const float y_uy = diag_y * UY(1, 1)
      + cross * UX(1, 1)
      + adv_ym * UY(1, 0)
      + adv_yp * UY(1, 2)
      + a_s * (UY(0, 1) + UY(2, 1))
      + gy * (UX(2, 1) - UX(0, 1))
      + gx * (UX(1, 2) - UX(1, 0))
      + quart * (UX(0, 0) + UX(2, 2) - UX(0, 2) - UX(2, 0))
      + half_i * (G(1, 0) - G(1, 2));
  const float y_g = (-1.f - 4.f * a_r) * G(1, 1)
      + dIdx * UX(1, 1)
      + dIdy * UY(1, 1)
      + a_r * (G(0, 1) + G(2, 1) + G(1, 0) + G(1, 2))
      + half_i * (UX(2, 1) - UX(0, 1))
      + half_i * (UY(1, 2) - UY(1, 0));
#undef SI
#undef UX
#undef UY
#undef G

  const size_t o = static_cast<size_t>(i) * n + j;
  ob[o] = y_ux;
  ob[plane + o] = y_uy;
  ob[2 * plane + o] = y_g;
}

// Launches on `stream` and returns cudaGetLastError() of the launch; the
// caller checks shapes (m, n >= 3 for kFold, B * K <= 65535) and contiguity.
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
