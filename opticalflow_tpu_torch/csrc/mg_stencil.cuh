// Per-pixel arithmetic of the multigrid kernels B5 (mg_smooth.cu) and B6
// (mg_transfer.cu): the 9-point, 3-field stencil of a probed level and the
// 3x3 diagonal-block inverse, each product and sum rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn, which are never contracted into fused
// multiply-adds; the sources are also built with -fmad=false), in the order
// of the plain versions in opticalflow_tpu_torch/solve/multigrid.py, so that
// the kernels equal them bit for bit.
//
// Layout of a level (B pairs of an M x N grid, planes M * N floats apart):
//   S     (B, 3, 3, 3, 3, M, N)  plane o * 27 + q * 9 + di * 3 + dj
//   binv  (B, 3, 3, M, N)        plane o * 3 + q
//   fields (B, [K,] 3, M, N)     S and binv broadcast over K

#pragma once

#include <cstddef>

#include <cuda_runtime.h>

namespace mg {

// nb[q * 9 + di * 3 + dj] = u[q, i + di - 1, j + dj - 1] of one (3, M, N)
// field, +0 outside the grid (the plain version's zero padding).
__device__ __forceinline__ void neighbourhood(const float* __restrict__ u, int M, int N, int i,
                                              int j, float nb[27]) {
  const size_t plane = static_cast<size_t>(M) * N;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
#pragma unroll
    for (int di = 0; di < 3; ++di) {
      const int ii = i + di - 1;
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        const int jj = j + dj - 1;
        nb[q * 9 + di * 3 + dj] =
            (ii >= 0 && ii < M && jj >= 0 && jj < N)
                ? __ldg(u + q * plane + static_cast<size_t>(ii) * N + jj)
                : 0.0f;
      }
    }
  }
}

// y[o] = S[o, 0] nb[0] + S[o, 1] nb[1] + ... + S[o, 26] nb[26], summed left
// to right (q, then di, then dj: multigrid.stencil_matvec's order); S points
// at the pixel in the level's first plane.
__device__ __forceinline__ void apply_stencil(const float* __restrict__ S, size_t plane,
                                              const float nb[27], float y[3]) {
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    const float* So = S + static_cast<size_t>(o) * 27 * plane;
    float acc = __fmul_rn(__ldg(So), nb[0]);
#pragma unroll
    for (int t = 1; t < 27; ++t) acc = __fadd_rn(acc, __fmul_rn(__ldg(So + t * plane), nb[t]));
    y[o] = acc;
  }
}

// (binv[o, 0] r[0] + binv[o, 1] r[1]) + binv[o, 2] r[2]: row o of the block
// inverse applied (multigrid.apply_blocks); row points at plane o * 3.
__device__ __forceinline__ float block_row(const float* __restrict__ row, size_t plane,
                                           const float r[3]) {
  const float s = __fadd_rn(__fmul_rn(__ldg(row), r[0]), __fmul_rn(__ldg(row + plane), r[1]));
  return __fadd_rn(s, __fmul_rn(__ldg(row + 2 * plane), r[2]));
}

}  // namespace mg
