// Euler-Lagrange stencil on the tiles of a mesh for Hopper (sm_90a).
//
// Replaces the TPU kernel opticalflow_tpu/ops/pallas_kernels.py::
// _el_matvec_kernel (v2), the kernel inside the spatially sharded matvec
// (parallel/pallas_spmd.py::_local_kernel_matvec): y = the EL stencil on
// each (m, n) interior tile, with coefficients rebuilt from the tile's
// block of the true frame with its one-pixel halo, and the field extended
// by the tile's seams (the neighbour tiles' values) and, at global edges,
// by the reduced system's mirror values.  Same semantics as
// elop.interior_apply(compute_coefficients(I_ext), u_ext).
//
// The TPU kernel takes each tile's field as a pre-extended (m+2, n+2)
// block, which the JAX package builds by ppermute; this one reads the
// interior and its seams where they already lie, in one of two forms:
//   windows (no halo lines): u is the whole interior field (B, K, 3, tx m,
//     ty n) and a launch covers every tile of every pair; a seam is a read
//     of the neighbour tile's pixels, a global edge a fold (the tiling of
//     one device);
//   lines: u is one tile (N, K, 3, m, n), any view with a common plane and
//     row pitch, and its halo the four lines the seam exchange received
//     (rows above and below with the corners, (N, K, 3, n + 2); columns
//     left and right, (N, K, 3, m)), each any view with a common plane
//     pitch (and, left and right, an element pitch: a column of a field);
//     tx = ty = 1 (a tile on its own device).
// out is written in place through its pitches: the whole (B, K, 3, tx m,
// ty n) result, or the tile's window of it.  Unlike the TPU kernel there is
// no container: no row offset 8, no lane padding, no masked output layout.
//
// What bounds it (memory: I, the field planes and the halo lines read
// once, the output planes written once) and the design against it are in
// el_tiles.cuh: the kWindows and kLines instantiations.

#include "el_tiles.cuh"

extern "C" int el_matvec_tiled(const float* I, const float* scalars, const float* u,
                               float* out, const float* top, const float* bottom,
                               const float* left, const float* right, int N, int K, int tx,
                               int ty, int m, int n, long long u_plane, int u_row,
                               long long out_plane, int out_row, long long top_plane,
                               long long bottom_plane, long long left_plane,
                               long long right_plane, int left_step, int right_step,
                               int compat, void* stream) {
  el_tiles::Args a{};
  a.I = I;
  a.scalars = scalars;
  a.u = u;
  a.out = out;
  a.top = top;
  a.bottom = bottom;
  a.left = left;
  a.right = right;
  a.K = K;
  a.m = m;
  a.n = n;
  a.tx = tx;
  a.ty = ty;
  a.u_plane = u_plane;
  a.out_plane = out_plane;
  a.u_row = u_row;
  a.out_row = out_row;
  a.top_plane = top_plane;
  a.bottom_plane = bottom_plane;
  a.left_plane = left_plane;
  a.right_plane = right_plane;
  a.left_step = left_step;
  a.right_step = right_step;
  a.compat = compat;
  if (top == nullptr) return el_tiles::launch<el_tiles::kWindows>(a, N, stream);
  if (tx != 1 || ty != 1) return static_cast<int>(cudaErrorInvalidValue);
  return el_tiles::launch<el_tiles::kLines>(a, N, stream);
}
