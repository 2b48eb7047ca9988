// Euler-Lagrange stencil on pre-extended field blocks for Hopper (sm_90a).
//
// Replaces the TPU kernel opticalflow_tpu/ops/pallas_kernels.py::
// _el_matvec_kernel (v2), the kernel inside the spatially sharded matvec
// (parallel/pallas_spmd.py::_local_kernel_matvec): y = the EL stencil with
// coefficients rebuilt from a block of the true frame with its one-pixel
// halo, applied to a field block that is already extended (its halo holds
// the neighbour tiles' values at tile seams and the reduced system's
// mirror values at global edges).  Same semantics as
// elop.interior_apply(compute_coefficients(I_ext), u_ext).
//
// Unlike the TPU kernel there is no container: no row offset 8, no lane
// padding, no masked output layout.  Operands are I_ext (N, m+2, n+2),
// u_ext (N, K, 3, m+2, n+2) and out (N, K, 3, m, n), where N counts
// pairs x tiles, so one launch covers every tile of every pair.
//
// What bounds it: memory.  Per application it reads I_ext and three
// extended field planes and writes three interior planes: 7 planes, about
// 28 bytes a pixel.  The kernel, its tiling and its halo tile are in
// el_stencil.cuh; here the halo tile is staged straight from the extended
// block (every input element read from device memory once), with no folds
// and no selects beyond the ragged-edge bound.

#include "el_stencil.cuh"

extern "C" int el_matvec_extended(const float* I, const float* scalars, const float* u,
                                  float* out, int B, int K, int m, int n, int compat,
                                  void* stream) {
  return el_stencil::launch<el_stencil::kExtended>(I, scalars, u, out, B, K, m, n, compat,
                                                   stream);
}
