// Fused reduced Euler-Lagrange matvec for Hopper (sm_90a).
//
// Replaces the TPU kernel opticalflow_tpu/ops/pallas_kernels.py::
// _el_matvec_interior_kernel (v4): y = A_reduced u for a batch of frame
// pairs, with the 11 coefficient planes rebuilt from the previous frame I and
// the pair's (alpha_s, alpha_r) on every application, and the mirror rows of
// the reduced system folded into the reads.  Same semantics as
// ops/elop.el_matvec_reduced on precomputed planes.
//
// The kernel, its layout and what bounds it are in el_stencil.cuh; here the
// mirror fold is applied while staging the halo tile (row -1 reads row 1,
// row m reads row m-2, columns likewise, doubled where both indices were
// mirrored).

#include "el_stencil.cuh"

extern "C" int el_matvec_reduced_fused(const float* I, const float* scalars,
                                       const float* u, float* out, int B, int K,
                                       int m, int n, int compat, void* stream) {
  return el_stencil::launch<el_stencil::kFold>(I, scalars, u, out, B, K, m, n, compat, stream);
}
