// Plain fused Euler-Lagrange stencil for Hopper (sm_90a).
//
// Replaces the TPU kernel opticalflow_tpu/ops/pallas_kernels.py::
// _el_matvec_plain_kernel (v5), the core of the hybrid matvec: the same
// coefficient rebuild and 9-point / 3-field stencil as el_matvec.cu, with
// field reads at interior (i + a - 1, j + b - 1) that are zero outside
// [0, m) x [0, n): no mirror folds, no corner doubling.  Unlike the TPU
// kernel, whose boundary ring is undefined, every output pixel, the ring
// included, is the plain stencil of the zero-extended field (its plain
// version: elop.interior_apply of the zero-padded field), so kernel and
// plain version agree everywhere.  The caller overwrites the ring with the
// mirror semantics (ops/elop.ring_apply).
//
// The kernel, its layout and what bounds it are in el_stencil.cuh; here the
// halo tile is staged with zeros outside the interior.

#include "el_stencil.cuh"

extern "C" int el_matvec_plain_core(const float* I, const float* scalars, const float* u,
                                    float* out, int B, int K, int m, int n, int compat,
                                    void* stream) {
  return el_stencil::launch<el_stencil::kZero>(I, scalars, u, out, B, K, m, n, compat, stream);
}
