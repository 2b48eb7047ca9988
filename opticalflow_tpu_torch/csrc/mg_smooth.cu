// The multigrid V-cycle's smoothing sweeps and stencil apply for Hopper
// (sm_90a): kernel B5.
//
// It has no Pallas counterpart.  It replaces what XLA fuses out of the JAX
// functions opticalflow_tpu/solve/multigrid.py::jacobi_sweep (:247),
// apply_blocks (:229) and stencil_matvec (:92); the port's plain versions
// are opticalflow_tpu_torch/solve/multigrid.py::smooth_level, smooth_fine
// and stencil_matvec, each tens of torch ops a call.  Four modes, each its
// own instance of one kernel template (ops/cuda_kernels.py names them):
//   zero guess  out = damp * Binv b                  (first sweep, any level)
//   fine        out = x + damp * Binv (b - y)        (level 0, y = A x from the
//                                                     fine matvec, B1-B3)
//   sweep       out = x + damp * Binv (b - S x)      (a probed level)
//   apply       out = S u, u (B, K, 3, M, N), S broadcast over K (a probed
//               level's operator: the coarse probes' K = 27, the coarsest
//               operator's K = 3 M N, the Gauss-Seidel smoother)
// A Jacobi sweep reads x around each pixel, so out is never x.
//
// Exactness.  Every product and sum is rounded on its own in the plain
// version's order (csrc/mg_stencil.cuh): the stencil's 27 terms left to
// right, Binv's row as (t0 + t1) + t2, then damp times it, then x plus that.
// damp arrives as the float32 the plain version's float32 product rounds it
// to.  Built with -fmad=false besides (ops/cuda_kernels.py::ENTRY_POINTS);
// no fast math, no flush to zero: bit for bit the plain version, signed zeros
// included.
//
// What bounds it: bytes.  A sweep on a probed level reads S (81 floats a
// pixel), Binv (9), x and b (3 each) and writes 3: 396 bytes a pixel for ~180
// float operations, far below the card's ~20 operations a byte.  The fine
// mode moves 84 bytes a pixel (Binv, x, b, y, out), the zero guess 60, the
// apply 324 + 24 K.  The design is the simple one: one thread a pixel (and
// probe), S and Binv read as coalesced planes, each x value read by its 9
// neighbours through L1; no shared memory and no atomics, so results are
// deterministic.  The V-cycle's call count, not this kernel, is what the
// solve's wall time sees (PERF.md).

#include <climits>

#include <cuda_runtime.h>

#include "mg_stencil.cuh"

namespace {

constexpr int kThreads = 256;
enum Mode { kZeroGuess = 0, kFine = 1, kSweep = 2, kApply = 3 };

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    mg_smooth_kernel(const float* __restrict__ S, const float* __restrict__ binv,
                     const float* __restrict__ x, const float* __restrict__ b,
                     const float* __restrict__ y, float* __restrict__ out, long long total,
                     int K, int M, int N, float damp) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const long long plane = static_cast<long long>(M) * N;
  const long long pix = idx % plane;
  const long long field_index = idx / plane;  // (pair, probe)
  const long long pair = field_index / K;
  const int i = static_cast<int>(pix / N), j = static_cast<int>(pix % N);
  const size_t field = static_cast<size_t>(field_index) * 3 * plane;
  const size_t at = field + pix;

  if (kMode == kApply) {
    float nb[27], v[3];
    mg::neighbourhood(x + field, M, N, i, j, nb);
    mg::apply_stencil(S + static_cast<size_t>(pair) * 81 * plane + pix, plane, nb, v);
#pragma unroll
    for (int o = 0; o < 3; ++o) out[at + o * plane] = v[o];
    return;
  }

  float r[3];  // K == 1 below: field_index is the pair
  if (kMode == kSweep) {
    float nb[27], v[3];
    mg::neighbourhood(x + field, M, N, i, j, nb);
    mg::apply_stencil(S + static_cast<size_t>(pair) * 81 * plane + pix, plane, nb, v);
#pragma unroll
    for (int o = 0; o < 3; ++o) r[o] = __fsub_rn(__ldg(b + at + o * plane), v[o]);
  } else {
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      const float bo = __ldg(b + at + o * plane);
      r[o] = kMode == kFine ? __fsub_rn(bo, __ldg(y + at + o * plane)) : bo;
    }
  }
  const float* Bi = binv + static_cast<size_t>(pair) * 9 * plane + pix;
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    const float w = __fmul_rn(damp, mg::block_row(Bi + o * 3 * plane, plane, r));
    out[at + o * plane] = kMode == kZeroGuess ? w : __fadd_rn(__ldg(x + at + o * plane), w);
  }
}

template <int kMode>
int launch(const float* S, const float* binv, const float* x, const float* b, const float* y,
           float* out, int B, int K, int M, int N, float damp, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * K * M * N;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  mg_smooth_kernel<kMode><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      S, binv, x, b, y, out, total, K, M, N, damp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches kernel B5 in `mode` (0 zero guess, 1 fine, 2 sweep, 3 apply) on
// `stream` and returns the CUDA error of the launch; the caller checks
// shapes, types and contiguity.  K > 1 in apply mode only; each mode reads
// only its own operands (zero guess: binv, b; fine: binv, x, b, y; sweep: S,
// binv, x, b; apply: S and u passed as x).
extern "C" int mg_smooth(const float* S, const float* binv, const float* x, const float* b,
                         const float* y, float* out, int B, int K, int M, int N, float damp,
                         int mode, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kZeroGuess: return launch<kZeroGuess>(S, binv, x, b, y, out, B, 1, M, N, damp, s);
    case kFine: return launch<kFine>(S, binv, x, b, y, out, B, 1, M, N, damp, s);
    case kSweep: return launch<kSweep>(S, binv, x, b, y, out, B, 1, M, N, damp, s);
    case kApply: return launch<kApply>(S, binv, x, b, y, out, B, K, M, N, damp, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
