// The multigrid V-cycle's grid transfers for Hopper (sm_90a): kernel B6.
//
// It has no Pallas counterpart.  It replaces what XLA fuses out of the JAX
// functions opticalflow_tpu/solve/multigrid.py::restrict (:77), prolong
// (:71) and the residual of _descend (:359); the port's plain versions are
// opticalflow_tpu_torch/solve/multigrid.py::residual_restrict and
// prolong_add.  Two kernels, each with its own instances:
//   restrict  out = R r on the coarse grid (Mc, Nc) = (ceil(Mf/2), ceil(Nf/2)),
//             r = b - S x (a probed level), b - y (level 0, y = A x from the
//             fine matvec), S x or y (the coarse operators' probes)
//   prolong   out = x + P e on the fine grid, or P e (the probes)
// Fields are (B, [K,] 3, ., .), S broadcast over K.  The transfers are the
// bilinear pair of multigrid.py, rows (M) first, then columns (N):
//   R: t[k, j] = r[2k, j] + 0.5 (r[2k-1, j] + r[2k+1, j]), then the same
//      along columns; r is +0 beyond the fine grid
//   P: p[2k] = c[k], p[2k+1] = 0.5 (c[k] + c[k+1]) along rows, then along
//      columns; c is +0 beyond the coarse grid
//
// Exactness.  Every product and sum rounded alone in the plain version's
// order (csrc/mg_stencil.cuh for the stencil), built with -fmad=false
// besides: bit for bit the plain version, signed zeros included.
//
// What bounds it: bytes.  Residual-and-restrict on a probed level reads S
// (81 floats), x and b (3 each) a fine pixel and writes 3 a coarse pixel:
// ~351 bytes a fine pixel; at level 0 (b and y) ~27; prolong-and-add reads x
// and e and writes out, ~27 bytes a fine pixel.  Design: restriction in one
// launch, one block of kTileRows x kTileCols coarse points, one thread each.
// The block first computes the residual of its fine tile, with the one-pixel
// halo the restriction reads (2 kTileRows + 1 by 2 kTileCols + 1 points, +0
// beyond the grid), into shared memory, each fine point once a block (the
// halo, ~10% of it, twice); then each thread restricts its 3 x 3 fine
// neighbourhood from there.  Prolongation is one thread a fine pixel.  No
// atomics: deterministic.

#include <climits>

#include <cuda_runtime.h>

#include "mg_stencil.cuh"

namespace {

constexpr int kTileRows = 8, kTileCols = 32;  // coarse points a block
constexpr int kThreads = kTileRows * kTileCols;
constexpr int kFineRows = 2 * kTileRows + 1, kFineCols = 2 * kTileCols + 1;
constexpr int kProlongThreads = 256;
enum Mode { kRestrict = 0, kHasS = 1, kHasB = 2, kProlong = 4, kHasX = 1 };

__device__ __forceinline__ float half_sum(float a, float b) {
  return __fmul_rn(0.5f, __fadd_rn(a, b));
}

template <bool kStencil, bool kMinusB>
__global__ void __launch_bounds__(kThreads)
    restrict_kernel(const float* __restrict__ S, const float* __restrict__ x,
                    const float* __restrict__ b, const float* __restrict__ y,
                    float* __restrict__ out, int K, int Mf, int Nf, int Mc, int Nc, int tiles_x,
                    int tiles) {
  __shared__ float r[3][kFineRows][kFineCols];
  const long long field_index = blockIdx.x / tiles;  // (pair, probe)
  const int tile = static_cast<int>(blockIdx.x % tiles);
  const int cy0 = (tile / tiles_x) * kTileRows, cx0 = (tile % tiles_x) * kTileCols;
  const size_t fplane = static_cast<size_t>(Mf) * Nf;
  const size_t field = static_cast<size_t>(field_index) * 3 * fplane;
  const float* Sp = kStencil ? S + static_cast<size_t>(field_index / K) * 81 * fplane : nullptr;

  for (int p = threadIdx.x; p < kFineRows * kFineCols; p += kThreads) {
    const int li = p / kFineCols, lj = p % kFineCols;
    const int i = 2 * cy0 - 1 + li, j = 2 * cx0 - 1 + lj;
    float v[3] = {0.0f, 0.0f, 0.0f};
    if (i >= 0 && i < Mf && j >= 0 && j < Nf) {
      const size_t pix = static_cast<size_t>(i) * Nf + j;
      float a[3];
      if (kStencil) {
        float nb[27];
        mg::neighbourhood(x + field, Mf, Nf, i, j, nb);
        mg::apply_stencil(Sp + pix, fplane, nb, a);
      } else {
#pragma unroll
        for (int o = 0; o < 3; ++o) a[o] = __ldg(y + field + o * fplane + pix);
      }
#pragma unroll
      for (int o = 0; o < 3; ++o)
        v[o] = kMinusB ? __fsub_rn(__ldg(b + field + o * fplane + pix), a[o]) : a[o];
    }
#pragma unroll
    for (int o = 0; o < 3; ++o) r[o][li][lj] = v[o];
  }
  __syncthreads();

  const int ly = threadIdx.x / kTileCols, lx = threadIdx.x % kTileCols;
  const int ic = cy0 + ly, jc = cx0 + lx;
  if (ic >= Mc || jc >= Nc) return;
  const size_t cplane = static_cast<size_t>(Mc) * Nc;
  // fine (2 ic + d, 2 jc + e) is shared (2 ly + 1 + d, 2 lx + 1 + e)
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    float t[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int col = 2 * lx + c;
      t[c] = __fadd_rn(r[o][2 * ly + 1][col], half_sum(r[o][2 * ly][col], r[o][2 * ly + 2][col]));
    }
    out[static_cast<size_t>(field_index) * 3 * cplane + o * cplane +
        static_cast<size_t>(ic) * Nc + jc] = __fadd_rn(t[1], half_sum(t[0], t[2]));
  }
}

// c[k, l] of one coarse plane, +0 beyond the grid
__device__ __forceinline__ float coarse_at(const float* __restrict__ c, int Mc, int Nc, int k,
                                           int l) {
  return (k < Mc && l < Nc) ? __ldg(c + static_cast<size_t>(k) * Nc + l) : 0.0f;
}

// the row pass at fine row i, coarse column l: c[i/2, l], or the mean of the
// two coarse rows around an odd i
__device__ __forceinline__ float prolong_row(const float* __restrict__ c, int Mc, int Nc, int i,
                                             int l) {
  const int k = i >> 1;
  return (i & 1) ? half_sum(coarse_at(c, Mc, Nc, k, l), coarse_at(c, Mc, Nc, k + 1, l))
                 : coarse_at(c, Mc, Nc, k, l);
}

template <bool kAdd>
__global__ void __launch_bounds__(kProlongThreads)
    prolong_kernel(const float* __restrict__ x, const float* __restrict__ e,
                   float* __restrict__ out, long long total, int Mf, int Nf, int Mc, int Nc) {
  const long long idx = static_cast<long long>(blockIdx.x) * kProlongThreads + threadIdx.x;
  if (idx >= total) return;
  const long long fplane = static_cast<long long>(Mf) * Nf;
  const long long pix = idx % fplane;
  const long long field_index = idx / fplane;
  const int i = static_cast<int>(pix / Nf), j = static_cast<int>(pix % Nf);
  const size_t cplane = static_cast<size_t>(Mc) * Nc;
  const size_t at = static_cast<size_t>(field_index) * 3 * fplane + pix;
  const int l = j >> 1;
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    const float* c = e + (static_cast<size_t>(field_index) * 3 + o) * cplane;
    const float p = prolong_row(c, Mc, Nc, i, l);
    const float v = (j & 1) ? half_sum(p, prolong_row(c, Mc, Nc, i, l + 1)) : p;
    out[at + o * fplane] = kAdd ? __fadd_rn(__ldg(x + at + o * fplane), v) : v;
  }
}

template <bool kStencil, bool kMinusB>
int launch_restrict(const float* S, const float* x, const float* b, const float* y, float* out,
                    int B, int K, int Mf, int Nf, int Mc, int Nc, cudaStream_t stream) {
  const int tiles_x = (Nc + kTileCols - 1) / kTileCols;
  const long long tiles = static_cast<long long>(tiles_x) * ((Mc + kTileRows - 1) / kTileRows);
  const long long blocks = tiles * B * K;
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  restrict_kernel<kStencil, kMinusB><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      S, x, b, y, out, K, Mf, Nf, Mc, Nc, tiles_x, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

template <bool kAdd>
int launch_prolong(const float* x, const float* e, float* out, int B, int K, int Mf, int Nf,
                   int Mc, int Nc, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * K * Mf * Nf;
  if (total == 0) return 0;
  const long long blocks = (total + kProlongThreads - 1) / kProlongThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  prolong_kernel<kAdd><<<static_cast<unsigned>(blocks), kProlongThreads, 0, stream>>>(
      x, e, out, total, Mf, Nf, Mc, Nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches kernel B6 on `stream` and returns the CUDA error of the launch;
// the caller checks shapes ((Mc, Nc) the coarse grid of (Mf, Nf)), types and
// contiguity.  mode: 0-3 restriction (bit 0: r from S x, else from y; bit 1:
// b minus it), 4-5 prolongation (bit 0: x plus it).
extern "C" int mg_transfer(const float* S, const float* x, const float* b, const float* y,
                           const float* e, float* out, int B, int K, int Mf, int Nf, int Mc,
                           int Nc, int mode, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kRestrict: return launch_restrict<false, false>(S, x, b, y, out, B, K, Mf, Nf, Mc, Nc, s);
    case kRestrict | kHasS:
      return launch_restrict<true, false>(S, x, b, y, out, B, K, Mf, Nf, Mc, Nc, s);
    case kRestrict | kHasB:
      return launch_restrict<false, true>(S, x, b, y, out, B, K, Mf, Nf, Mc, Nc, s);
    case kRestrict | kHasS | kHasB:
      return launch_restrict<true, true>(S, x, b, y, out, B, K, Mf, Nf, Mc, Nc, s);
    case kProlong: return launch_prolong<false>(x, e, out, B, K, Mf, Nf, Mc, Nc, s);
    case kProlong | kHasX: return launch_prolong<true>(x, e, out, B, K, Mf, Nf, Mc, Nc, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
