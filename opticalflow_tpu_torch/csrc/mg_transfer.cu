// The multigrid V-cycle's grid transfers for Hopper (sm_90a): kernel B6.
//
// It has no Pallas counterpart.  It replaces what XLA fuses out of the JAX
// functions opticalflow_tpu/solve/multigrid.py::restrict (:77), prolong
// (:71), the residual of _descend (:359) and, at a probed level, the
// jacobi_sweep (:247) on either side of them; the port's plain versions are
// opticalflow_tpu_torch/solve/multigrid.py::residual_restrict, prolong_add,
// smooth_restrict and prolong_smooth.  Four kernels (the C modes below):
//   restrict_kernel   out = R r on the coarse grid (Mc, Nc) = (ceil(Mf/2),
//                     ceil(Nf/2)), r = y, S x, b - y or b - S x
//   sweep_restrict_kernel  the last pre-sweep of a probed level fused with
//                     its restriction: x1 = x + damp Binv (b - S x) into
//                     out2, out = R (b - S x1)
//   prolong_kernel    out = P e, or x + P e, on the fine grid
//   prolong_sweep_kernel  out = xp + damp Binv (b - S xp), xp = x + P e:
//                     the prolong-add and the first post-sweep of a probed
//                     level; xp is never written
// Fields are (B, [K,] 3, ., .), S (B, 81, Mf, Nf) broadcast over K, Binv (B,
// 9, Mf, Nf).  The transfers are the bilinear pair of multigrid.py, rows (M)
// first, then columns (N):
//   R: t[k, j] = r[2k, j] + 0.5 (r[2k-1, j] + r[2k+1, j]), then the same
//      along columns; r is +0 beyond the fine grid
//   P: p[2k] = c[k], p[2k+1] = 0.5 (c[k] + c[k+1]) along rows, then along
//      columns; c is +0 beyond the coarse grid
//
// Exactness.  Every product and sum rounded alone in the plain version's
// order (csrc/mg_stencil.cuh for the stencil and the block row), built with
// -fmad=false besides: bit for bit the plain version, signed zeros included.
// A fused stage recomputes x1 (or xp) on its tile's halo with the same
// operations in the same order as the tile that owns those pixels.
//
// What bounds it: bytes.  A fine pixel of a probed level moves 351 bytes in
// R (b - S x) (S's 81 floats, x, b, and a quarter of 3 coarse floats), 399
// in the fused sweep-residual-restrict (Binv and x1 besides), where the
// sweep and the residual-and-restrict apart move 396 + 351; 399 in the
// fused prolong-add-sweep; level 0's R (b - y) 27, x + P e 27.  Design:
// - Tiles whose size the launcher picks per call (but the fused
//   restriction's): the larger where it gives every SM two blocks, else the
//   smaller, so that one pair (B = K = 1) at the command line's and the
//   1024x1024 pair's levels fills the card.  A block's (tile, probe) is
//   blockIdx.x = tile K + probe (the probes of one tile run together and
//   share S through L2), its pair blockIdx.z; all index math within a field
//   is 32-bit.
// - The standalone restriction stages x with the stencil's halo by 4-byte
//   cp.async (zero-filled beyond the grid), or y and b through registers
//   (every load of a thread issued before the first is used); S and b
//   stream from device memory as coalesced rows.  The residual tile is
//   stored with its even and odd columns apart, so the restriction reads it
//   without bank conflicts; each thread restricts two coarse points of one
//   column, which share a fine row.
// - The fused sweep-residual-restrict takes tiles of 4 x 16 coarse points
//   and one thread a pixel of the region its x1 covers (11 x 35): the
//   thread loads its pixel's S, Binv and b into registers while x stages,
//   makes x1, and then the residual of the same pixel from the S and b it
//   still holds; so S crosses the chip once, for both steps (the halo's S
//   from L2 where a neighbouring tile read it).
// - The prolongation stages its coarse tile once a block (its x loads
//   issued first); each thread makes a 2 x 2 quad of fine pixels of all
//   three fields and stores (and reads x) as float2 where the row's
//   address allows.  The prolong-add-sweep stages x and e with their halo,
//   forms xp in shared memory and sweeps from there.
// No atomics: deterministic.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "el_tiles.cuh"
#include "mg_stencil.cuh"

namespace {

using el_tiles::cp_async4;
using el_tiles::cp_async_commit;
using el_tiles::cp_async_wait;

constexpr int kThreads = 256;  // restriction and prolong-add-sweep blocks
constexpr int kGridZ = 65535;
enum Mode {
  kRestrictY = 0, kRestrictSx = 1, kRestrictBmY = 2, kRestrictBmSx = 3,  // bit 0 S, bit 1 b
  kProlong = 4, kProlongAdd = 5, kSweepRestrict = 6, kProlongSweep = 7
};

struct Args {
  const float* S;
  const float* binv;
  const float* x;
  const float* b;
  const float* y;
  const float* e;
  float* out;
  float* out2;
  int K, Mf, Nf, Mc, Nc;
  float damp;
  int tiles_x;  // set by the launcher: tiles a row
};

__device__ __forceinline__ float half_sum(float a, float b) {
  return __fmul_rn(0.5f, __fadd_rn(a, b));
}

// slot of column c in a row stored by column parity: even columns at [0,
// kHalf), odd at [kHalf, 2 kHalf); kHalf is 16 mod 32, so lanes 2m and 2m + 1
// reach different banks
template <int kHalf>
__device__ __forceinline__ int parity_slot(int c) {
  return (c & 1) * kHalf + (c >> 1);
}

// cp.async rows [i0, i0 + H) x columns [j0, j0 + W) of the three M x N
// planes of src into dst (H x W planes, dst_plane floats apart), +0 beyond
// the grid
template <int H, int W>
__device__ __forceinline__ void stage(float* dst, int dst_plane, const float* src, int i0, int j0,
                                      int M, int N) {
  const int plane = M * N;
  for (int p = threadIdx.x; p < H * W; p += blockDim.x) {
    const int li = p / W, lj = p - li * W;
    const int i = i0 + li, j = j0 + lj;
    const bool ok = i >= 0 && i < M && j >= 0 && j < N;
    const float* s = ok ? src + i * N + j : src;
#pragma unroll
    for (int o = 0; o < 3; ++o) cp_async4(dst + o * dst_plane + p, s + o * plane, ok);
  }
}

// nb[q * 9 + di * 3 + dj] = t[q, li + di, lj + dj] of a staged 3-plane tile
// of width W, planes `plane` floats apart
template <int W>
__device__ __forceinline__ void gather(const float* t, int plane, int li, int lj, float nb[27]) {
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
        nb[q * 9 + di * 3 + dj] = t[q * plane + (li + di) * W + lj + dj];
}

// R of a residual tile of TR x TC coarse points stored by column parity
// (rows of 2 kHalf floats, planes `plane` apart) into out (3 Mc x Nc planes):
// coarse (cy0 + ly, cx0 + lx) and (cy0 + ly + 1, ...) a thread, ly even;
// coarse row ly reads tile rows 2 ly ... 2 ly + 2, coarse column lx the
// tile's columns 2 lx (even slot lx), 2 lx + 1 (odd slot lx) and 2 lx + 2
// (even slot lx + 1)
template <int TR, int TC, int kHalf>
__device__ __forceinline__ void restrict_tile(const float* res, int plane, float* out, int cy0,
                                              int cx0, int Mc, int Nc) {
  const int cplane = Mc * Nc;
  for (int q = threadIdx.x; q < TR / 2 * TC; q += blockDim.x) {
    const int ly = q / TC * 2, lx = q - q / TC * TC;
    const int ic = cy0 + ly, jc = cx0 + lx;
    if (ic >= Mc || jc >= Nc) continue;
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      const float* r = res + o * plane + 2 * ly * 2 * kHalf + lx;
      float col[5][3];
#pragma unroll
      for (int row = 0; row < 5; ++row) {
        const float* rr = r + row * 2 * kHalf;
        col[row][0] = rr[0];
        col[row][1] = rr[kHalf];
        col[row][2] = rr[1];
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (k == 1 && ic + 1 >= Mc) break;
        float t[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          t[c] = __fadd_rn(col[2 * k + 1][c], half_sum(col[2 * k][c], col[2 * k + 2][c]));
        out[o * cplane + (ic + k) * Nc + jc] = __fadd_rn(t[1], half_sum(t[0], t[2]));
      }
    }
  }
}

// Tiles of TR x TC coarse points.  The residual region is fine rows 2 cy0 -
// 1 ... 2 cy0 + 2 TR - 1 and the like columns; with the stencil, x is
// staged one pixel beyond it on every side.
template <int kMode, int TR, int TC>
struct RTile {
  static constexpr bool kStencil = kMode & 1;
  static constexpr bool kMinusB = kMode & 2;
  static constexpr int kRH = 2 * TR + 1, kRW = 2 * TC + 1;
  static constexpr int kHalf = (TC + 16) / 32 * 32 + 16;  // >= TC + 1
  static constexpr int kRPlane = kRH * 2 * kHalf;
  static constexpr int kSH = kRH + 2, kSW = kRW + 2;  // staged x
  static constexpr int kSPlane = kStencil ? kSH * kSW : 0;
  static constexpr int kPasses = (kRH * kRW + kThreads - 1) / kThreads;
};

template <int kMode, int TR, int TC>
__global__ void __launch_bounds__(kThreads, 2) restrict_kernel(const Args a) {
  using T = RTile<kMode, TR, TC>;
  __shared__ __align__(16) float smem[3 * (T::kSPlane + T::kRPlane)];
  const int Mf = a.Mf, Nf = a.Nf, fplane = Mf * Nf;
  const int tile = blockIdx.x / a.K, probe = blockIdx.x - tile * a.K;
  const int ty = tile / a.tiles_x, tx = tile - ty * a.tiles_x;
  const int cy0 = ty * TR, cx0 = tx * TC;
  const int fy0 = 2 * cy0 - 1, fx0 = 2 * cx0 - 1;  // the residual region's origin
  const size_t field = static_cast<size_t>(blockIdx.z) * a.K + probe;
  const float* b = T::kMinusB ? a.b + field * 3 * fplane : nullptr;
  float* xs = smem;                        // staged x (with the stencil)
  float* res = smem + 3 * T::kSPlane;      // the residual, by column parity

  if constexpr (T::kStencil) {
    stage<T::kSH, T::kSW>(xs, T::kSPlane, a.x + field * 3 * fplane, fy0 - 1, fx0 - 1, Mf, Nf);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const float* S = a.S + static_cast<size_t>(blockIdx.z) * 81 * fplane;
    for (int p = threadIdx.x; p < T::kRH * T::kRW; p += kThreads) {
      const int li = p / T::kRW, lj = p - li * T::kRW;
      const int i = fy0 + li, j = fx0 + lj;
      float v[3] = {0.0f, 0.0f, 0.0f};
      if (i >= 0 && i < Mf && j >= 0 && j < Nf) {
        const int pix = i * Nf + j;
        float nb[27];
        gather<T::kSW>(xs, T::kSPlane, li, lj, nb);
        mg::apply_stencil(S + pix, fplane, nb, v);
        if constexpr (T::kMinusB) {
#pragma unroll
          for (int o = 0; o < 3; ++o) v[o] = __fsub_rn(__ldg(b + o * fplane + pix), v[o]);
        }
      }
      const int d = li * 2 * T::kHalf + parity_slot<T::kHalf>(lj);
#pragma unroll
      for (int o = 0; o < 3; ++o) res[o * T::kRPlane + d] = v[o];
    }
  } else {
    // y (and b): every load of the thread in flight before the first store
    const float* y = a.y + field * 3 * fplane;
    float v[T::kPasses][3], w[T::kPasses][3];
#pragma unroll
    for (int k = 0; k < T::kPasses; ++k) {
      const int p = threadIdx.x + k * kThreads;
      const int li = p / T::kRW, lj = p - li * T::kRW;
      const int i = fy0 + li, j = fx0 + lj;
      const bool ok = p < T::kRH * T::kRW && i >= 0 && i < Mf && j >= 0 && j < Nf;
      const int pix = ok ? i * Nf + j : 0;
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        v[k][o] = ok ? __ldg(y + o * fplane + pix) : 0.0f;
        if constexpr (T::kMinusB) w[k][o] = ok ? __ldg(b + o * fplane + pix) : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < T::kPasses; ++k) {
      const int p = threadIdx.x + k * kThreads;
      if (p >= T::kRH * T::kRW) break;
      const int li = p / T::kRW, lj = p - li * T::kRW;
      const int d = li * 2 * T::kHalf + parity_slot<T::kHalf>(lj);
#pragma unroll
      for (int o = 0; o < 3; ++o)
        res[o * T::kRPlane + d] = T::kMinusB ? __fsub_rn(w[k][o], v[k][o]) : v[k][o];
    }
  }
  __syncthreads();

  restrict_tile<TR, TC, T::kHalf>(res, T::kRPlane, a.out + field * 3 * a.Mc * a.Nc, cy0, cx0,
                                  a.Mc, a.Nc);
}

// The fused sweep-residual-restrict on tiles of TR x TC coarse points, one
// thread a pixel of the x1 region (fine rows 2 cy0 - 2 ... 2 cy0 + 2 TR, the
// like columns): each thread loads its pixel's S, Binv and b into
// registers while x (with a one-pixel halo) stages by cp.async, makes x1
// there, and, on the residual region within, the residual b - S x1 from
// the S and b it still holds; so S crosses the chip once, for both steps.
template <int TR, int TC>
struct SRTile {
  static constexpr int kXH = 2 * TR + 3, kXW = 2 * TC + 3, kXPlane = kXH * kXW;
  static constexpr int kThreads = kXPlane;
  static constexpr int kSW = kXW + 2, kSPlane = (kXH + 2) * kSW;  // staged x
  static constexpr int kHalf = (TC + 16) / 32 * 32 + 16;
  static constexpr int kRPlane = (2 * TR + 1) * 2 * kHalf;
};

template <int TR, int TC>
__global__ void __launch_bounds__(SRTile<TR, TC>::kThreads, 1)
    sweep_restrict_kernel(const Args a) {
  using T = SRTile<TR, TC>;
  __shared__ __align__(16) float xs[3 * T::kSPlane];
  __shared__ __align__(16) float x1s[3 * T::kXPlane];
  __shared__ __align__(16) float res[3 * T::kRPlane];
  const int Mf = a.Mf, Nf = a.Nf, fplane = Mf * Nf;
  const int ty = blockIdx.x / a.tiles_x, tx = blockIdx.x - ty * a.tiles_x;
  const int cy0 = ty * TR, cx0 = tx * TC;
  const int fy0 = 2 * cy0 - 2, fx0 = 2 * cx0 - 2;  // the x1 region's origin
  const size_t pair = blockIdx.z;  // K == 1
  stage<T::kXH + 2, T::kSW>(xs, T::kSPlane, a.x + pair * 3 * fplane, fy0 - 1, fx0 - 1, Mf, Nf);
  cp_async_commit();
  const int p = threadIdx.x, li = p / T::kXW, lj = p - li * T::kXW;
  const int i = fy0 + li, j = fx0 + lj;
  const bool on = i >= 0 && i < Mf && j >= 0 && j < Nf;
  const int pix = on ? i * Nf + j : 0;
  const float* S = a.S + pair * 81 * fplane + pix;
  const float* Bi = a.binv + pair * 9 * fplane + pix;
  const float* b = a.b + pair * 3 * fplane + pix;
  float Sr[81], Br[9], br[3];
#pragma unroll
  for (int k = 0; k < 81; ++k) Sr[k] = on ? __ldg(S + k * fplane) : 0.0f;
#pragma unroll
  for (int k = 0; k < 9; ++k) Br[k] = on ? __ldg(Bi + k * fplane) : 0.0f;
#pragma unroll
  for (int o = 0; o < 3; ++o) br[o] = on ? __ldg(b + o * fplane) : 0.0f;
  cp_async_wait<0>();
  __syncthreads();

  // x1 = x + damp Binv (b - S x), the sweep of B5
  float v[3] = {0.0f, 0.0f, 0.0f};
  if (on) {
    float nb[27], r[3];
    gather<T::kSW>(xs, T::kSPlane, li, lj, nb);
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      float acc = __fmul_rn(Sr[o * 27], nb[0]);
#pragma unroll
      for (int k = 1; k < 27; ++k) acc = __fadd_rn(acc, __fmul_rn(Sr[o * 27 + k], nb[k]));
      r[o] = __fsub_rn(br[o], acc);
    }
    const bool owned = li >= 2 && li < 2 * TR + 2 && lj >= 2 && lj < 2 * TC + 2;
    float* x1 = a.out2 + pair * 3 * fplane + pix;
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      const float s = __fadd_rn(__fmul_rn(Br[o * 3], r[0]), __fmul_rn(Br[o * 3 + 1], r[1]));
      const float w = __fmul_rn(a.damp, __fadd_rn(s, __fmul_rn(Br[o * 3 + 2], r[2])));
      v[o] = __fadd_rn(nb[o * 9 + 4], w);
      if (owned) x1[o * fplane] = v[o];
    }
  }
#pragma unroll
  for (int o = 0; o < 3; ++o) x1s[o * T::kXPlane + p] = v[o];
  __syncthreads();

  // the residual b - S x1 on the residual region, one pixel in from the x1
  // region's edge
  if (li >= 1 && li < T::kXH - 1 && lj >= 1 && lj < T::kXW - 1) {
    float rv[3] = {0.0f, 0.0f, 0.0f};
    if (on) {
      float nb[27];
      gather<T::kXW>(x1s, T::kXPlane, li - 1, lj - 1, nb);
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        float acc = __fmul_rn(Sr[o * 27], nb[0]);
#pragma unroll
        for (int k = 1; k < 27; ++k) acc = __fadd_rn(acc, __fmul_rn(Sr[o * 27 + k], nb[k]));
        rv[o] = __fsub_rn(br[o], acc);
      }
    }
    const int d = (li - 1) * 2 * T::kHalf + parity_slot<T::kHalf>(lj - 1);
#pragma unroll
    for (int o = 0; o < 3; ++o) res[o * T::kRPlane + d] = rv[o];
  }
  __syncthreads();
  restrict_tile<TR, TC, T::kHalf>(res, T::kRPlane, a.out + pair * 3 * a.Mc * a.Nc, cy0, cx0,
                                  a.Mc, a.Nc);
}

// the row pass of P at fine row parity `odd` from the staged coarse rows
// c0 (row k) and c1 (row k + 1), coarse column l of the stage
__device__ __forceinline__ float prolong_row(const float* c0, const float* c1, bool odd, int l) {
  return odd ? half_sum(c0[l], c1[l]) : c0[l];
}

// QR x QC coarse points a block, one thread each: its 2 x 2 fine quad.  A
// row's pair of columns is read and written as one float2 where both
// pointers are 8-byte aligned.
template <bool kAdd, int QR, int QC>
__global__ void __launch_bounds__(QR * QC) prolong_kernel(const Args a) {
  constexpr int kW = QC + 1, kPlane = (QR + 1) * kW;
  __shared__ __align__(16) float c[3 * kPlane];
  const int Mf = a.Mf, Nf = a.Nf, fplane = Mf * Nf, Mc = a.Mc, Nc = a.Nc;
  const int tile = blockIdx.x / a.K, probe = blockIdx.x - tile * a.K;
  const int ty = tile / a.tiles_x, tx = tile - ty * a.tiles_x;
  const int k0 = ty * QR, l0 = tx * QC;
  const size_t field = static_cast<size_t>(blockIdx.z) * a.K + probe;
  stage<QR + 1, kW>(c, kPlane, a.e + field * 3 * Mc * Nc, k0, l0, Mc, Nc);
  cp_async_commit();
  const int qy = threadIdx.x / QC, qx = threadIdx.x - qy * QC;
  const int i = 2 * (k0 + qy), j = 2 * (l0 + qx);
  const bool on = i < Mf && j < Nf, both = j + 1 < Nf;
  float* out = a.out + field * 3 * fplane + i * Nf + j;
  const float* x = kAdd ? a.x + field * 3 * fplane + i * Nf + j : nullptr;
  float xv[3][2][2] = {};
  bool paired[3][2] = {};
  if (on) {
#pragma unroll
    for (int o = 0; o < 3; ++o)
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int at = o * fplane + d * Nf;
        paired[o][d] = both && ((reinterpret_cast<uintptr_t>(out + at) |
                                 (kAdd ? reinterpret_cast<uintptr_t>(x + at) : 0)) & 7) == 0;
        if (kAdd && (d == 0 || i + 1 < Mf)) {  // x first: its loads overlap the stage's
          if (paired[o][d]) {
            const float2 v = __ldg(reinterpret_cast<const float2*>(x + at));
            xv[o][d][0] = v.x;
            xv[o][d][1] = v.y;
          } else {
            xv[o][d][0] = __ldg(x + at);
            if (both) xv[o][d][1] = __ldg(x + at + 1);
          }
        }
      }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!on) return;
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    const float* c0 = c + o * kPlane + qy * kW;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      if (d == 1 && i + 1 >= Mf) break;
      const float p0 = prolong_row(c0, c0 + kW, d, qx), p1 = prolong_row(c0, c0 + kW, d, qx + 1);
      float v0 = p0, v1 = half_sum(p0, p1);
      if (kAdd) {
        v0 = __fadd_rn(xv[o][d][0], v0);
        v1 = __fadd_rn(xv[o][d][1], v1);
      }
      float* dst = out + o * fplane + d * Nf;
      if (paired[o][d]) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        dst[0] = v0;
        if (both) dst[1] = v1;
      }
    }
  }
}

// FR x FC fine pixels a block: xp = x + P e on them and a one-pixel halo in
// shared memory, then the sweep from xp on them
template <int FR, int FC>
__global__ void __launch_bounds__(kThreads, 2) prolong_sweep_kernel(const Args a) {
  constexpr int kPH = FR + 2, kPW = FC + 2, kPPlane = kPH * kPW;  // xp, origin (r0 - 1, c0 - 1)
  // e, origin (r0 / 2 - 1, c0 / 2 - 1)
  constexpr int kCH = FR / 2 + 2, kCW = FC / 2 + 2, kCPlane = kCH * kCW;
  __shared__ __align__(16) float xp[3 * kPPlane];
  __shared__ __align__(16) float c[3 * kCPlane];
  const int Mf = a.Mf, Nf = a.Nf, fplane = Mf * Nf, Mc = a.Mc, Nc = a.Nc;
  const int ty = blockIdx.x / a.tiles_x, tx = blockIdx.x - ty * a.tiles_x;
  const int r0 = ty * FR, c0 = tx * FC;
  const size_t pair = blockIdx.z;  // K == 1
  stage<kPH, kPW>(xp, kPPlane, a.x + pair * 3 * fplane, r0 - 1, c0 - 1, Mf, Nf);
  stage<kCH, kCW>(c, kCPlane, a.e + pair * 3 * Mc * Nc, r0 / 2 - 1, c0 / 2 - 1, Mc, Nc);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int p = threadIdx.x; p < kPPlane; p += kThreads) {
    const int li = p / kPW, lj = p - li * kPW;
    const int i = r0 - 1 + li, j = c0 - 1 + lj;
    const bool on = i >= 0 && i < Mf && j >= 0 && j < Nf;
    const int sk = (i >> 1) - (r0 / 2 - 1), sl = (j >> 1) - (c0 / 2 - 1);
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      float v = 0.0f;
      if (on) {
        const float* ck = c + o * kCPlane + sk * kCW;
        const float p0 = prolong_row(ck, ck + kCW, i & 1, sl);
        const float pe = (j & 1) ? half_sum(p0, prolong_row(ck, ck + kCW, i & 1, sl + 1)) : p0;
        v = __fadd_rn(xp[o * kPPlane + p], pe);
      }
      xp[o * kPPlane + p] = v;
    }
  }
  __syncthreads();
  const float* S = a.S + pair * 81 * fplane;
  const float* Bi = a.binv + pair * 9 * fplane;
  const float* b = a.b + pair * 3 * fplane;
  float* out = a.out + pair * 3 * fplane;
  for (int p = threadIdx.x; p < FR * FC; p += kThreads) {
    const int li = p / FC, lj = p - li * FC;
    const int i = r0 + li, j = c0 + lj;
    if (i >= Mf || j >= Nf) continue;
    const int pix = i * Nf + j;
    float nb[27], s[3], r[3];
    gather<kPW>(xp, kPPlane, li, lj, nb);
    mg::apply_stencil(S + pix, fplane, nb, s);
#pragma unroll
    for (int o = 0; o < 3; ++o) r[o] = __fsub_rn(__ldg(b + o * fplane + pix), s[o]);
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      const float w = __fmul_rn(a.damp, mg::block_row(Bi + o * 3 * fplane + pix, fplane, r));
      out[o * fplane + pix] = __fadd_rn(nb[o * 9 + 4], w);
    }
  }
}

// SMs of the current device (cached per device)
int sm_count() {
  static int counts[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev] > 0 ? counts[dev] : 132;
}

long long tiles_of(int R, int C, int TR, int TC) {
  return static_cast<long long>((R + TR - 1) / TR) * ((C + TC - 1) / TC);
}

// whether `blocks` give every SM two
bool fills(long long blocks) { return blocks >= 2LL * sm_count(); }

// blockIdx.x = tile K + probe over TR x TC tiles of the R x C grid, blockIdx.z
// the pair
template <typename Kernel>
int launch(Kernel kernel, Args a, int R, int C, int TR, int TC, int B, int threads,
           cudaStream_t stream) {
  a.tiles_x = (C + TC - 1) / TC;
  const long long blocks = tiles_of(R, C, TR, TC) * a.K;
  if (blocks == 0 || B == 0) return 0;
  if (blocks > INT_MAX || B > kGridZ) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<dim3(static_cast<unsigned>(blocks), 1, B), threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch_restrict(const Args& a, int B, cudaStream_t s) {
  if (fills(tiles_of(a.Mc, a.Nc, 8, 32) * a.K * B))
    return launch(restrict_kernel<kMode, 8, 32>, a, a.Mc, a.Nc, 8, 32, B, kThreads, s);
  return launch(restrict_kernel<kMode, 8, 16>, a, a.Mc, a.Nc, 8, 16, B, kThreads, s);
}

template <bool kAdd>
int launch_prolong(const Args& a, int B, cudaStream_t s) {
  if (fills(tiles_of(a.Mc, a.Nc, 8, 32) * a.K * B))
    return launch(prolong_kernel<kAdd, 8, 32>, a, a.Mc, a.Nc, 8, 32, B, 256, s);
  return launch(prolong_kernel<kAdd, 4, 16>, a, a.Mc, a.Nc, 4, 16, B, 64, s);
}

int launch_prolong_sweep(const Args& a, int B, cudaStream_t s) {
  if (fills(tiles_of(a.Mf, a.Nf, 16, 64) * B))
    return launch(prolong_sweep_kernel<16, 64>, a, a.Mf, a.Nf, 16, 64, B, kThreads, s);
  return launch(prolong_sweep_kernel<8, 32>, a, a.Mf, a.Nf, 8, 32, B, kThreads, s);
}

int launch_sweep_restrict(const Args& a, int B, cudaStream_t s) {
  return launch(sweep_restrict_kernel<4, 16>, a, a.Mc, a.Nc, 4, 16, B,
                SRTile<4, 16>::kThreads, s);
}

}  // namespace

// Launches kernel B6 on `stream` and returns the CUDA error of the launch;
// the caller checks shapes ((Mc, Nc) the coarse grid of (Mf, Nf), B at most
// 65,535, 81 Mf Nf below 2^31), types and contiguity.  mode: 0-3
// restriction (bit 0: r from S x, else from y; bit 1: b minus it), 4-5
// prolongation (4: P e, 5: x + P e), 6 the sweep from x and R (b - S x1),
// x1 into out2, 7 the sweep from x + P e; 6 and 7 read binv and damp and
// take K = 1.
extern "C" int mg_transfer(const float* S, const float* binv, const float* x, const float* b,
                           const float* y, const float* e, float* out, float* out2, int B, int K,
                           int Mf, int Nf, int Mc, int Nc, float damp, int mode, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const Args a{S, binv, x, b, y, e, out, out2, K, Mf, Nf, Mc, Nc, damp, 0};
  switch (mode) {
    case kRestrictY: return launch_restrict<kRestrictY>(a, B, s);
    case kRestrictSx: return launch_restrict<kRestrictSx>(a, B, s);
    case kRestrictBmY: return launch_restrict<kRestrictBmY>(a, B, s);
    case kRestrictBmSx: return launch_restrict<kRestrictBmSx>(a, B, s);
    case kProlong: return launch_prolong<false>(a, B, s);
    case kProlongAdd: return launch_prolong<true>(a, B, s);
    case kSweepRestrict:
      return K == 1 ? launch_sweep_restrict(a, B, s) : static_cast<int>(cudaErrorInvalidValue);
    case kProlongSweep:
      return K == 1 ? launch_prolong_sweep(a, B, s) : static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
