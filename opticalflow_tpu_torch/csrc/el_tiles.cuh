// The tiled Euler-Lagrange matvec kernel of kernels B2 and B3 (Hopper,
// sm_90a), B1's design (el_matvec.cu) as one template with the staging
// rule as its parameter:
//   kZero    (el_matvec_plain.cu, B2): zero reads outside the interior;
//   kWindows (el_matvec_ext.cu, B3 on one device): every tile of a mesh
//            tiling read straight from the whole interior field, a seam
//            being a read of the neighbour tile's pixels and a global
//            edge B1's mirror fold;
//   kLines   (el_matvec_ext.cu, B3 over distinct devices): one tile's
//            interior plus its four received halo lines.
// B1 keeps its own kernel body (the fold rule) and shares this file's
// constants, ring and staging helpers.  The per-pixel arithmetic is
// el_stencil.cuh's `coefficients` / `apply`, so every rule computes what
// the JAX kernel it replaces computes from the same staged values.
//
// What bounds it: memory.  A pixel needs I once (4 bytes) and, per field
// stack, 3 planes in and 3 out: 4 + 24 K bytes at K stacks (28 at K = 1),
// against ~110 flops per pixel and stack.  The Krylov loops call it with
// K = 1 (one pair of 510^2 or 1022^2, up to 150 pairs of 126^2; B3 one
// launch over the 2 x 2 tiles of 511^2, or one per tile); the multigrid
// comb probes with K = 27.
//
// The design, for those shapes (one kernel, its block height chosen by K):
//   * register-blocked strips: a block of 32 x W threads owns a tile of
//     32 columns x 4W rows; each thread computes 4 rows of one column,
//     walking down with a rolling 3-row window of I and of the three
//     fields, so a staged element is read from shared memory ~1.5 times,
//     not 9, and the halo costs (34 x 18) / (32 x 16) = 1.20x the reads at
//     W = 4 (K = 1: more blocks in flight for the one-pair shapes) and
//     (34 x 34) / (32 x 32) = 1.13x at W = 8 (K > 1, where the taller tile
//     is faster);
//   * I once per tile: a work item is one (block, tile) and its K field
//     stacks; the I tile is staged and the coefficients of the thread's 4
//     pixels built into registers once, then the K stacks stream past them
//     (at K = 27, 1/27 of the I reads and coefficient arithmetic);
//   * asynchronous staging in a ring: each block walks its work items'
//     (item, stack) stages through a double-buffered ring of shared-memory
//     stages, fed by 4-byte cp.async (the field planes' row pitch, n = 126
//     ... 1022 floats, is 8 bytes off 16-byte alignment, and a tile of 511
//     columns is 4 bytes off, so neither TMA tensor maps nor vector loads
//     fit them): the next stage's tiles load while the current one is
//     computed and stored.  At K = 1 the grid is persistent (at most the
//     blocks resident at once, each with the same number of items),
//     walking the items grid-stride, so neighbouring blocks stage
//     neighbouring tiles at the same time and share their halo rows' cache
//     lines in L2; at K > 1 a block takes one item and its K stacks fill
//     the ring (blocks that each walk several items drift apart and lose
//     that locality, and a third stage slows K = 27; the measurements are
//     in PERF.md).  The grid is one-dimensional: no limit on blocks x K;
//   * the staging rule only where it applies: whether a tile's halo lies
//     inside what it may read plainly is decided once per stage for the
//     whole block; such tiles stage with plain offsets and no selects;
//     the others apply the rule to each halo element (fold, zero, or the
//     halo line it lies on), zero-fill what lies beyond, and under the
//     fold rule the thread that staged a doubled global corner doubles it
//     in shared memory after its own copies landed, before the block's
//     barrier.
// One thread per (column, 4 rows), no atomics: results are deterministic.

#pragma once

#include <climits>

#include <cuda_runtime.h>

#include "el_stencil.cuh"

namespace el_tiles {

using el_stencil::Coeffs;

enum Rule : int { kZero = 1, kWindows = 2, kLines = 3 };

constexpr int kCols = 32;          // tile columns = threads along x
constexpr int kRows = 4;           // output rows per thread
constexpr int kHaloW = kCols + 2;  // staged columns
constexpr int kStages = 2;         // ring depth
// threads along y of a block (its warps): at K = 1 tiles of 32 x 16 and
// four blocks of 128 threads an SM; at K > 1 tiles of 32 x 32 and two
// blocks of 256 threads
constexpr int kWarpsSolve = 4;
constexpr int kWarpsProbes = 8;

// The operands of one launch.  A block is one (m+2, n+2) frame block of I
// with its scalars and K field stacks of (m, n) outputs:
//   kZero: block b is pair b; u and out are (B, K, 3, m, n);
//   kWindows: block b is tile (b % (tx ty)) of pair b / (tx ty), tile (p,
//     q) = (t / ty, t % ty) at rows p m, columns q n of the pair's
//     (tx m, ty n) field; u and out are (B, K, 3, tx m, ty n);
//   kLines: block b's interior is u (N, K, 3, m, n), its halo the rows
//     above and below, corners included, top / bottom (N, K, 3, n + 2),
//     and the columns left / right (N, K, 3, m).
// kWindows and kLines read u and write out through their plane and row
// pitches (in floats), and kLines its halo lines through theirs (a plane
// pitch each; left and right also an element pitch), so a tile and its
// lines may be views into larger fields.
struct Args {
  const float* I;
  const float* scalars;
  const float* u;
  float* out;
  const float* top;
  const float* bottom;
  const float* left;
  const float* right;
  int K, m, n;
  int tx, ty;
  long long u_plane, out_plane;
  int u_row, out_row;
  long long top_plane, bottom_plane, left_plane, right_plane;
  int left_step, right_step;
  int compat;
};

// The geometry of a block of kCols x W threads and of its tile.
template <int W>
struct Tile {
  static constexpr int kRowsOut = W * kRows;  // output rows of the tile
  static constexpr int kHaloH = kRowsOut + 2;
  static constexpr int kHalo = kHaloW * kHaloH;  // elements of one staged plane
  static constexpr int kThreads = kCols * W;
  static constexpr int kPerThread = (kHalo + kThreads - 1) / kThreads;
  static constexpr int kSlot = 4 * kHalo;  // floats per stage: I, then ux, uy, g
  static constexpr int kSmemBytes = kStages * kSlot * static_cast<int>(sizeof(float));
  static constexpr int kMinBlocksPerSM = 512 / kThreads;  // at most 128 registers a thread
};

// 4-byte asynchronous copy global -> shared; zero-fills (and reads nothing)
// when !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's most recent groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Interior index of extended index e in [-1, len] (the mirror rows: -1
// reads 1, len reads len - 2); -1 beyond the one-pixel ring (staged as
// zero, only read by outputs that are discarded).
__device__ __forceinline__ int fold(int e, int len) {
  if (e == -1) return 1;
  if (e == len) return len - 2;
  return (e >= 0 && e < len) ? e : -1;
}

// One stage: work item (block b of pair `pair`, its tile at (i0, j0) of
// the block) and field stack k; (gi0, gj0) is the tile's origin in the
// pair's field (kWindows; the block's own otherwise).  Decoded anew for
// every stage, as in B1: held across the stage loop, the decoded geometry
// pushed the K > 1 kernels past 128 registers into spills.
struct Stage {
  int b, pair, k, i0, j0, gi0, gj0;
  bool interior;  // the field tile's halo may be staged with plain offsets
  bool i_plain;   // so may the I tile's (kWindows: not where the tile
                  // leaves its mesh tile, whose field halo is the neighbour's)
};

// Stage j of this block: its (j / K)-th work item, blockIdx.x + (j / K) *
// gridDim.x, and field stack j % K.
template <int W, int kRule>
__device__ __forceinline__ Stage decode(int j, const Args& a, int tiles_x, int tiles) {
  using T = Tile<W>;
  Stage st;
  const int t = j / a.K;
  st.k = j - t * a.K;
  const int item = blockIdx.x + t * gridDim.x;
  st.b = item / tiles;
  const int tile = item - st.b * tiles;
  const int ti = tile / tiles_x;
  st.i0 = ti * T::kRowsOut;
  st.j0 = (tile - ti * tiles_x) * kCols;
  st.pair = st.b;
  st.gi0 = st.i0;
  st.gj0 = st.j0;
  if constexpr (kRule == kWindows) {
    st.pair = st.b / (a.tx * a.ty);
    const int tt = st.b - st.pair * a.tx * a.ty;
    const int p = tt / a.ty;
    st.gi0 += p * a.m;
    st.gj0 += (tt - p * a.ty) * a.n;
    // the field halo inside the pair's field, the I tile inside the block
    st.interior = st.gi0 >= 1 && st.gi0 + T::kRowsOut + 1 <= a.tx * a.m && st.gj0 >= 1 &&
                  st.gj0 + kCols + 1 <= a.ty * a.n;
    st.i_plain = st.i0 + T::kRowsOut <= a.m && st.j0 + kCols <= a.n;
  } else {
    st.interior = st.i0 >= 1 && st.i0 + T::kRowsOut + 1 <= a.m && st.j0 >= 1 &&
                  st.j0 + kCols + 1 <= a.n;
    st.i_plain = st.interior;
  }
  return st;
}

// The first plane of stage st's field stack and its plane and row
// pitches.
template <int kRule>
__device__ __forceinline__ const float* field_base(const Stage& st, const Args& a,
                                                   size_t& plane, int& row) {
  if constexpr (kRule == kZero) {
    plane = static_cast<size_t>(a.m) * a.n;
    row = a.n;
  } else {
    plane = static_cast<size_t>(a.u_plane);
    row = a.u_row;
  }
  return a.u + (static_cast<size_t>(st.pair) * a.K + st.k) * 3 * plane;
}

// Issues this thread's copies of one stage into `slot`: the I tile when
// `with_i` (halo element (r, c) = frame block pixel (i0 + r, j0 + c)) and
// the three field tiles (halo element (r, c) = the field extended by the
// staging rule at (gi0 - 1 + r, gj0 - 1 + c)).
template <int W, int kRule>
__device__ __forceinline__ void issue(float* slot, const Stage& st, bool with_i, const Args& a,
                                      int tid) {
  using T = Tile<W>;
  const int m = a.m, n = a.n;
  const int nj = n + 2;
  size_t plane;
  int row;
  const float* Ib = a.I + static_cast<size_t>(st.b) * (m + 2) * nj;
  const float* ub = field_base<kRule>(st, a, plane, row);
  if (st.interior) {
    const float* It = Ib + static_cast<size_t>(st.i0) * nj + st.j0;
    const float* ut = ub + static_cast<size_t>(st.gi0 - 1) * row + (st.gj0 - 1);
#pragma unroll
    for (int e = 0; e < T::kPerThread; ++e) {
      const int idx = tid + e * T::kThreads;
      if (e < T::kPerThread - 1 || idx < T::kHalo) {
        const int r = idx / kHaloW;
        const int c = idx - r * kHaloW;
        if (kRule != kWindows || st.i_plain) {
          if (with_i) cp_async4(slot + idx, It + r * nj + c, true);
        } else if (with_i) {  // a tile leaving its mesh tile: I bounded by the block
          const bool ok = st.i0 + r < m + 2 && st.j0 + c < nj;
          cp_async4(slot + idx, ok ? It + r * nj + c : Ib, ok);
        }
        const float* src = ut + r * row + c;
#pragma unroll
        for (int q = 0; q < 3; ++q) cp_async4(slot + (q + 1) * T::kHalo + idx, src + q * plane, true);
      }
    }
  } else {
    // kLines: the stack's four halo lines
    const size_t stack = static_cast<size_t>(st.b) * a.K + st.k;
#pragma unroll
    for (int e = 0; e < T::kPerThread; ++e) {
      const int idx = tid + e * T::kThreads;
      if (e < T::kPerThread - 1 || idx < T::kHalo) {
        const int r = idx / kHaloW;
        const int c = idx - r * kHaloW;
        const int fi = st.i0 + r, fj = st.j0 + c;
        if (with_i) {
          const bool ok = fi < m + 2 && fj < nj;
          cp_async4(slot + idx, ok ? Ib + static_cast<size_t>(fi) * nj + fj : Ib, ok);
        }
        const float* src = ub;
        size_t pitch = plane;
        bool ok;
        if constexpr (kRule == kLines) {
          const int li = fi - 1, lj = fj - 1;
          const bool in_i = li >= 0 && li < m, in_j = lj >= 0 && lj < n;
          const bool on_j = lj >= -1 && lj <= n;
          ok = true;
          if (in_i && in_j) {
            src = ub + static_cast<size_t>(li) * row + lj;
          } else if ((li == -1 || li == m) && on_j) {
            const bool top = li == -1;
            pitch = static_cast<size_t>(top ? a.top_plane : a.bottom_plane);
            src = (top ? a.top : a.bottom) + stack * 3 * pitch + (lj + 1);
          } else if (in_i && (lj == -1 || lj == n)) {
            const bool left = lj == -1;
            pitch = static_cast<size_t>(left ? a.left_plane : a.right_plane);
            src = (left ? a.left : a.right) + stack * 3 * pitch +
                  static_cast<size_t>(li) * (left ? a.left_step : a.right_step);
          } else {
            ok = false;
          }
        } else {
          int si, sj;
          if constexpr (kRule == kZero) {
            si = (fi >= 1 && fi <= m) ? fi - 1 : -1;
            sj = (fj >= 1 && fj <= n) ? fj - 1 : -1;
          } else {
            si = fold(st.gi0 - 1 + r, a.tx * m);
            sj = fold(st.gj0 - 1 + c, a.ty * n);
          }
          ok = si >= 0 && sj >= 0;
          if (ok) src = ub + static_cast<size_t>(si) * row + sj;
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) cp_async4(slot + (q + 1) * T::kHalo + idx, src + q * pitch, ok);
      }
    }
  }
}

// After this thread's copies of a border stage landed: doubles the corners
// of the extended field (both indices mirrored) that this thread staged
// (kWindows: the pair's field of gm x gn).
template <int W>
__device__ __forceinline__ void double_corners(float* slot, const Stage& st, int gm, int gn,
                                               int tid) {
  using T = Tile<W>;
  const int rows[2] = {st.gi0 == 0 ? 0 : -1, gm + 1 - st.gi0};  // extended rows -1 and gm
  const int cols[2] = {st.gj0 == 0 ? 0 : -1, gn + 1 - st.gj0};  // extended columns -1 and gn
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int bb = 0; bb < 2; ++bb) {
      const int r = rows[a], c = cols[bb];
      if (r >= 0 && r < T::kHaloH && c >= 0 && c < kHaloW) {
        const int idx = r * kHaloW + c;
        if (idx % T::kThreads == tid) {
#pragma unroll
          for (int q = 1; q < 4; ++q) slot[q * T::kHalo + idx] *= 2.f;
        }
      }
    }
  }
}

template <int W, int kRule>
__global__ void __launch_bounds__(Tile<W>::kThreads, Tile<W>::kMinBlocksPerSM)
el_matvec_tiles_kernel(const Args a, int tiles_x, int tiles, int items) {
  using T = Tile<W>;
  extern __shared__ float smem[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kCols + tx;
  const int K = a.K;
  // this block's work items: blockIdx.x, + gridDim.x, ...; so at any time
  // neighbouring blocks stage neighbouring tiles of the same field stack
  const int stages = (items - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                     static_cast<int>(gridDim.x) * K;

  // prologue: the first kStages - 1 stages in flight (one group each, empty
  // past the end, so that group counting stays uniform)
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < stages) {
      const Stage st = decode<W, kRule>(p, a, tiles_x, tiles);
      issue<W, kRule>(smem + p * T::kSlot, st, st.k == 0, a, tid);
    }
    cp_async_commit();
  }

  Coeffs cf[kRows];
  float a_s = 0.f, a_r = 0.f;
  int slot = 0;
  for (int js = 0; js < stages; ++js) {
    const Stage st = decode<W, kRule>(js, a, tiles_x, tiles);
    float* cur = smem + slot * T::kSlot;
    cp_async_wait<kStages - 2>();  // this thread's copies of stage js landed
    if constexpr (kRule == kWindows) {
      if (!st.interior) double_corners<W>(cur, st, a.tx * a.m, a.ty * a.n, tid);
    }
    __syncthreads();  // everyone's copies of stage js landed; stage js - 1 is consumed

    // refill the slot stage js - 1 used with stage js + kStages - 1
    if (js + kStages - 1 < stages) {
      const Stage nx = decode<W, kRule>(js + kStages - 1, a, tiles_x, tiles);
      const int nslot = slot == 0 ? kStages - 1 : slot - 1;
      issue<W, kRule>(smem + nslot * T::kSlot, nx, nx.k == 0, a, tid);
    }
    cp_async_commit();

    const int r0 = ty * kRows;  // the thread's first output row in the tile
    if (st.k == 0) {
      // the coefficients of the thread's kRows pixels, from a rolling
      // 3-row window of the staged I tile
      a_s = a.scalars[2 * st.b];
      a_r = a.scalars[2 * st.b + 1];
      float w[3][3];
#pragma unroll
      for (int aa = 0; aa < 2; ++aa) {
#pragma unroll
        for (int bb = 0; bb < 3; ++bb) w[aa][bb] = cur[(r0 + aa) * kHaloW + tx + bb];
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
#pragma unroll
        for (int bb = 0; bb < 3; ++bb) w[2][bb] = cur[(r0 + rr + 2) * kHaloW + tx + bb];
        cf[rr] = el_stencil::coefficients(w, a_s, a.compat);
#pragma unroll
        for (int bb = 0; bb < 3; ++bb) {
          w[0][bb] = w[1][bb];
          w[1][bb] = w[2][bb];
        }
      }
    }

    // the stencil down the thread's column, rolling 3-row windows of the
    // three staged field tiles
    float ux[3][3], uy[3][3], g[3][3];
    const float* sx = cur + T::kHalo;
    const float* sy = cur + 2 * T::kHalo;
    const float* sg = cur + 3 * T::kHalo;
#pragma unroll
    for (int aa = 0; aa < 2; ++aa) {
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) {
        const int o = (r0 + aa) * kHaloW + tx + bb;
        ux[aa][bb] = sx[o];
        uy[aa][bb] = sy[o];
        g[aa][bb] = sg[o];
      }
    }
    const int j = st.j0 + tx;
    size_t plane;
    int row;
    if constexpr (kRule == kZero) {
      plane = static_cast<size_t>(a.m) * a.n;
      row = a.n;
    } else {
      plane = static_cast<size_t>(a.out_plane);
      row = a.out_row;
    }
    float* ob = a.out + (static_cast<size_t>(st.pair) * K + st.k) * 3 * plane +
                static_cast<size_t>(st.gi0 - st.i0) * row + (st.gj0 - st.j0);
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) {
        const int o = (r0 + rr + 2) * kHaloW + tx + bb;
        ux[2][bb] = sx[o];
        uy[2][bb] = sy[o];
        g[2][bb] = sg[o];
      }
      float y[3];
      el_stencil::apply(cf[rr], a_s, a_r, ux, uy, g, y);
      const int i = st.i0 + r0 + rr;
      if (i < a.m && j < a.n) {
        const size_t o = static_cast<size_t>(i) * row + j;
        ob[o] = y[0];
        ob[plane + o] = y[1];
        ob[2 * plane + o] = y[2];
      }
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) {
        ux[0][bb] = ux[1][bb];
        ux[1][bb] = ux[2][bb];
        uy[0][bb] = uy[1][bb];
        uy[1][bb] = uy[2][bb];
        g[0][bb] = g[1][bb];
        g[1][bb] = g[2][bb];
      }
    }
    slot = slot == kStages - 1 ? 0 : slot + 1;
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// The blocks resident on the current device at once (cached per device;
// sets the kernel's dynamic shared memory limit on first use).
template <int W, int kRule>
int resident_blocks(int* out_blocks) {
  using T = Tile<W>;
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && cached[dev] > 0) {
    *out_blocks = cached[dev];
    return 0;
  }
  err = cudaFuncSetAttribute(el_matvec_tiles_kernel<W, kRule>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, el_matvec_tiles_kernel<W, kRule>,
                                                      T::kThreads, T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *out_blocks = sms * per_sm;
  if (dev < 64) cached[dev] = *out_blocks;
  return 0;
}

// Launches the kernel of W warps a block over `blocks` frame blocks on
// `stream` and returns the CUDA error of the launch.
template <int W, int kRule>
int launch_tiles(const Args& a, int blocks_in, void* stream) {
  using T = Tile<W>;
  int resident = 0;
  const int rc = resident_blocks<W, kRule>(&resident);
  if (rc != 0) return rc;
  const int tiles_x = (a.n + kCols - 1) / kCols;
  const int tiles = tiles_x * ((a.m + T::kRowsOut - 1) / T::kRowsOut);
  const long long items = static_cast<long long>(blocks_in) * tiles;
  // K = 1: as few items per block as the resident blocks allow, then as
  // few blocks as carry that many each.  K > 1: one item per block (its K
  // stages fill the ring), so blocks run in the order the hardware starts
  // them and neighbouring tiles stay in step.
  const long long per_block = a.K > 1 ? 1 : (items + resident - 1) / resident;
  if (per_block * a.K > INT_MAX || items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (items + per_block - 1) / per_block;
  el_matvec_tiles_kernel<W, kRule><<<static_cast<unsigned>(blocks), dim3(kCols, W),
                                     T::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      a, tiles_x, tiles, static_cast<int>(items));
  return static_cast<int>(cudaGetLastError());
}

// Launches rule kRule over `blocks` frame blocks on `stream` and returns
// the CUDA error of the launch; the caller checks shapes and layouts.
template <int kRule>
int launch(const Args& a, int blocks, void* stream) {
  return a.K == 1 ? launch_tiles<kWarpsSolve, kRule>(a, blocks, stream)
                  : launch_tiles<kWarpsProbes, kRule>(a, blocks, stream);
}

}  // namespace el_tiles
