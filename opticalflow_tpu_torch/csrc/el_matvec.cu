// Fused reduced Euler-Lagrange matvec for Hopper (sm_90a).
//
// Replaces the TPU kernel opticalflow_tpu/ops/pallas_kernels.py::
// _el_matvec_interior_kernel (v4): y = A_reduced u for a batch of frame
// pairs, with the 11 coefficient planes rebuilt from the previous frame I and
// the pair's (alpha_s, alpha_r) on every application, and the mirror rows of
// the reduced system folded into the reads (row -1 reads row 1, row m reads
// row m-2, columns likewise, doubled where both indices were mirrored).
// Same semantics as ops/elop.el_matvec_reduced on precomputed planes.  The
// layout and the per-pixel arithmetic are in el_stencil.cuh.
//
// What bounds it: memory.  A pixel needs I once (4 bytes) and, per field
// stack, 3 planes in and 3 out: 4 + 24 K bytes at K stacks (28 at K = 1),
// against ~110-150 flops per pixel and stack.  The Krylov loop calls it
// with K = 1 on one pair (the command line's 1 x 510^2) up to 150 pairs
// (the sweep's 126^2 chunks); the multigrid comb probes with K = 27.
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
//   * I once per tile: a work item is one (pair, tile) and its K field
//     stacks; the I tile is staged and the coefficients of the thread's 4
//     pixels built into registers once, then the K stacks stream past them
//     (at K = 27, 1/27 of the I reads and coefficient arithmetic);
//   * asynchronous staging in a ring: each block walks its work items'
//     (item, stack) stages through a double-buffered ring of shared-memory
//     stages, fed by 4-byte cp.async (the field planes' row pitch, n = 126
//     ... 1022 floats, is 8 bytes off 16-byte alignment, so neither TMA
//     tensor maps nor vector loads fit them): the next stage's tiles load
//     while the current one is computed and stored.  At K = 1 the grid is
//     persistent (at most the blocks resident at once, each with the same
//     number of items), walking the items grid-stride, so neighbouring
//     blocks stage neighbouring tiles at the same time and share their halo
//     rows' cache lines in L2; at K > 1 a block takes one item and its K
//     stacks fill the ring (blocks that each walk several items drift
//     apart and lose that locality, and a third stage slows K = 27; the
//     measurements are in PERF.md);
//   * mirror folds only where they apply: whether a tile touches the border
//     is decided once per stage for the whole block; interior tiles stage
//     with plain offsets and no selects; border tiles fold the offsets of
//     their halo elements, zero-fill what lies beyond the ring, and the
//     thread that staged a doubled corner doubles it in shared memory after
//     its own copies landed, before the block's barrier.
// One thread per (column, 4 rows), no atomics: results are deterministic.

#include <climits>

#include <cuda_runtime.h>

#include "el_stencil.cuh"

namespace {

using el_stencil::Coeffs;

constexpr int kCols = 32;          // tile columns = threads along x
constexpr int kRows = 4;           // output rows per thread
constexpr int kHaloW = kCols + 2;  // staged columns
constexpr int kStages = 2;         // ring depth
// threads along y of a block (its warps): at K = 1 tiles of 32 x 16 and
// four blocks of 128 threads an SM; at K > 1 tiles of 32 x 32 and two
// blocks of 256 threads
constexpr int kWarpsSolve = 4;
constexpr int kWarpsProbes = 8;

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

// One stage: work item (pair b, tile at (i0, j0)) and field stack k.
struct Stage {
  int b, k, i0, j0;
  bool interior;  // the tile's halo lies inside [0, m) x [0, n): no folds
};

// Stage j of this block: its (j / K)-th work item, blockIdx.x + (j / K) *
// gridDim.x, and field stack j % K.
template <int W>
__device__ __forceinline__ Stage decode(int j, int K, int tiles_x, int tiles, int m, int n) {
  using T = Tile<W>;
  Stage st;
  const int t = j / K;
  st.k = j - t * K;
  const int item = blockIdx.x + t * gridDim.x;
  st.b = item / tiles;
  const int tile = item - st.b * tiles;
  const int ti = tile / tiles_x;
  st.i0 = ti * T::kRowsOut;
  st.j0 = (tile - ti * tiles_x) * kCols;
  st.interior = st.i0 >= 1 && st.i0 + T::kRowsOut + 1 <= m && st.j0 >= 1 &&
                st.j0 + kCols + 1 <= n;
  return st;
}

// Issues this thread's copies of one stage into `slot`: the I tile when
// `with_i` (halo element (r, c) = frame pixel (i0 + r, j0 + c)) and the
// three field tiles (halo element (r, c) = extended interior pixel
// (i0 - 1 + r, j0 - 1 + c)).
template <int W>
__device__ __forceinline__ void issue(float* slot, const Stage& st, bool with_i,
                                      const float* __restrict__ I, const float* __restrict__ u,
                                      int K, int m, int n, int tid) {
  using T = Tile<W>;
  const int nj = n + 2;
  const size_t plane = static_cast<size_t>(m) * n;
  const float* Ib = I + static_cast<size_t>(st.b) * (m + 2) * nj;
  const float* ub = u + (static_cast<size_t>(st.b) * K + st.k) * 3 * plane;
  if (st.interior) {
    const float* It = Ib + static_cast<size_t>(st.i0) * nj + st.j0;
    const float* ut = ub + static_cast<size_t>(st.i0 - 1) * n + (st.j0 - 1);
#pragma unroll
    for (int e = 0; e < T::kPerThread; ++e) {
      const int idx = tid + e * T::kThreads;
      if (e < T::kPerThread - 1 || idx < T::kHalo) {
        const int r = idx / kHaloW;
        const int c = idx - r * kHaloW;
        if (with_i) cp_async4(slot + idx, It + r * nj + c, true);
        const float* src = ut + r * n + c;
#pragma unroll
        for (int q = 0; q < 3; ++q) cp_async4(slot + (q + 1) * T::kHalo + idx, src + q * plane, true);
      }
    }
  } else {
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
        const int si = fold(fi - 1, m);
        const int sj = fold(fj - 1, n);
        const bool ok = si >= 0 && sj >= 0;
        const float* src = ok ? ub + static_cast<size_t>(si) * n + sj : ub;
#pragma unroll
        for (int q = 0; q < 3; ++q) cp_async4(slot + (q + 1) * T::kHalo + idx, src + q * plane, ok);
      }
    }
  }
}

// After this thread's copies of a border stage landed: doubles the corners
// of the extended field (both indices mirrored) that this thread staged.
template <int W>
__device__ __forceinline__ void double_corners(float* slot, const Stage& st, int m, int n,
                                               int tid) {
  using T = Tile<W>;
  const int rows[2] = {st.i0 == 0 ? 0 : -1, m + 1 - st.i0};  // extended rows -1 and m
  const int cols[2] = {st.j0 == 0 ? 0 : -1, n + 1 - st.j0};  // extended columns -1 and n
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

template <int W>
__global__ void __launch_bounds__(Tile<W>::kThreads, Tile<W>::kMinBlocksPerSM)
el_matvec_reduced_kernel(const float* __restrict__ I, const float* __restrict__ scalars,
                         const float* __restrict__ u, float* __restrict__ out, int K, int m,
                         int n, int compat, int tiles_x, int tiles, int items) {
  using T = Tile<W>;
  extern __shared__ float smem[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kCols + tx;
  // this block's work items: blockIdx.x, + gridDim.x, ...; so at any time
  // neighbouring blocks stage neighbouring tiles of the same field stack
  const int stages = (items - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                     static_cast<int>(gridDim.x) * K;
  const size_t plane = static_cast<size_t>(m) * n;

  // prologue: the first kStages - 1 stages in flight (one group each, empty
  // past the end, so that group counting stays uniform)
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < stages) {
      const Stage st = decode<W>(p, K, tiles_x, tiles, m, n);
      issue<W>(smem + p * T::kSlot, st, st.k == 0, I, u, K, m, n, tid);
    }
    cp_async_commit();
  }

  Coeffs cf[kRows];
  float a_s = 0.f, a_r = 0.f;
  int slot = 0;
  for (int js = 0; js < stages; ++js) {
    const Stage st = decode<W>(js, K, tiles_x, tiles, m, n);
    float* cur = smem + slot * T::kSlot;
    cp_async_wait<kStages - 2>();  // this thread's copies of stage js landed
    if (!st.interior) double_corners<W>(cur, st, m, n, tid);
    __syncthreads();  // everyone's copies of stage js landed; stage js - 1 is consumed

    // refill the slot stage js - 1 used with stage js + kStages - 1
    if (js + kStages - 1 < stages) {
      const Stage nx = decode<W>(js + kStages - 1, K, tiles_x, tiles, m, n);
      const int nslot = slot == 0 ? kStages - 1 : slot - 1;
      issue<W>(smem + nslot * T::kSlot, nx, nx.k == 0, I, u, K, m, n, tid);
    }
    cp_async_commit();

    const int r0 = ty * kRows;  // the thread's first output row in the tile
    if (st.k == 0) {
      // the coefficients of the thread's kRows pixels, from a rolling
      // 3-row window of the staged I tile
      a_s = scalars[2 * st.b];
      a_r = scalars[2 * st.b + 1];
      float w[3][3];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int bb = 0; bb < 3; ++bb) w[a][bb] = cur[(r0 + a) * kHaloW + tx + bb];
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
#pragma unroll
        for (int bb = 0; bb < 3; ++bb) w[2][bb] = cur[(r0 + rr + 2) * kHaloW + tx + bb];
        cf[rr] = el_stencil::coefficients(w, a_s, compat);
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
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) {
        const int o = (r0 + a) * kHaloW + tx + bb;
        ux[a][bb] = sx[o];
        uy[a][bb] = sy[o];
        g[a][bb] = sg[o];
      }
    }
    const int j = st.j0 + tx;
    float* ob = out + (static_cast<size_t>(st.b) * K + st.k) * 3 * plane;
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
      if (i < m && j < n) {
        const size_t o = static_cast<size_t>(i) * n + j;
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
template <int W>
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
  err = cudaFuncSetAttribute(el_matvec_reduced_kernel<W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, el_matvec_reduced_kernel<W>,
                                                      T::kThreads, T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *out_blocks = sms * per_sm;
  if (dev < 64) cached[dev] = *out_blocks;
  return 0;
}

// Launches the kernel of W warps a block on `stream` and returns the CUDA
// error of the launch.
template <int W>
int launch_tiles(const float* I, const float* scalars, const float* u, float* out, int B,
                 int K, int m, int n, int compat, void* stream) {
  using T = Tile<W>;
  int resident = 0;
  const int rc = resident_blocks<W>(&resident);
  if (rc != 0) return rc;
  const int tiles_x = (n + kCols - 1) / kCols;
  const int tiles = tiles_x * ((m + T::kRowsOut - 1) / T::kRowsOut);
  const long long items = static_cast<long long>(B) * tiles;
  // K = 1: as few items per block as the resident blocks allow, then as
  // few blocks as carry that many each.  K > 1: one item per block (its K
  // stages fill the ring), so blocks run in the order the hardware starts
  // them and neighbouring tiles stay in step.
  const long long per_block = K > 1 ? 1 : (items + resident - 1) / resident;
  if (per_block * K > INT_MAX || items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (items + per_block - 1) / per_block;
  el_matvec_reduced_kernel<W><<<static_cast<unsigned>(blocks), dim3(kCols, W), T::kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      I, scalars, u, out, K, m, n, compat, tiles_x, tiles, static_cast<int>(items));
  return static_cast<int>(cudaGetLastError());
}

// Launches on `stream` and returns the CUDA error of the launch; the
// caller checks shapes (m, n >= 3) and contiguity.
int launch(const float* I, const float* scalars, const float* u, float* out, int B, int K,
           int m, int n, int compat, void* stream) {
  return K == 1 ? launch_tiles<kWarpsSolve>(I, scalars, u, out, B, K, m, n, compat, stream)
                : launch_tiles<kWarpsProbes>(I, scalars, u, out, B, K, m, n, compat, stream);
}

}  // namespace

extern "C" int el_matvec_reduced_fused(const float* I, const float* scalars,
                                       const float* u, float* out, int B, int K,
                                       int m, int n, int compat, void* stream) {
  return launch(I, scalars, u, out, B, K, m, n, compat, stream);
}
