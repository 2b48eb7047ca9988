// FGMRES's Gram-Schmidt and solution update for Hopper (sm_90a): kernel B7.
//
// It has no Pallas counterpart.  It replaces the matrix products that XLA
// runs for opticalflow_tpu/solve/krylov.py::fgmres: the classical
// Gram-Schmidt with one reorthogonalisation (CGS2) of each Arnoldi column
// (:373-376) and the solution product x + Z^T y of each restart (:487-490).
// The port's plain versions are ops/cuda_kernels.py::gram_schmidt_ref and
// basis_update_ref, torch.bmm on the same rows.  Two C modes:
//   column  the Arnoldi column of every pair b, against rows 0..j[b] of V,
//           in six launches:
//             (a) gs_dots_kernel          partials of h1 = V w and |w|^2
//             gs_reduce_kernel            h1, |w|^2
//             (b) gs_project_dots_kernel  w1 = w - T(V^T h1), partials of
//                                         h2 = V w1
//             gs_reduce_kernel            h2
//             (c) gs_project_norm_kernel  w2 = w1 - T(V^T h2), partials of
//                                         |w2|^2
//             gs_reduce_kernel            |w2|^2
//   update  x + T(sum_{i < cols[b]} y_i Z_i)  (gs_update_kernel)
// V is (B, R, N) and w (B, N); Z (B, m, N), y (B, m), x (B, N); h (B, 2, R)
// holds h1 and h2, norms (B, 2) |w|^2 and |w2|^2.
//
// Types.  V, Z, w, x and y are stored in the field type T, as the JAX
// solver stores them; every product and sum is taken in the accumulation
// type Acc, and a projection is cast to T just before it is subtracted,
// where the JAX solver casts.  (T, Acc) is (float, double) (float fields,
// high_precision_reductions), (float, float) or (double, double).
// Products may be fused into multiply-adds, as cuBLAS's gemv fused them;
// the summation order is the kernels' own (below).
//
// Rows.  A cycle writes rows 0..j of V (j per pair, read on the card, so
// one CUDA graph serves every column); the column reads those rows and no
// other, and the update rows 0..cols-1 of Z.  A pair whose act flag is
// clear is skipped: its w1 and w2 are its w, its dots and norms 0.
//
// Sums.  A pass cuts a pair's N elements into C chunks of L (a multiple of
// 1024), one block of 256 threads a chunk (grid (C, B)).  A thread sums
// its elements n = chunk L + threadIdx.x + 256 k in order of k, the warps
// add their lanes by shuffles, thread i adds row i of the 8 warps in warp
// order and writes the block's partial; gs_reduce_kernel adds a pair's C
// partials, lane l taking chunks l, l + 32, ... in order, then the lanes by
// shuffles.  No atomics: every result is the same bits run to run,
// replayed from a graph or not.
//
// What bounds it: bytes.  A column reads rows 0..j three times, w twice
// and w1 once, and writes w1 and w2: for float storage 4 (3 (j + 1) + 5) N
// bytes a pair, where the float64 products on all of V that it replaces
// read 4 x 8 (m + 1) N.  Design:
// - A thread keeps a sum of each row in registers over its elements, so a
//   block writes one partial a row; through pass (b) it holds its
//   elements' values of every row (at one element a thread, float rows in
//   shared memory), so V is read once a pass.
// - A thread has about kRows loads in flight whatever j is: a block whose
//   pair uses at most a quarter of the kernel's rows takes 4 elements a
//   thread at a time, at most half 2, else 1 (the tiers below; each row's
//   loads predicated on j).  The row count kRows is a template parameter:
//   33 (restarts up to 32) or 65 (up to 64).
// - L is set per call (ops/cuda_kernels.py::gs_chunks) so that a launch
//   has many blocks an SM: at one pair the chunks fill the card, at 49
//   their tail is a few per cent of a launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
enum Mode { kColumn = 0, kUpdate = 1 };
enum Types { kFloatDouble = 0, kFloat = 1, kDouble = 2 };

// The row bounds of a kernel built for kRows rows at 4 and 2 elements a
// thread at a time.
template <int kRows>
struct Tiers {
  static constexpr int k4 = (kRows + 3) / 4, k2 = (kRows + 1) / 2;
};

template <typename Acc>
__device__ __forceinline__ Acc warp_sum(Acc v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows 0..j[b] of a pair's column, j clamped to the R rows there are.
__device__ __forceinline__ int column_rows(const long long* j, int b, int R) {
  const long long jb = j[b];
  return jb < 0 ? 1 : (jb >= R ? R : static_cast<int>(jb) + 1);
}

// Rows 0..cols[b]-1 of an update, cols clamped to the m rows there are.
__device__ __forceinline__ int update_rows(const long long* cols, int b, int m) {
  const long long cb = cols[b];
  return cb < 0 ? 0 : (cb > m ? m : static_cast<int>(cb));
}

// One past the last element of chunk `chunk`.
__device__ __forceinline__ long long chunk_end(int chunk, long long L, long long N) {
  const long long end = (static_cast<long long>(chunk) + 1) * L;
  return end < N ? end : N;
}

// out[i] = the block's sum of v[i], for i < rows; `red` holds kWarps x kR.
template <typename Acc, int kR>
__device__ __forceinline__ void block_sum_rows(const Acc (&v)[kR], int rows, Acc* red, Acc* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    if (i < rows) {
      const Acc s = warp_sum(v[i]);
      if (lane == 0) red[warp * kR + i] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    Acc s = red[threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w * kR + threadIdx.x];
    out[threadIdx.x] = s;
  }
}

// The block's sum of s, in thread 0; `red` holds kWarps values.
template <typename Acc>
__device__ __forceinline__ Acc block_sum(Acc s, Acc* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w];
  }
  return s;
}

// ---- (a) -------------------------------------------------------------------

template <typename T, typename Acc, int kR, int kU>
__device__ __forceinline__ void dots_body(const T* __restrict__ Vb, const T* __restrict__ wb,
                                          long long N, long long begin, long long end, int rows,
                                          Acc* red, Acc* part, Acc* norm_part) {
  Acc acc[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) acc[i] = 0;
  Acc nrm = 0;
  for (long long base = begin + threadIdx.x; base < end; base += kThreads * kU) {
    Acc wv[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long n = base + u * kThreads;
      wv[u] = n < end ? static_cast<Acc>(wb[n]) : Acc(0);
      nrm += wv[u] * wv[u];
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      if (i < rows) {
        const T* row = Vb + static_cast<size_t>(i) * N;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const long long n = base + u * kThreads;
          if (n < end) acc[i] += static_cast<Acc>(row[n]) * wv[u];
        }
      }
    }
  }
  block_sum_rows(acc, rows, red, part);
  __syncthreads();  // red is read above before block_sum writes it
  nrm = block_sum(nrm, red);
  if (threadIdx.x == 0) *norm_part = nrm;
}

// The partials of h1 = V w over the block's chunk into part (B, C, R), of
// |w|^2 into norm_part (B, 2, C) slot 0.
template <typename T, typename Acc, int kRows>
__global__ void __launch_bounds__(kThreads, 2)
    gs_dots_kernel(const T* __restrict__ V, const T* __restrict__ w,
                   const long long* __restrict__ j, const unsigned char* __restrict__ act,
                   Acc* __restrict__ part, Acc* __restrict__ norm_part, int R, long long N,
                   int C, long long L) {
  __shared__ Acc red[kWarps * kRows];
  const int b = blockIdx.y, chunk = blockIdx.x;
  if (!act[b]) return;
  const int rows = column_rows(j, b, R);
  const T* Vb = V + static_cast<size_t>(b) * R * N;
  const T* wb = w + static_cast<size_t>(b) * N;
  const long long begin = static_cast<long long>(chunk) * L, end = chunk_end(chunk, L, N);
  Acc* out = part + (static_cast<size_t>(b) * C + chunk) * R;
  Acc* nout = norm_part + static_cast<size_t>(b) * 2 * C + chunk;
  if (rows <= Tiers<kRows>::k4) {
    dots_body<T, Acc, Tiers<kRows>::k4, 4>(Vb, wb, N, begin, end, rows, red, out, nout);
  } else if (rows <= Tiers<kRows>::k2) {
    dots_body<T, Acc, Tiers<kRows>::k2, 2>(Vb, wb, N, begin, end, rows, red, out, nout);
  } else {
    dots_body<T, Acc, kRows, 1>(Vb, wb, N, begin, end, rows, red, out, nout);
  }
}

// ---- the sums of the partials --------------------------------------------

// With k >= 0, h[b][k][i] = the sum of a pair's C partials of row i in part
// (B, C, R), 0 past its rows or for an inactive pair; with norm >= 0,
// norms[b][norm] = the sum of norm_part (B, 2, C) slot norm.  One block a
// pair: warp w takes rows w, w + 8, ..., warp 0 the norm after them.
template <typename Acc>
__global__ void __launch_bounds__(kThreads)
    gs_reduce_kernel(const long long* __restrict__ j, const unsigned char* __restrict__ act,
                     const Acc* __restrict__ part, const Acc* __restrict__ norm_part,
                     Acc* __restrict__ h, Acc* __restrict__ norms, int k, int norm, int R,
                     int C) {
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool active = act[b] != 0;
  const int rows = active ? column_rows(j, b, R) : 0;
  if (k >= 0) {
    for (int i = warp; i < R; i += kWarps) {
      Acc s = 0;
      if (i < rows) {
        const Acc* p = part + static_cast<size_t>(b) * C * R + i;
        for (int c = lane; c < C; c += 32) s += p[static_cast<size_t>(c) * R];
      }
      s = warp_sum(s);
      if (lane == 0) h[(static_cast<size_t>(b) * 2 + k) * R + i] = s;
    }
  }
  if (norm >= 0 && warp == 0) {
    Acc s = 0;
    if (active) {
      const Acc* p = norm_part + (static_cast<size_t>(b) * 2 + norm) * C;
      for (int c = lane; c < C; c += 32) s += p[c];
    }
    s = warp_sum(s);
    if (lane == 0) norms[static_cast<size_t>(b) * 2 + norm] = s;
  }
}

// Row sums of a pair, h (B, 2, R) slot k, into shared memory; the loops
// read them through a volatile pointer, once an element, so that the
// compiler keeps them out of the registers.
template <typename Acc>
__device__ __forceinline__ void stage_rows(const Acc* __restrict__ h, int b, int k, int R,
                                           int rows, Acc* hs) {
  for (int i = threadIdx.x; i < rows; i += kThreads)
    hs[i] = h[(static_cast<size_t>(b) * 2 + k) * R + i];
  __syncthreads();
}

// A thread's kU elements n = base + 256 u of x and of rows < rows of V,
// every load issued before any is used (0 past the chunk).
template <typename T, int kR, int kU>
__device__ __forceinline__ void load_tile(const T* __restrict__ Vb, const T* xb, long long N,
                                          long long base, long long end, int rows, T (&x)[kU],
                                          T (&v)[kR][kU]) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const long long n = base + u * kThreads;
    x[u] = n < end ? xb[n] : T(0);
  }
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    if (i < rows) {
      const T* row = Vb + static_cast<size_t>(i) * N;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const long long n = base + u * kThreads;
        v[i][u] = n < end ? row[n] : T(0);
      }
    }
  }
}

// t[u] = sum_{i < rows} v[i][u] hs[i] in Acc, in order of i.
template <typename T, typename Acc, int kR, int kU>
__device__ __forceinline__ void project(const T (&v)[kR][kU], const volatile Acc* hs, int rows,
                                        Acc (&t)[kU]) {
#pragma unroll
  for (int u = 0; u < kU; ++u) t[u] = 0;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    if (i < rows) {
      const Acc hi = hs[i];
#pragma unroll
      for (int u = 0; u < kU; ++u) t[u] += static_cast<Acc>(v[i][u]) * hi;
    }
  }
}

// ---- (b) -------------------------------------------------------------------

template <typename T, typename Acc, int kR, int kU>
__device__ __forceinline__ void project_dots_body(const T* __restrict__ Vb,
                                                  const T* __restrict__ wb, T* __restrict__ ob,
                                                  const volatile Acc* hs, long long N,
                                                  long long begin, long long end, int rows,
                                                  Acc* red, Acc* part) {
  // At one element a thread, float rows go through shared memory between
  // the projection and the dots (read back through a volatile pointer),
  // so that the registers hold the sums and not the values as well.
  constexpr bool kStage = kU == 1 && sizeof(T) * kR * kThreads <= 40 * 1024;
  __shared__ T staged[kStage ? kR * kThreads : 1];
  volatile T* stage = staged + threadIdx.x;
  Acc acc[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) acc[i] = 0;
  for (long long base = begin + threadIdx.x; base < end; base += kThreads * kU) {
    T x[kU], v[kR][kU];
    load_tile<T, kR, kU>(Vb, wb, N, base, end, rows, x, v);
    if constexpr (kStage) {
#pragma unroll
      for (int i = 0; i < kR; ++i)
        if (i < rows) stage[i * kThreads] = v[i][0];
    }
    Acc t[kU];
    project<T, Acc, kR, kU>(v, hs, rows, t);
    Acc wa[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long n = base + u * kThreads;
      wa[u] = 0;
      if (n < end) {
        const T wn = x[u] - static_cast<T>(t[u]);
        ob[n] = wn;
        wa[u] = static_cast<Acc>(wn);
      }
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      if (i < rows) {
        if constexpr (kStage) {
          acc[i] += static_cast<Acc>(stage[i * kThreads]) * wa[0];
        } else {
#pragma unroll
          for (int u = 0; u < kU; ++u) acc[i] += static_cast<Acc>(v[i][u]) * wa[u];
        }
      }
    }
  }
  block_sum_rows(acc, rows, red, part);
}

// w1 = w - T(V^T h1) into w_out (h1 from h slot 0), the partials of h2 = V
// w1 into part.  An inactive pair's block copies its chunk of w.
template <typename T, typename Acc, int kRows>
__global__ void __launch_bounds__(kThreads, 2)
    gs_project_dots_kernel(const T* __restrict__ V, const T* __restrict__ w,
                           T* __restrict__ w_out, const long long* __restrict__ j,
                           const unsigned char* __restrict__ act, const Acc* __restrict__ h,
                           Acc* __restrict__ part, int R, long long N, int C, long long L) {
  __shared__ Acc hs[kRows];
  __shared__ Acc red[kWarps * kRows];
  const int b = blockIdx.y, chunk = blockIdx.x;
  const T* wb = w + static_cast<size_t>(b) * N;
  T* ob = w_out + static_cast<size_t>(b) * N;
  const long long begin = static_cast<long long>(chunk) * L, end = chunk_end(chunk, L, N);
  if (!act[b]) {
    for (long long n = begin + threadIdx.x; n < end; n += kThreads) ob[n] = wb[n];
    return;
  }
  const int rows = column_rows(j, b, R);
  stage_rows(h, b, 0, R, rows, hs);
  const T* Vb = V + static_cast<size_t>(b) * R * N;
  Acc* out = part + (static_cast<size_t>(b) * C + chunk) * R;
  if (rows <= Tiers<kRows>::k4) {
    project_dots_body<T, Acc, Tiers<kRows>::k4, 4>(Vb, wb, ob, hs, N, begin, end, rows, red,
                                                   out);
  } else if (rows <= Tiers<kRows>::k2) {
    project_dots_body<T, Acc, Tiers<kRows>::k2, 2>(Vb, wb, ob, hs, N, begin, end, rows, red,
                                                   out);
  } else {
    project_dots_body<T, Acc, kRows, 1>(Vb, wb, ob, hs, N, begin, end, rows, red, out);
  }
}

// ---- (c) and the update ----------------------------------------------------

// out[n] = in[n] - T(sum_i V_in hs_i) (kSubtract) or in[n] + T(sum_i hs_i
// V_in), over rows < rows of the block's chunk; returns the thread's sum of
// out^2 (kSubtract only).
template <typename T, typename Acc, int kR, int kU, bool kSubtract>
__device__ __forceinline__ Acc combine_body(const T* __restrict__ Vb, const T* in, T* out,
                                            const volatile Acc* hs, long long N,
                                            long long begin, long long end, int rows) {
  Acc nrm = 0;
  for (long long base = begin + threadIdx.x; base < end; base += kThreads * kU) {
    T x[kU], v[kR][kU];
    load_tile<T, kR, kU>(Vb, in, N, base, end, rows, x, v);
    Acc t[kU];
    project<T, Acc, kR, kU>(v, hs, rows, t);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long n = base + u * kThreads;
      if (n < end) {
        if (kSubtract) {
          const T wn = x[u] - static_cast<T>(t[u]);
          out[n] = wn;
          const Acc wa = static_cast<Acc>(wn);
          nrm += wa * wa;
        } else {
          out[n] = x[u] + static_cast<T>(t[u]);
        }
      }
    }
  }
  return nrm;
}

// w2 = w1 - T(V^T h2) in place (h2 from h slot 1), the partials of |w2|^2
// into norm_part slot 1.
template <typename T, typename Acc, int kRows>
__global__ void __launch_bounds__(kThreads, 2)
    gs_project_norm_kernel(const T* __restrict__ V, T* w, const long long* __restrict__ j,
                           const unsigned char* __restrict__ act, const Acc* __restrict__ h,
                           Acc* __restrict__ norm_part, int R, long long N, int C, long long L) {
  __shared__ Acc hs[kRows];
  __shared__ Acc red[kWarps];
  const int b = blockIdx.y, chunk = blockIdx.x;
  if (!act[b]) return;
  const int rows = column_rows(j, b, R);
  stage_rows(h, b, 1, R, rows, hs);
  const T* Vb = V + static_cast<size_t>(b) * R * N;
  T* wb = w + static_cast<size_t>(b) * N;
  const long long begin = static_cast<long long>(chunk) * L, end = chunk_end(chunk, L, N);
  Acc nrm;
  if (rows <= Tiers<kRows>::k4) {
    nrm = combine_body<T, Acc, Tiers<kRows>::k4, 4, true>(Vb, wb, wb, hs, N, begin, end, rows);
  } else if (rows <= Tiers<kRows>::k2) {
    nrm = combine_body<T, Acc, Tiers<kRows>::k2, 2, true>(Vb, wb, wb, hs, N, begin, end, rows);
  } else {
    nrm = combine_body<T, Acc, kRows, 1, true>(Vb, wb, wb, hs, N, begin, end, rows);
  }
  nrm = block_sum(nrm, red);
  if (threadIdx.x == 0) norm_part[(static_cast<size_t>(b) * 2 + 1) * C + chunk] = nrm;
}

// out = x + T(sum_{i < cols[b]} y_i Z_i) over the block's chunk; Z has m
// rows.
template <typename T, typename Acc, int kRows>
__global__ void __launch_bounds__(kThreads, 2)
    gs_update_kernel(const T* __restrict__ Z, const T* __restrict__ x, const T* __restrict__ y,
                     const long long* __restrict__ cols, T* __restrict__ out, int m,
                     long long N, long long L) {
  __shared__ Acc ys[kRows];
  const int b = blockIdx.y, chunk = blockIdx.x;
  const int rows = update_rows(cols, b, m);
  for (int i = threadIdx.x; i < rows; i += kThreads)
    ys[i] = static_cast<Acc>(y[static_cast<size_t>(b) * m + i]);
  __syncthreads();
  const T* Zb = Z + static_cast<size_t>(b) * m * N;
  const T* xb = x + static_cast<size_t>(b) * N;
  T* ob = out + static_cast<size_t>(b) * N;
  const long long begin = static_cast<long long>(chunk) * L, end = chunk_end(chunk, L, N);
  if (rows <= Tiers<kRows>::k4) {
    combine_body<T, Acc, Tiers<kRows>::k4, 4, false>(Zb, xb, ob, ys, N, begin, end, rows);
  } else if (rows <= Tiers<kRows>::k2) {
    combine_body<T, Acc, Tiers<kRows>::k2, 2, false>(Zb, xb, ob, ys, N, begin, end, rows);
  } else {
    combine_body<T, Acc, kRows, 1, false>(Zb, xb, ob, ys, N, begin, end, rows);
  }
}

template <typename T, typename Acc, int kRows>
int launch(int mode, const void* V, const void* w, void* w_out, const long long* j,
           const unsigned char* act, const void* y, void* work, void* h, void* norms, int B,
           int R, long long N, int C, long long L, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(C), static_cast<unsigned>(B));
  const T* Vt = static_cast<const T*>(V);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(w_out);
  if (mode == kUpdate) {
    gs_update_kernel<T, Acc, kRows><<<grid, kThreads, 0, s>>>(
        Vt, wt, static_cast<const T*>(y), j, ot, R, N, L);
    return static_cast<int>(cudaGetLastError());
  }
  Acc* part1 = static_cast<Acc*>(work);
  Acc* part2 = part1 + static_cast<size_t>(B) * C * R;
  Acc* norm_part = part2 + static_cast<size_t>(B) * C * R;
  Acc* ht = static_cast<Acc*>(h);
  Acc* nt = static_cast<Acc*>(norms);
  gs_dots_kernel<T, Acc, kRows><<<grid, kThreads, 0, s>>>(Vt, wt, j, act, part1, norm_part, R,
                                                          N, C, L);
  gs_reduce_kernel<Acc><<<B, kThreads, 0, s>>>(j, act, part1, norm_part, ht, nt, 0, 0, R, C);
  gs_project_dots_kernel<T, Acc, kRows><<<grid, kThreads, 0, s>>>(Vt, wt, ot, j, act, ht,
                                                                  part2, R, N, C, L);
  gs_reduce_kernel<Acc><<<B, kThreads, 0, s>>>(j, act, part2, nullptr, ht, nt, 1, -1, R, C);
  gs_project_norm_kernel<T, Acc, kRows><<<grid, kThreads, 0, s>>>(Vt, ot, j, act, ht,
                                                                  norm_part, R, N, C, L);
  gs_reduce_kernel<Acc><<<B, kThreads, 0, s>>>(j, act, nullptr, norm_part, ht, nt, -1, 1, R,
                                               C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Acc>
int launch_rows(int mode, const void* V, const void* w, void* w_out, const long long* j,
                const unsigned char* act, const void* y, void* work, void* h, void* norms, int B,
                int R, long long N, int C, long long L, cudaStream_t s) {
  if (R <= 33)
    return launch<T, Acc, 33>(mode, V, w, w_out, j, act, y, work, h, norms, B, R, N, C, L, s);
  if (R <= 65)
    return launch<T, Acc, 65>(mode, V, w, w_out, j, act, y, work, h, norms, B, R, N, C, L, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches kernel B7 in `mode` (0 column: V, w, w_out, j, act, work (Acc:
// 2 B C (R + 1)), h (B, 2, R), norms (B, 2); 1 update: V = Z (B, R = m, N),
// w = x, w_out, j = cols, y (B, m)) for `types` (0 float storage with
// double sums, 1 float, 2 double) on `stream`, and returns the CUDA error
// of the launches; the caller checks shapes, types and contiguity and
// picks the chunks (C of L elements, C L >= N, B <= 65,535).
extern "C" int krylov_gs(int mode, int types, const void* V, const void* w, void* w_out,
                         const long long* j, const unsigned char* act, const void* y,
                         void* work, void* h, void* norms, int B, int R, long long N, int C,
                         long long L, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (B == 0 || N == 0) return 0;
  if ((mode != kColumn && mode != kUpdate) || B > 65535 || C < 1 || R < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (types) {
    case kFloatDouble:
      return launch_rows<float, double>(mode, V, w, w_out, j, act, y, work, h, norms, B, R, N,
                                        C, L, s);
    case kFloat:
      return launch_rows<float, float>(mode, V, w, w_out, j, act, y, work, h, norms, B, R, N, C,
                                       L, s);
    case kDouble:
      return launch_rows<double, double>(mode, V, w, w_out, j, act, y, work, h, norms, B, R, N,
                                         C, L, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
