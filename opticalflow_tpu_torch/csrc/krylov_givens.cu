// FGMRES's Givens rotations and column bookkeeping for Hopper (sm_90a):
// kernel B8.
//
// It has no Pallas counterpart.  It replaces the loop that XLA compiles into
// one program in opticalflow_tpu/solve/krylov.py::fgmres (:398-437): the
// lax.fori_loop that applies the earlier Givens rotations to the new Arnoldi
// column, the new rotation, the Arnoldi breakdown guard and the
// R-conditioning guard, and the updates of R, the rotations, g and the
// residual estimate.  The port's plain version is
// ops/cuda_kernels.py::arnoldi_givens_ref, the same arithmetic as torch ops
// on (B,), (B, 2) and (B, m+1) tensors; this kernel runs one Arnoldi
// column's bookkeeping of every pair b in one launch:
//   h       = T(h1 + h2), summed in Acc (B7's two dots of the column)
//   w_entry, hj1 = T(sqrt(|w|^2)), T(sqrt(|w2|^2)), taken in Acc
//   col     = h with row j+1 := hj1
//   col     <- rotations i < j applied in order: (col_i, col_i+1) :=
//              (c_i col_i + s_i col_i+1, -s_i col_i + c_i col_i+1), c_i and
//              s_i as stored: rot0[i] = (c, -s), rot1[i] = (s, c)
//   c, s    = col_j / d, col_j+1 / d with d = sqrt(col_j^2 + col_j+1^2),
//             (1, 0) where d is not > 0; col_j := c col_j + s col_j+1,
//             col_j+1 := 0
//   R[:, j] := col, rotation j := (c, s), g_j+1 := -s g_j, g_j := c g_j,
//   est := |g_j+1|, rmax := max(rmax, |col_j|),
//   brk := hj1 <= T(3e-4) w_entry or |col_j| <= T(1e-5) rmax,
//   j := j + 1, act := j < m and est > tol and not brk and
//                      k_cycle + j < max_iterations,
// where act is set; a pair whose act is clear keeps its state.  For every
// pair it writes hj1, the rows the column's V and Z updates write (j1 =
// min(j+1, m), jz = min(j, m-1)) and act as it was, for the torch ops that
// divide w by hj1 and write those rows.
//
// Bits.  Every pair gets the plain version's bits: each product and sum is
// rounded on its own (built with -fmad=false: torch rounds a product before
// the add), sqrt and division are IEEE (nvcc's defaults), the sums of B7's
// dots and the two square roots are taken in Acc and cast to T, the guards'
// constants are rounded to T as torch rounds a Python scalar, est is
// compared with tol in Acc as torch promotes it, and max propagates NaN as
// torch.maximum does.
//
// What bounds it: latency.  A pair's work is a dependent chain of at most
// m - 1 rotations of two values, and it reads and writes under 1.5 KB
// (utils/cuda_timing.py::arnoldi_givens_work): at 49 pairs some 60 KB,
// 0.02 us of the card's memory rate, against a few microseconds of a
// launch.  Design: one warp a pair, four pairs a block; the warp loads the
// column's rows (h1 + h2) and the rotations below j into shared memory in
// parallel, one lane runs the chain and the new rotation with the carried
// value in a register (6 operations a rotation, the loads off the chain),
// and the warp stores the strided column of R.  Restarts up to 64 (the
// shared arrays), as B7.

#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int kPairs = 4;         // warps, one pair each, of a block
constexpr int kMaxRestart = 64;   // m, the rotations a pair stores
enum Types { kFloatDouble = 0, kFloat = 1, kDouble = 2 };

template <typename T>
__device__ __forceinline__ T tiny();
template <>
__device__ __forceinline__ float tiny<float>() { return FLT_MIN; }
template <>
__device__ __forceinline__ double tiny<double>() { return DBL_MIN; }

// IEEE square root and magnitude of each type, named so that no overload
// is left to resolve.
__device__ __forceinline__ float root(float v) { return sqrtf(v); }
__device__ __forceinline__ double root(double v) { return sqrt(v); }
__device__ __forceinline__ float magnitude(float v) { return fabsf(v); }
__device__ __forceinline__ double magnitude(double v) { return fabs(v); }

// torch.maximum: a NaN in either operand is the result.
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

template <typename T, typename Acc>
__global__ void __launch_bounds__(kPairs * 32)
arnoldi_givens_kernel(const Acc* __restrict__ hh, const Acc* __restrict__ norms,
                      const Acc* __restrict__ tol, T* __restrict__ R, T* __restrict__ rot0,
                      T* __restrict__ rot1, T* __restrict__ g, long long* __restrict__ j,
                      T* __restrict__ est, T* __restrict__ rmax, unsigned char* __restrict__ brk,
                      unsigned char* __restrict__ act, const int* __restrict__ k_cycle,
                      T* __restrict__ hj1_out, long long* __restrict__ j1_out,
                      long long* __restrict__ jz_out, unsigned char* __restrict__ was_out, int B,
                      int m, long long max_iterations) {
  __shared__ T cols[kPairs][kMaxRestart + 1];
  __shared__ T turns[kPairs][4 * kMaxRestart];  // c, -s, s, c of each rotation below j
  const int lane = threadIdx.x & 31, pair = threadIdx.x >> 5;
  const int b = blockIdx.x * kPairs + pair;
  if (b >= B) return;  // the whole warp
  const int rows = m + 1;
  const long long jb = j[b];
  const bool active = act[b] != 0;
  const T hj1 = static_cast<T>(root(norms[2 * static_cast<size_t>(b) + 1]));
  const long long j1 = jb + 1 < m ? jb + 1 : m, jz = jb < m - 1 ? jb : m - 1;
  if (lane == 0) {
    hj1_out[b] = hj1;
    j1_out[b] = j1;
    jz_out[b] = jz;
    was_out[b] = active;
  }
  if (!active) return;  // the whole warp: act is the pair's

  // the column, h with row j + 1 := hj1, and the rotations below j
  const int jj = static_cast<int>(jb), rotations = jj < m ? jj : m;
  const Acc* hb = hh + static_cast<size_t>(b) * 2 * rows;
  T* col = cols[pair];
  T* turn = turns[pair];
  for (int r = lane; r < rows; r += 32) {
    col[r] = r == jj + 1 ? hj1 : static_cast<T>(hb[r] + hb[rows + r]);
  }
  const T* r0 = rot0 + static_cast<size_t>(b) * m * 2;
  const T* r1 = rot1 + static_cast<size_t>(b) * m * 2;
  for (int k = lane; k < 2 * rotations; k += 32) {
    turn[2 * (k & ~1) + (k & 1)] = r0[k];
    turn[2 * (k & ~1) + 2 + (k & 1)] = r1[k];
  }
  __syncwarp();

  if (lane == 0) {
    // the earlier rotations, in order; x is col[i], carried
    T x = col[0];
    for (int i = 0; i < rotations; ++i) {
      const T y = col[i + 1];
      const T* t = turn + 4 * i;
      col[i] = t[0] * x + t[2] * y;
      x = t[1] * x + t[3] * y;
    }
    col[rotations] = x;

    // the new rotation, eliminating col[j1]
    const T a1 = col[jj], a2 = col[j1];
    const T denom = root(a1 * a1 + a2 * a2);
    const T safe = denom < tiny<T>() ? tiny<T>() : denom;
    const bool positive = denom > T(0);
    const T c = positive ? a1 / safe : T(1);
    const T s = positive ? a2 / safe : T(0);
    const T rdd = c * a1 + s * a2;
    col[jj] = rdd;
    col[j1] = T(0);

    T* rb0 = rot0 + (static_cast<size_t>(b) * m + jz) * 2;
    T* rb1 = rot1 + (static_cast<size_t>(b) * m + jz) * 2;
    rb0[0] = c;
    rb0[1] = -s;
    rb1[0] = s;
    rb1[1] = c;
    T* gb = g + static_cast<size_t>(b) * rows;
    const T gj = gb[jj];
    const T g_j1 = -s * gj;
    gb[jj] = c * gj;
    gb[j1] = g_j1;

    const T rmax_new = maximum(rmax[b], magnitude(rdd));
    const T w_entry = static_cast<T>(root(norms[2 * static_cast<size_t>(b)]));
    const bool brk_new = hj1 <= static_cast<T>(3e-4) * w_entry ||
                         magnitude(rdd) <= static_cast<T>(1e-5) * rmax_new;
    const T est_new = magnitude(g_j1);
    const long long j_new = jb + 1;
    est[b] = est_new;
    rmax[b] = rmax_new;
    brk[b] = brk_new;
    j[b] = j_new;
    act[b] = j_new < m && static_cast<Acc>(est_new) > tol[b] && !brk_new &&
             static_cast<long long>(k_cycle[b]) + j_new < max_iterations;
  }
  __syncwarp();

  // column jz of R, strided by m
  T* Rb = R + static_cast<size_t>(b) * rows * m + jz;
  for (int r = lane; r < rows; r += 32) Rb[static_cast<size_t>(r) * m] = col[r];
}

template <typename T, typename Acc>
int launch(const void* hh, const void* norms, const void* tol, void* R, void* rot0, void* rot1,
           void* g, long long* j, void* est, void* rmax, unsigned char* brk, unsigned char* act,
           const int* k_cycle, void* hj1, long long* j1, long long* jz, unsigned char* was,
           int B, int m, long long max_iterations, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((B + kPairs - 1) / kPairs);
  arnoldi_givens_kernel<T, Acc><<<blocks, kPairs * 32, 0, s>>>(
      static_cast<const Acc*>(hh), static_cast<const Acc*>(norms), static_cast<const Acc*>(tol),
      static_cast<T*>(R), static_cast<T*>(rot0), static_cast<T*>(rot1), static_cast<T*>(g), j,
      static_cast<T*>(est), static_cast<T*>(rmax), brk, act, k_cycle, static_cast<T*>(hj1), j1,
      jz, was, B, m, max_iterations);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches kernel B8 for `types` (0 float storage with double sums, 1
// float, 2 double) on `stream` over B pairs of restart m (1 <= m <= 64):
// hh (B, 2, m+1) and norms (B, 2), B7's dots and norms, and tol (B,) in
// the sum type; R (B, m+1, m), rot0 and rot1 (B, m, 2), g (B, m+1), est and
// rmax (B,) in the storage type; j (B,) int64, brk and act (B,) bool,
// k_cycle (B,) int32, updated in place; hj1 (B,), j1 and jz (B,) int64 and
// was (B,) bool written.  Returns the CUDA error of the launch; the caller
// checks shapes, types and contiguity.
extern "C" int krylov_givens(int types, const void* hh, const void* norms, const void* tol,
                             void* R, void* rot0, void* rot1, void* g, long long* j, void* est,
                             void* rmax, unsigned char* brk, unsigned char* act,
                             const int* k_cycle, void* hj1, long long* j1, long long* jz,
                             unsigned char* was, int B, int m, long long max_iterations,
                             void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (B < 0 || m < 1 || m > kMaxRestart) return static_cast<int>(cudaErrorInvalidValue);
  switch (types) {
    case kFloatDouble:
      return launch<float, double>(hh, norms, tol, R, rot0, rot1, g, j, est, rmax, brk, act,
                                   k_cycle, hj1, j1, jz, was, B, m, max_iterations, s);
    case kFloat:
      return launch<float, float>(hh, norms, tol, R, rot0, rot1, g, j, est, rmax, brk, act,
                                  k_cycle, hj1, j1, jz, was, B, m, max_iterations, s);
    case kDouble:
      return launch<double, double>(hh, norms, tol, R, rot0, rot1, g, j, est, rmax, brk, act,
                                    k_cycle, hj1, j1, jz, was, B, m, max_iterations, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
