// Shared device functions of the Radic kernels.
//
// These replace the in-kernel routines of repro/kernels/common.py:
//   unrank_tile (common.py:62)           -> unrank_rank
//   radic_signs (common.py:120)          -> radic_sign
//   onehot_gather_minors (common.py:108) -> gather_minor (by index: the
//                                           one-hot MXU contraction is a
//                                           TPU idiom)
//   batched_det_ge (common.py:17)        -> det_ge
// One thread owns one rank; each function works on that thread's lane.
// `Stride` is the distance between a lane's combo entries in shared
// memory: the number of ranks per tile of the calling kernel.
#pragma once

#include <cstdint>

namespace radic {

constexpr int kTile = 256;        // ranks per tile == threads per block
constexpr int kBatchChunk = 16;   // matrices per block (gridDim.y slices B)
constexpr int kMaxM = 16;         // largest m the kernels are built for

// The n-step combinatorial-addition walk of common.py:62-92 for one rank.
// Candidate values v = 1..n; position `pos` takes v iff q < C(n-v, M-1-pos).
// Writes the 0-indexed columns of the rank's m-subset to combo[i * Stride]
// (a column of a shared-memory array owned by this thread) and returns
// the 1-indexed column sum, which fixes the sign.  `table` is the
// (n+1, M+1) int32 Pascal table, row-major.  The walk stops once all M
// places are filled: the remaining steps of the reference's uniform walk
// change nothing for such a lane.
template <int M, int Stride = kTile>
__device__ __forceinline__ int unrank_rank(int q, int n,
                                           const int* __restrict__ table,
                                           int* combo) {
  int pos = 0;
  int sum = 0;
  for (int v = 1; v <= n && pos < M; ++v) {
    const int cnt = __ldg(&table[(n - v) * (M + 1) + (M - 1 - pos)]);
    if (q < cnt) {
      combo[pos * Stride] = v - 1;
      sum += v;
      ++pos;
    } else {
      q -= cnt;
    }
  }
  return sum;
}

// (-1)^(r + s) with r = M(M+1)/2 and s the 1-indexed column sum.
template <int M>
__device__ __forceinline__ float radic_sign(int colsum) {
  return ((colsum + M * (M + 1) / 2) & 1) ? -1.0f : 1.0f;
}

// Transposed minor a[i][j] = A[j, c_i] of one (M, n) matrix A (row-major,
// float32), c_i the 0-indexed columns written by unrank_rank.
template <int M, int Stride = kTile>
__device__ __forceinline__ void gather_minor(const float* __restrict__ A,
                                             int n, const int* combo,
                                             float (&a)[M][M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int c = combo[i * Stride];
#pragma unroll
    for (int j = 0; j < M; ++j) a[i][j] = __ldg(&A[j * n + c]);
  }
}

__device__ __forceinline__ float abs_of(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_of(double x) { return fabs(x); }

// Determinant by Gaussian elimination with partial pivoting, as
// common.py:17-59 computes it: at step k the pivot is the FIRST row i >= k
// with the largest |a[i][k]| (strict '>' keeps the first of equal
// magnitudes, like jnp.argmax); a zero pivot divides by 1 instead, which
// leaves a zero on the diagonal, so a singular minor gives det 0, not NaN.
// Every index is a compile-time constant, so `a` stays in registers; the
// row swap is done by predicated selects.  T is float or double.
template <int M, typename T>
__device__ __forceinline__ T det_ge(T (&a)[M][M]) {
  T sign = T(1);
#pragma unroll
  for (int k = 0; k < M - 1; ++k) {
    int p = k;
    T best = abs_of(a[k][k]);
#pragma unroll
    for (int i = k + 1; i < M; ++i) {
      const T v = abs_of(a[i][k]);
      if (v > best) {
        best = v;
        p = i;
      }
    }
    if (p != k) sign = -sign;
#pragma unroll
    for (int i = k + 1; i < M; ++i) {
      const bool sw = (i == p);
#pragma unroll
      for (int j = k; j < M; ++j) {
        const T top = a[k][j];
        const T row = a[i][j];
        a[k][j] = sw ? row : top;
        a[i][j] = sw ? top : row;
      }
    }
    const T piv = a[k][k];
    const T safe = (piv == T(0)) ? T(1) : piv;
#pragma unroll
    for (int i = k + 1; i < M; ++i) {
      const T f = a[i][k] / safe;
#pragma unroll
      for (int j = k + 1; j < M; ++j) a[i][j] -= f * a[k][j];
    }
  }
  T prod = T(1);
#pragma unroll
  for (int i = 0; i < M; ++i) prod *= a[i][i];
  return sign * prod;
}

}  // namespace radic
