// Shared device functions of the Radic kernels.
//
// These replace the in-kernel routines of repro/kernels/common.py:
//   unrank_tile (common.py:62)           -> unrank_rank (one rank), and
//                                           successor (the next rank of a
//                                           run, from the previous one)
//   radic_signs (common.py:120)          -> radic_sign
//   onehot_gather_minors (common.py:108) -> gather_minor (by index: the
//                                           one-hot MXU contraction is a
//                                           TPU idiom)
//   batched_det_ge (common.py:17)        -> det_ge
// One thread owns one rank (or one run of consecutive ranks); each
// function works on that thread's lane.  `Stride` is the distance between
// a lane's combo entries in shared memory: the number of ranks per tile
// of the calling kernel.
//
// Whether K1 stages the block's batch slice of A and the Pascal table in
// shared memory is decided by (m, n) alone (staged(), below), and the
// tilings by the rank count and m alone, never by B, a matrix's batch
// slot or the device: staging moves no arithmetic, so every bit of a
// result is the same on every path that computes it.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace radic {

constexpr int kTile = 256;        // threads per block of K1, K2 and K4
constexpr int kRun = 8;           // consecutive ranks per thread of K1/K2/K4
constexpr int kBatchChunk = 16;   // matrices per block (gridDim.y slices B)
constexpr int kMaxM = 16;         // largest m the kernels are built for
// A matrix of at most this many floats (m * n) is staged in shared memory
// (64 KB for a slice of kBatchChunk matrices); every m >= 5 within the
// int32 rank space fits (16 x 5 x 193 x 4 B at most).
constexpr int kStageFloats = 1024;

__host__ __device__ constexpr bool staged(int m, int n) {
  return static_cast<long long>(m) * n <= kStageFloats;
}

// A load through the read-only data cache (`Ldg`, global memory only) or
// a plain load (shared memory, or a pointer to either).
template <bool Ldg, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (Ldg) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// The n-step combinatorial-addition walk of common.py:62-92 for one rank.
// Candidate values v = 1..n; position `pos` takes v iff q < C(n-v, M-1-pos).
// Writes the 0-indexed columns of the rank's m-subset to combo[i * Stride]
// (a column of a shared-memory array owned by this thread) and returns
// the 1-indexed column sum, which fixes the sign.  `table` is the
// (n+1, M+1) int32 Pascal table, row-major, read with load<Ldg>.  The
// walk stops once all M places are filled: the remaining steps of the
// reference's uniform walk change nothing for such a lane.
template <int M, int Stride = kTile, bool Ldg = true>
__device__ __forceinline__ int unrank_rank(int q, int n,
                                           const int* __restrict__ table,
                                           int* combo) {
  int pos = 0;
  int sum = 0;
  for (int v = 1; v <= n && pos < M; ++v) {
    const int cnt = load<Ldg>(&table[(n - v) * (M + 1) + (M - 1 - pos)]);
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

// The next m-subset in dictionary order (core.unrank.successor_py), on
// 0-indexed columns held in registers: bump the rightmost place below its
// cap n - M + i and reset the suffix to a consecutive run.  The caller
// never steps past the last member of its range.  Returns the new
// 1-indexed column sum.
template <int M>
__device__ __forceinline__ int successor(int (&c)[M], int n) {
  int at = 0;
#pragma unroll
  for (int i = 0; i < M; ++i)
    if (c[i] < n - M + i) at = i;
  int base = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) base = (i == at) ? c[i] : base;
  int sum = M;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    c[i] = (i >= at) ? base + 1 + (i - at) : c[i];
    sum += c[i];
  }
  return sum;
}

// (-1)^(r + s) with r = M(M+1)/2 and s the 1-indexed column sum.
template <int M>
__device__ __forceinline__ float radic_sign(int colsum) {
  return ((colsum + M * (M + 1) / 2) & 1) ? -1.0f : 1.0f;
}

// Transposed minor a[i][j] = A[j, c_i] of one (M, n) matrix A (row-major,
// float32, in shared or global memory), c_i the 0-indexed columns written
// by unrank_rank.
template <int M, int Stride = kTile>
__device__ __forceinline__ void gather_minor(const float* __restrict__ A,
                                             int n, const int* combo,
                                             float (&a)[M][M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int c = combo[i * Stride];
#pragma unroll
    for (int j = 0; j < M; ++j) a[i][j] = A[j * n + c];
  }
}

__device__ __forceinline__ float abs_of(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_of(double x) { return fabs(x); }
__device__ __forceinline__ float fma_of(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_of(double a, double b, double c) {
  return fma(a, b, c);
}

// x / d from inv = 1 / d: the product x * inv, corrected by one
// Newton step on its exact residual x - d * q (two fused multiply-adds in
// place of a division).  Where x / d is representable -- x = d, or any
// row that is an exact multiple of the pivot row -- the result is that
// quotient exactly, as a division gives it, so elimination still leaves
// an exact zero where the minor is exactly singular.
template <typename T>
__device__ __forceinline__ T quotient(T x, T d, T inv) {
  const T q = x * inv;
  return fma_of(fma_of(-q, d, x), inv, q);
}

// Determinant by Gaussian elimination with partial pivoting, as
// common.py:17-59 computes it: at step k the pivot is the FIRST row i >= k
// with the largest |a[i][k]| (strict '>' keeps the first of equal
// magnitudes, like jnp.argmax); a zero pivot divides by 1 instead, which
// leaves a zero on the diagonal, so a singular minor gives det 0, not NaN.
// One reciprocal per pivot, then a corrected product per row (quotient,
// not a division per row).  Every index is a compile-time constant, so `a` stays in
// registers; the row swap is done by predicated selects.  T is float or
// double.
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
    const T safe = (a[k][k] == T(0)) ? T(1) : a[k][k];
    const T inv = T(1) / safe;
#pragma unroll
    for (int i = k + 1; i < M; ++i) {
      const T f = quotient(a[i][k], safe, inv);
#pragma unroll
      for (int j = k + 1; j < M; ++j) a[i][j] -= f * a[k][j];
    }
  }
  T prod = T(1);
#pragma unroll
  for (int i = 0; i < M; ++i) prod *= a[i][i];
  return sign * prod;
}

// Copy `count` 4-byte words from global to shared memory without holding
// them in registers (cp.async, completed by copy_wait before a barrier).
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
#if defined(__CUDA_ARCH__)
    const unsigned d = static_cast<unsigned>(
        __cvta_generic_to_shared(static_cast<int*>(dst) + i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(static_cast<const int*>(src) + i));
#else
    static_cast<int*>(dst)[i] = static_cast<const int*>(src)[i];
#endif
  }
}

// One element from global to shared memory (cp.async, completed by
// copy_wait before a barrier).
template <typename T>
__device__ __forceinline__ void copy_async_elem(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  }
#else
  *dst = *src;
#endif
}

// Close the cp.async copies issued so far into one group (copy_wait
// completes every group).
__device__ __forceinline__ void copy_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
#endif
}

// Opt `kernel` in to `bytes` of dynamic shared memory on the current
// device, once per device, so that a launch after the first makes no
// attribute call: `done` is the kernel instance's row of a flag table that
// the launching translation unit keeps at namespace scope with `static`.
// (Not a function-local static of a template: the compiler exports those
// as symbols that the dynamic loader merges across every library of a
// process, so two builds of this library loaded side by side would share
// one flag, and the second would launch without its opt-in.)  A failed
// opt-in is tried again next time.
constexpr int kMaxDevices = 64;
using OptInFlags = std::atomic<bool>[kMaxM + 1][kMaxDevices];

template <typename Kernel>
cudaError_t opt_in_smem(std::atomic<bool> (&done)[kMaxDevices],
                        Kernel kernel, int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return e;
}

}  // namespace radic
