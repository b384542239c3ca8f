// The gradient kernel (K3) of radic_grad.cu, shared by the two
// translation units that instantiate it: radic_grad.cu for m <= 13 and
// radic_grad_wide.cu for m >= 14, compiled in parallel (the unrolled
// m x m arithmetic makes the large m slow to compile).
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace radic {


// Ranks per tile of the gradient kernel (== threads per block): the
// largest power of two <= 256 whose combos and cofactors fit 48 KB.
// The wrapper reads it through radic_grad_tile to size its block count.
template <int M>
constexpr int grad_tile() {
  int t = 256;
  while (t > 32 && t * (M * M + M) * 4 > 48 * 1024) t /= 2;
  return t;
}

// out[j * M + r] = w * cof(a)[j][r] for the transposed minor
// a[j][r] = A[r, c_j] of one (M, n) matrix A, c_j = combo[j * Stride];
// cof(a)[j][r] is d det / d A[r, c_j].
template <int M, int Stride>
__device__ __forceinline__ void scaled_cofactors(const float* __restrict__ A,
                                                 int n, const int* combo,
                                                 float w, float* out) {
  if (w == 0.0f) {
#pragma unroll
    for (int e = 0; e < M * M; ++e) out[e] = 0.0f;
    return;
  }
  if constexpr (M == 1) {
    out[0] = w;  // d a / d a
  } else {
    float a[M][M];
    gather_minor<M, Stride>(A, n, combo, a);
    int rid[M];  // original row of each physical row (the permutation)
#pragma unroll
    for (int i = 0; i < M; ++i) rid[i] = i;
    float sign = 1.0f;
    bool zero_pivot = false;
    // P a = L U with det_ge's pivot rule; multipliers kept below the
    // diagonal, so the swap moves whole rows
#pragma unroll
    for (int k = 0; k < M; ++k) {
      int p = k;
      float best = fabsf(a[k][k]);
#pragma unroll
      for (int i = k + 1; i < M; ++i) {
        const float v = fabsf(a[i][k]);
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
        for (int j = 0; j < M; ++j) {
          const float top = a[k][j];
          const float row = a[i][j];
          a[k][j] = sw ? row : top;
          a[i][j] = sw ? top : row;
        }
        const int rt = rid[k];
        const int rr = rid[i];
        rid[k] = sw ? rr : rt;
        rid[i] = sw ? rt : rr;
      }
      const float piv = a[k][k];
      zero_pivot = zero_pivot || (piv == 0.0f);
      const float safe = (piv == 0.0f) ? 1.0f : piv;
#pragma unroll
      for (int i = k + 1; i < M; ++i) {
        const float f = a[i][k] / safe;
        a[i][k] = f;
#pragma unroll
        for (int j = k + 1; j < M; ++j) a[i][j] -= f * a[k][j];
      }
    }
    if (zero_pivot) {
      // cof(a)[j][r] = (-1)^(j+r) det(a without row j and column r),
      // gathered again from A (it stays in L1/L2)
#pragma unroll 1
      for (int j = 0; j < M; ++j) {
#pragma unroll 1
        for (int r = 0; r < M; ++r) {
          float s[M - 1][M - 1];
#pragma unroll
          for (int jj = 0; jj < M - 1; ++jj) {
            const int c = combo[(jj + (jj >= j ? 1 : 0)) * Stride];
#pragma unroll
            for (int rr = 0; rr < M - 1; ++rr)
              s[jj][rr] = __ldg(&A[(rr + (rr >= r ? 1 : 0)) * n + c]);
          }
          const float d = det_ge<M - 1>(s);
          out[j * M + r] = ((j + r) & 1) ? -(w * d) : w * d;
        }
      }
      return;
    }
    // X = det(U) U^-1 over the upper triangle, in place, columns right to
    // left: X[c][c] = prod of the other pivots, X[r][c] = -(sum_{r<k<=c}
    // U[r][k] X[k][c]) / U[r][r]
    float d[M];
#pragma unroll
    for (int k = 0; k < M; ++k) d[k] = a[k][k];
#pragma unroll
    for (int c = M - 1; c >= 0; --c) {
      float x = 1.0f;
#pragma unroll
      for (int k = 0; k < M; ++k)
        if (k != c) x *= d[k];
      a[c][c] = x;
#pragma unroll
      for (int r = c - 1; r >= 0; --r) {
        float s = 0.0f;
#pragma unroll
        for (int k = r + 1; k <= c; ++k) s += a[r][k] * a[k][c];
        a[r][c] = -s / d[r];
      }
    }
    // Z = X L^-1 in place, columns right to left (L unit lower, its
    // multipliers still below the diagonal of a)
#pragma unroll
    for (int k = M - 2; k >= 0; --k) {
      float col[M];
#pragma unroll
      for (int i = 0; i < M; ++i) col[i] = (i <= k) ? a[i][k] : 0.0f;
#pragma unroll
      for (int j = k + 1; j < M; ++j) {
        const float l = a[j][k];
#pragma unroll
        for (int i = 0; i < M; ++i) col[i] -= a[i][j] * l;
      }
#pragma unroll
      for (int i = 0; i < M; ++i) a[i][k] = col[i];
    }
    // cof(P a) = Z^T and cof(a) = sign * P^T cof(P a): physical row i
    // is original row rid[i]
    const float ws = w * sign;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float* o = out + rid[i] * M;
#pragma unroll
      for (int r = 0; r < M; ++r) o[r] = ws * a[r][i];
    }
  }
}

template <int M, int T>
__global__ void __launch_bounds__(T)
    radic_grad_partial_kernel(const float* __restrict__ As,
                              const float* __restrict__ cts, int B, int n,
                              const int* __restrict__ table, int q_start,
                              long long count, long long num_tiles,
                              float* __restrict__ partials) {
  __shared__ int combo_s[M * T];
  __shared__ float cof_s[T * M * M];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.y * kBatchChunk;
  const int nb = min(kBatchChunk, B - b0);
  const int mn = M * n;
  // this block's (nb, M, n) slice of partials[g] (B, M, n)
  float* part =
      partials + (static_cast<size_t>(blockIdx.x) * B + b0) * mn;
  for (int e = tid; e < nb * mn; e += T) part[e] = 0.0f;

  for (long long t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const long long off = t * T + tid;
    const bool live = off < count;  // a masked lane is never read below
    const int len = static_cast<int>(min(static_cast<long long>(T),
                                         count - t * T));
    __syncthreads();  // the previous tile's owners are done with combo_s
    int colsum = 0;
    if (live)
      colsum = unrank_rank<M, T>(q_start + static_cast<int>(off), n, table,
                                 combo_s + tid);
    const float sign = radic_sign<M>(colsum);
    for (int bb = 0; bb < nb; ++bb) {
      const float* A = As + static_cast<size_t>(b0 + bb) * mn;
      if (live)
        scaled_cofactors<M, T>(A, n, combo_s + tid, cts[b0 + bb] * sign,
                               cof_s + tid * M * M);
      __syncthreads();
      // owners: entry e = r * n + c adds the tile's ranks in order
      float* pb = part + static_cast<size_t>(bb) * mn;
      for (int e = tid; e < mn; e += T) {
        const int r = e / n;
        const int c = e - r * n;
        float acc = 0.0f;
        for (int k = 0; k < len; ++k) {
          int j = -1;
#pragma unroll
          for (int p = 0; p < M; ++p) j = (combo_s[p * T + k] == c) ? p : j;
          if (j >= 0) acc += cof_s[(k * M + j) * M + r];
        }
        pb[e] += acc;
      }
      __syncthreads();  // owners are done with cof_s
    }
  }
}

template <int M>
cudaError_t launch_grad(int grid, int B, cudaStream_t stream,
                        const float* As, const float* cts, int n,
                        const int* table, int q_start, long long count,
                        float* partials) {
  constexpr int T = grad_tile<M>();
  const long long num_tiles = (count + T - 1) / T;
  const dim3 g(grid, (B + kBatchChunk - 1) / kBatchChunk);
  radic_grad_partial_kernel<M, T><<<g, T, 0, stream>>>(
      As, cts, B, n, table, q_start, count, num_tiles, partials);
  return cudaGetLastError();
}

// The launch for m in 14..16 (radic_grad_wide.cu).
cudaError_t launch_grad_wide(int m, int grid, int B, cudaStream_t stream,
                             const float* As, const float* cts, int n,
                             const int* table, int q_start, long long count,
                             float* partials);

}  // namespace radic
