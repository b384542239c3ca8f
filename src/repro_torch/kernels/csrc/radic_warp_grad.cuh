// Radic gradient partials at m = 17..33 (the wide path of K3): per
// matrix b of a stack As (B, m, n) and cotangent cts[b], out[b] =
// cts[b] * d/dA_b of the signed minor sum over ranks [q_start,
// q_start + count), the function of radic_grad.cu.
//
// Replaces, for the m the register kernel cannot hold,
// repro/kernels/radic_fused.py:201 radic_batched_grad_combo_kernel (K3).
//
// What bounds it: arithmetic (an LU, det(U) U^-1 and a product with L^-1
// per (rank, matrix), about 2m^3 flops, against m*n floats in and out).
// Design:
//   * a tile of W ranks (warp_grad_tile: 32, 16 or 8, so that the tile's
//     cofactors, W m^2 floats, take at most 48 KB); W threads unrank it
//     once for the block's batch slice, each rank's columns also kept as a
//     64-bit mask (n <= 33 at m >= 17, the int32 table's bound);
//   * one warp per (rank, matrix) computes the rank's scaled cofactor
//     matrix into the tile (warp_cofactors): warp_lu (warp.cuh) with K1's
//     pivot rule, keeping L; the warp writes L U and the permutation to
//     its own shared scratch, lane c builds column c of X = det(U) U^-1
//     from products of the other pivots (one reciprocal per row of U,
//     never a division by det), then lane r row r of Z = X L^-1, and
//     cof(a) = sign * P^T Z^T goes to the tile.  A minor with an exactly
//     zero pivot takes its m^2 (m-1)x(m-1) determinants instead (each a
//     warp_det), which is right at any rank; a zero cotangent writes
//     zeros without arithmetic;
//   * a deterministic scatter, no float atomics: thread (r, c) of the
//     m x n gradient adds, in rank order, the tile's entries that land on
//     column c (the ranks whose mask holds c, at position popc of the
//     mask below c) and adds that to its running partial in global memory
//     (partials[g][b], which only this block touches);
//     reduce_grad_partials_kernel (radic_grad.cu) adds the G partials in
//     order of g.  W, the block count G and both orders depend on the
//     rank range and the shape, never on B or a matrix's slot, so a
//     gradient is bit-identical alone, inside any batch, and between the
//     B = 1 and batched entries.
// The kernel lives here; radic_warp_grad.cu instantiates m = 17..27 and
// radic_warp_grad_hi.cu m = 28..33, so that nvcc compiles the two halves
// in parallel (each m's unrolled elimination is slow to compile).
#pragma once

#include <cuda_runtime.h>

#include "warp.cuh"

namespace radic {

constexpr int kGradWarps = 8;
constexpr int kGradWarpThreads = 32 * kGradWarps;

// Ranks per tile: 32, halved (to 8 at least) while the tile's cofactors
// exceed 48 KB.
template <int M>
__host__ __device__ constexpr int warp_grad_tile() {
  int t = 32;
  while (t > 8 && t * M * M * 4 > 48 * 1024) t /= 2;
  return t;
}

// Row stride of the warps' scratch: odd, so that lanes reading one
// column of different rows hit different banks.
__host__ __device__ constexpr int scratch_stride(int m) { return m | 1; }

// Dynamic shared memory of the kernel, in bytes: W rank masks, the tile's
// cofactors, each warp's L U and X (m rows of scratch_stride), W signs,
// each warp's permutation, the tile's combos.
__host__ __device__ constexpr int warp_grad_bytes(int W, int m) {
  return 8 * W +
         4 * (W * m * m + 2 * kGradWarps * m * scratch_stride(m) + W +
              kGradWarps * m + W * m);
}

// out[j * M + r] = w * cof(a)[j][r] for the transposed minor a[j][r] =
// A[r, c_j] of one (M, n) matrix A (global memory), c_j = combo[j]; run
// by one whole warp.  lu, xs: this warp's M x scratch_stride(M) scratch;
// perm: its M ints.
template <int M>
__device__ void warp_cofactors(const float* __restrict__ A, int n,
                               const int* combo, float w, float* out,
                               float* lu, float* xs, int* perm, int lane) {
  constexpr int R = warp_rows<M>();
  constexpr int S = scratch_stride(M);
  if (w == 0.0f) {
    for (int e = lane; e < M * M; e += 32) out[e] = 0.0f;
    return;
  }
  float a[R][M];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int i = warp_row(lane, s);
    const int c = i < M ? combo[i] : 0;
#pragma unroll
    for (int j = 0; j < M; ++j) a[s][j] = i < M ? A[j * n + c] : 0.0f;
  }
  int place[R];
  bool zero_pivot;
  float sign;
  warp_lu<M, true>(a, place, lane, zero_pivot, sign);
  if (zero_pivot) {
    // cof(a)[j][r] = (-1)^(j+r) det(a without row j and column r),
    // gathered again from A
    constexpr int R1 = warp_rows<M - 1>();
#pragma unroll 1
    for (int j = 0; j < M; ++j) {
#pragma unroll 1
      for (int r = 0; r < M; ++r) {
        float sub[R1][M - 1];
#pragma unroll
        for (int s = 0; s < R1; ++s) {
          const int i = warp_row(lane, s);
          const int c = i < M - 1 ? combo[i + (i >= j ? 1 : 0)] : 0;
#pragma unroll
          for (int k = 0; k < M - 1; ++k)
            sub[s][k] = i < M - 1 ? A[(k + (k >= r ? 1 : 0)) * n + c] : 0.0f;
        }
        const float d = warp_det<M - 1>(sub, lane);
        if (lane == 0) out[j * M + r] = ((j + r) & 1) ? -(w * d) : w * d;
      }
    }
    __syncwarp();
    return;
  }
  // P a = L U by place, and the original row of each place
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int i = warp_row(lane, s);
    if (i < M) {
#pragma unroll
      for (int j = 0; j < M; ++j) lu[place[s] * S + j] = a[s][j];
      perm[place[s]] = i;
    }
  }
  __syncwarp();
  // X = det(U) U^-1, lane c building column c bottom up: X[c][c] = the
  // product of the other pivots, X[r][c] = -(sum_{r<k<=c} U[r][k]
  // X[k][c]) / U[r][r] (r < c), 0 below the diagonal
  for (int c0 = 0; c0 < M; c0 += 32) {
    const int c = c0 + lane;
    const bool live = c < M;
    if (live) {
      float x = 1.0f;
#pragma unroll
      for (int k = 0; k < M; ++k)
        if (k != c) x *= lu[k * S + k];
      for (int r = 0; r < M; ++r) xs[r * S + c] = (r == c) ? x : 0.0f;
    }
    for (int r = M - 2; r >= 0; --r) {
      float acc = 0.0f;
      for (int k = r + 1; k < M; ++k)
        if (live && k <= c) acc += lu[r * S + k] * xs[k * S + c];
      if (live && r < c) xs[r * S + c] = -acc * (1.0f / lu[r * S + r]);
    }
  }
  __syncwarp();
  // Z = X L^-1 in place, lane r building row r right to left: Z[r][i] =
  // X[r][i] - sum_{j>i} Z[r][j] L[j][i]; then cof(a) = sign * P^T Z^T:
  // place i holds original row perm[i]
  const float ws = w * sign;
  for (int r0 = 0; r0 < M; r0 += 32) {
    const int r = r0 + lane;
    if (r < M) {
      float* z = xs + r * S;
      for (int i = M - 2; i >= 0; --i) {
        float v = z[i];
        for (int j = i + 1; j < M; ++j) v -= z[j] * lu[j * S + i];
        z[i] = v;
      }
      for (int i = 0; i < M; ++i) out[perm[i] * M + r] = ws * z[i];
    }
  }
  __syncwarp();  // the scratch is free for the warp's next rank
}

template <int M>
__global__ void __launch_bounds__(kGradWarpThreads)
    radic_grad_warp_kernel(const float* __restrict__ As,
                           const float* __restrict__ cts, int B, int n,
                           const int* __restrict__ table, int q_start,
                           long long count, long long num_tiles,
                           float* __restrict__ partials) {
  constexpr int W = warp_grad_tile<M>();
  constexpr int S = scratch_stride(M);
  extern __shared__ __align__(16) unsigned char smem[];
  auto* mask_s = reinterpret_cast<unsigned long long*>(smem);  // [W]
  float* cof_s = reinterpret_cast<float*>(mask_s + W);  // [W][j][r]
  float* lu_s = cof_s + W * M * M;                 // [warp][place][col]
  float* x_s = lu_s + kGradWarps * M * S;          // [warp][row][col]
  float* sign_s = x_s + kGradWarps * M * S;        // [W]
  int* perm_s = reinterpret_cast<int*>(sign_s + W);  // [warp][place]
  int* combo_s = perm_s + kGradWarps * M;          // [W][j]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.y * kBatchChunk;
  const int nb = min(kBatchChunk, B - b0);
  const int mn = M * n;
  // this block's (nb, M, n) slice of partials[g]: its running sums
  float* part = partials + (static_cast<size_t>(blockIdx.x) * B + b0) * mn;
  const float* A0 = As + static_cast<size_t>(b0) * mn;
  for (int e = tid; e < nb * mn; e += kGradWarpThreads) part[e] = 0.0f;

  for (long long t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    __syncthreads();  // the previous tile's owners are done
    if (tid < W) {
      const long long off = t * W + tid;
      unsigned long long mask = 0ull;
      float sign = 0.0f;
      if (off < count) {
        int* combo = combo_s + tid * M;
        const int colsum = unrank_rank<M, 1>(
            q_start + static_cast<int>(off), n, table, combo);
        for (int i = 0; i < M; ++i) mask |= 1ull << combo[i];
        sign = radic_sign<M>(colsum);
      }
      mask_s[tid] = mask;  // 0: a masked rank, never computed or added
      sign_s[tid] = sign;
    }
    __syncthreads();
    for (int bb = 0; bb < nb; ++bb) {
      if (bb > 0) __syncthreads();  // the owners are done with cof_s
      const float* A = A0 + static_cast<size_t>(bb) * mn;
      const float ct = cts[b0 + bb];
      for (int u = warp; u < W; u += kGradWarps)
        if (mask_s[u] != 0ull)
          warp_cofactors<M>(A, n, combo_s + u * M, ct * sign_s[u],
                            cof_s + u * M * M, lu_s + warp * M * S,
                            x_s + warp * M * S, perm_s + warp * M, lane);
      __syncthreads();
      // owners: entry (r, c) adds the tile's ranks that hold column c, in
      // rank order; neighbouring threads take neighbouring rows r
      float* pb = part + static_cast<size_t>(bb) * mn;
      for (int e = tid; e < mn; e += kGradWarpThreads) {
        const int c = e / M;
        const int r = e - c * M;
        const unsigned long long below = (1ull << c) - 1ull;
        float acc = 0.0f;
        for (int u = 0; u < W; ++u) {
          const unsigned long long mk = mask_s[u];
          if ((mk >> c) & 1ull)
            acc += cof_s[u * M * M + __popcll(mk & below) * M + r];
        }
        pb[r * n + c] += acc;
      }
    }
  }
}

// Which instances this translation unit has opted in, by m and device
// (each unit launches its own m: 17..27 or 28..33).
static std::atomic<bool> grad_warp_opted[kWarpMaxM + 1][kMaxDevices];

template <int M>
cudaError_t launch_grad_warp_m(int grid, int B, cudaStream_t stream,
                               const float* As, const float* cts, int n,
                               const int* table, int q_start,
                               long long count, float* partials) {
  constexpr int W = warp_grad_tile<M>();
  constexpr int bytes = warp_grad_bytes(W, M);
  static_assert(bytes <= 232448, "K3's shared memory exceeds 227 KB");
  const long long num_tiles = (count + W - 1) / W;
  const dim3 g(grid, (B + kBatchChunk - 1) / kBatchChunk);
  const cudaError_t e =
      opt_in_smem(grad_warp_opted[M], radic_grad_warp_kernel<M>, bytes);
  if (e != cudaSuccess) return e;
  radic_grad_warp_kernel<M><<<g, kGradWarpThreads, bytes, stream>>>(
      As, cts, B, n, table, q_start, count, num_tiles, partials);
  return cudaGetLastError();
}

// The launch for m in 28..33 (radic_warp_grad_hi.cu).
cudaError_t launch_grad_warp_hi(int m, int grid, int B, cudaStream_t s,
                                const float* As, const float* cts, int n,
                                const int* table, int q_start,
                                long long count, float* partials);

}  // namespace radic
