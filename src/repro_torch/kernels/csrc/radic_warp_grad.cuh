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
//     pivot rule, keeping L; each lane stores its row of U whole (128-bit
//     stores) and its multipliers by columns of L in the warp's own
//     shared scratch; lane c keeps column c of X = det(U) U^-1 in
//     registers, built from products of the other pivots (the LU's own
//     reciprocal of each row's pivot, never a division by det) and U's
//     rows read by broadcast 128-bit loads; X goes from columns to rows
//     through the scratch once, lane r keeps row r of Z = X L^-1 in
//     registers (L's columns by broadcast loads), and cof(a) = sign * P^T
//     Z^T goes to the tile.  A minor with an exactly zero pivot takes its
//     m^2 (m-1)x(m-1) determinants instead (each a warp_det), which is
//     right at any rank; a zero cotangent writes zeros without
//     arithmetic;
//   * a deterministic scatter, no float atomics: thread (r, c) of the
//     m x n gradient adds, in rank order, the tile's entries that land on
//     column c (the ranks whose mask holds c, at position popc of the
//     mask below c) and adds that to its running partial in global memory
//     (partials[g][b], which only this block touches);
//     reduce_grad_partials_kernel (radic_grad.cu) adds the G partials in
//     order of g.  G (grad_grid_blocks in the wrapper) allows 4 MB of
//     partials a matrix here against 512 KB on the register path: with
//     fewer blocks than the card holds at once, the warps' latency shows
//     (PERF.md).  W, the block count G and both orders depend on the
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

// Floats of one row of U or of L by columns in a warp's scratch: the
// 16-byte groups that cover m columns, so that a row is stored and read
// by 128-bit accesses.
__host__ __device__ constexpr int vec_row(int m) { return (m + 3) / 4 * 4; }

// Row stride of X's trip from columns to rows through the warp's
// scratch: odd, so that lanes reading one column of different rows hit
// different banks.
__host__ __device__ constexpr int scratch_stride(int m) { return m | 1; }

// Floats of a warp's U scratch: U by rows of vec_row(m), later X by rows
// of scratch_stride(m); a multiple of 4.
__host__ __device__ constexpr int u_floats(int m) {
  return (m * (vec_row(m) > scratch_stride(m) ? vec_row(m)
                                                : scratch_stride(m)) +
          3) / 4 * 4;
}

// Dynamic shared memory of the kernel, in bytes: W rank masks, the tile's
// cofactors, each warp's U (and X), L by columns (rows of vec_row(m))
// and permutation (vec_row(m) ints), W signs, the tile's combos.
__host__ __device__ constexpr int warp_grad_bytes(int W, int m) {
  return 8 * W +
         4 * (W * m * m +
              kGradWarps * (u_floats(m) + (m + 1) * vec_row(m)) + W +
              W * m);
}

// out[j * M + r] = w * cof(a)[j][r] for the transposed minor a[j][r] =
// A[r, c_j] of one (M, n) matrix A (global memory), c_j = combo[j]; run
// by one whole warp.  u: this warp's u_floats(M) floats of scratch; lt:
// its M x vec_row(M); perm: its vec_row(M) ints (all 16-byte
// aligned).
template <int M>
__device__ void warp_cofactors(const float* __restrict__ A, int n,
                               const int* combo, float w, float* out,
                               float* u, float* lt, int* perm, int lane) {
  constexpr int R = warp_rows<M>();
  constexpr int BR = vec_row(M);
  constexpr int G = BR / 4;
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
  float inv_of[R];  // 1 / U[r][r], kept by the lane of row r
  warp_lu<M, true>(a, place, lane, zero_pivot, sign, inv_of);  // P a = L U
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
  // U by rows (each lane stores its row whole, 128 bits at a time: the
  // columns left of the diagonal hold L's multipliers, never read), L by
  // columns (row i of lt holds L[j][i] at column j > i), and the original
  // row of each place
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int i = warp_row(lane, s);
    if (i < M) {
      auto col = [&](int j) { return j < M ? a[s][j < M ? j : 0] : 0.0f; };
#pragma unroll
      for (int g = 0; g < G; ++g)
        reinterpret_cast<float4*>(u + place[s] * BR)[g] = make_float4(
            col(4 * g), col(4 * g + 1), col(4 * g + 2), col(4 * g + 3));
#pragma unroll
      for (int j = 0; j < M - 1; ++j)
        if (j < place[s]) lt[j * BR + place[s]] = a[s][j];
      perm[place[s]] = i;
    }
  }
  __syncwarp();
  // X = det(U) U^-1 in registers, lane c keeping column c (slot s: c =
  // warp_row(lane, s)): X[c][c] = the product of the other pivots,
  // X[r][c] = -(sum_{r<k<=c} U[r][k] X[k][c]) / U[r][r] (r < c; the
  // LU's reciprocal of U[r][r], never a division by det), 0 below the
  // diagonal.  U's row r comes by broadcast 128-bit loads.
  float dg[R];
#pragma unroll
  for (int s = 0; s < R; ++s) dg[s] = 1.0f;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const float ukk = u[k * BR + k];
#pragma unroll
    for (int s = 0; s < R; ++s)
      dg[s] *= (k != warp_row(lane, s)) ? ukk : 1.0f;
  }
  float x[R][M];
#pragma unroll
  for (int r = M - 1; r >= 0; --r) {
    float ur[BR];
#pragma unroll
    for (int g = r / 4; g < G; ++g) {
      const float4 v = reinterpret_cast<const float4*>(u + r * BR)[g];
      ur[4 * g] = v.x;
      ur[4 * g + 1] = v.y;
      ur[4 * g + 2] = v.z;
      ur[4 * g + 3] = v.w;
    }
    // the LU's reciprocal of step r, from the lane of row r (unused at
    // r = M - 1)
    const float inv =
        r < M - 1 ? __shfl_sync(kFullMask, inv_of[r / 32], r & 31) : 0.0f;
#pragma unroll
    for (int s = 0; s < R; ++s) {
      float acc = 0.0f;  // X[k][c] = 0 for k > c adds nothing
#pragma unroll
      for (int k = r + 1; k < M; ++k) acc += ur[k] * x[s][k];
      const int c = warp_row(lane, s);
      x[s][r] = r < c ? -acc * inv : (r == c ? dg[s] : 0.0f);
    }
  }
  // X from columns to rows through the scratch (over U, which every lane
  // has read), then Z = X L^-1 in registers, lane r keeping row r and
  // building it right to left: Z[r][i] = X[r][i] - sum_{j>i} Z[r][j]
  // L[j][i], L's column i by broadcast 128-bit loads of row i of lt
  __syncwarp();
  float* xs = u;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int c = warp_row(lane, s);
    if (c < M) {
#pragma unroll
      for (int r = 0; r < M; ++r) xs[r * S + c] = x[s][r];
    }
  }
  __syncwarp();
  float z[R][M];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int r = warp_row(lane, s);
#pragma unroll
    for (int i = 0; i < M; ++i) z[s][i] = r < M ? xs[r * S + i] : 0.0f;
  }
#pragma unroll
  for (int i = M - 2; i >= 0; --i) {
    float lc[BR];
#pragma unroll
    for (int g = (i + 1) / 4; g < G; ++g) {
      const float4 v = reinterpret_cast<const float4*>(lt + i * BR)[g];
      lc[4 * g] = v.x;
      lc[4 * g + 1] = v.y;
      lc[4 * g + 2] = v.z;
      lc[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int s = 0; s < R; ++s) {
      float v = z[s][i];
#pragma unroll
      for (int j = i + 1; j < M; ++j) v -= z[s][j] * lc[j];
      z[s][i] = v;
    }
  }
  // cof(a) = sign * P^T Z^T: place i holds original row perm[i]
  const float ws = w * sign;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int4 pv = reinterpret_cast<const int4*>(perm)[g];
    const int pg[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i = 4 * g + t;
      if (i < M) {
#pragma unroll
        for (int s = 0; s < R; ++s) {
          const int r = warp_row(lane, s);
          if (r < M) out[pg[t] * M + r] = ws * z[s][i];
        }
      }
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
  constexpr int BR = vec_row(M);
  extern __shared__ __align__(16) unsigned char smem[];
  auto* mask_s = reinterpret_cast<unsigned long long*>(smem);  // [W]
  float* cof_s = reinterpret_cast<float*>(mask_s + W);  // [W][j][r]
  float* u_s = cof_s + W * M * M;                 // [warp][u_floats(M)]
  float* lt_s = u_s + kGradWarps * u_floats(M);   // [warp][col][row]
  int* perm_s = reinterpret_cast<int*>(lt_s + kGradWarps * M * BR);
  float* sign_s = reinterpret_cast<float*>(perm_s + kGradWarps * BR);  // [W]
  int* combo_s = reinterpret_cast<int*>(sign_s + W);  // [W][j]
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
                            cof_s + u * M * M, u_s + warp * u_floats(M),
                            lt_s + warp * M * BR, perm_s + warp * BR, lane);
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
