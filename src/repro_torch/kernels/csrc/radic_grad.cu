// Radic gradient partials on Hopper: per matrix b of a stack As (B, m, n)
// and cotangent cts[b], out[b] = cts[b] * d/dA_b of the signed minor sum
// over ranks q in [q_start, q_start + count):
//   out[b][r][c] = sum over q with c = B_q[j] of cts[b] * sign(B_q) *
//                  cof(A_b[:, B_q])[r][j].
//
// Replaces repro/kernels/radic_fused.py:201 radic_batched_grad_combo_kernel
// (K3), which replays K1's tile and pulls the cotangents back through it
// with jax.vjp; here the pullback of each minor is its cofactor matrix,
// computed by hand.
//
// What bounds it: arithmetic.  The inputs are B*m*n floats, B cotangents
// and a small Pascal table, the output B*m*n floats; each (rank, matrix)
// pair costs an LU factorisation, det(U)*U^-1, a product with L^-1 and
// the m^2 scaled adds, about 2m^3 flops.  Design:
//   * one thread per rank, T(m) ranks per tile (grad_tile, radic_grad.cuh:
//     256 ranks at m <= 5 down to 32 at m >= 12, so that the tile's
//     cofactors take 32 KB): the rank is unranked once (common.cuh) and
//     reused for every matrix of the block's batch slice (gridDim.y slices
//     B by kBatchChunk);
//   * cofactors in registers, never divided by det: when every pivot of
//     the partial-pivot LU is nonzero, cof = det(U) U^-1 L^-1 (up to the
//     row permutation and its sign), with det(U) U^-1 built column by
//     column from products of the other pivots; one reciprocal per pivot
//     (the LU's multipliers as corrected products, quotient in
//     common.cuh) and per row of U, no division per entry.  When a pivot is exactly
//     zero (duplicate or zero columns, the queue's zero padding), the m^2
//     cofactors are computed directly as (m-1)x(m-1) determinants: right
//     at any rank (0, up to rounding, below rank m-1).  A matrix whose
//     cotangent is 0 (queue padding) contributes exactly 0 without any
//     arithmetic;
//   * a deterministic scatter through a per-tile column index, no float
//     atomics.  Once per tile, for all matrices of the slice, the block
//     builds an open-addressed table of the columns the tile holds (a
//     power of two >= min(n, T*m) slots, so a tile's work never grows
//     with n), each with a mask of the tile's ranks that hold it; the
//     lanes of a warp that share a column insert it once (__match_any).
//     A scan over the slots and prefix popcounts of the masks place every
//     (rank, position) in its column's list, in rank order (integer
//     atomics build the table; the lists do not depend on their order).
//     The tile's scaled cofactors go to shared memory, each row of T
//     ranks skewed by one word so that the owners' reads spread over the
//     banks; then each item (column, row) adds its column's list, in rank
//     order, to its running partial, kept in place in global memory
//     (partials[g][b], a slice only this block touches) and updated for
//     the tile's columns only; A and the Pascal table are read through
//     L1.  (Staging the slice of A and the table in shared memory, and
//     keeping the running partials there, measured within 0.6 % at
//     (3, 8, 31), 2.4 % faster at (3, 10, 24) and 1.7 % slower at
//     (3, 6, 30) on the H100: not kept.)  A second kernel adds the G
//     partials of each entry in order of g.  The tile T(m), the block count G (a function of count,
//     m and n), the index and both orders never depend on B or on a
//     matrix's slot, so a gradient is bit-identical alone, inside any
//     batch, and between the B = 1 and batched entries;
//   * shared memory: dynamic (grad_smem_words), opted in to the most any
//     shape of that m takes (grad_max_bytes) once per device; the
//     partials buffer holds G*B*m*n floats with G*m*n <= 131072 (the
//     wrapper's grad_grid_blocks), at most 512 KB per matrix: 32 MB at
//     B = 64.
//   * m >= 14 spills registers (the LU keeps an m x m array); accepted.
// The kernel lives in radic_grad.cuh; m = 14..16 are instantiated in
// radic_grad_wide.cu, so that nvcc compiles the two halves in parallel.
// m = 17..33 go to the warp kernel (radic_warp_grad.cuh): one warp per
// (rank, matrix), since a thread cannot hold an m x m minor there.
#include <cuda_runtime.h>

#include "radic_grad.cuh"
#include "warp.cuh"

namespace radic {

// out[b][e] = sum_{g < grid} partials[g][b][e], in order of g; total is
// B * m * n.
__global__ void reduce_grad_partials_kernel(const float* __restrict__ partials,
                                            int grid, long long total,
                                            float* __restrict__ out) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (e >= total) return;
  float s = 0.0f;
  for (int g = 0; g < grid; ++g)
    s += partials[static_cast<size_t>(g) * total + e];
  out[e] = s;
}

}  // namespace radic

extern "C" {

// Ranks per tile of the gradient kernel for m: the register kernel's
// for m <= kMaxM, the warp kernel's (radic_warp_grad.cuh) for m up to
// kWarpMaxM; 0 outside 1..kWarpMaxM.
int radic_grad_tile(int m) {
  using namespace radic;
  if (m > kMaxM) return warp_grad_tile_of(m);
  switch (m) {
#define GRAD_TILE_CASE(MM) \
  case MM:                 \
    return grad_tile<MM>();
    GRAD_TILE_CASE(1) GRAD_TILE_CASE(2) GRAD_TILE_CASE(3) GRAD_TILE_CASE(4)
    GRAD_TILE_CASE(5) GRAD_TILE_CASE(6) GRAD_TILE_CASE(7) GRAD_TILE_CASE(8)
    GRAD_TILE_CASE(9) GRAD_TILE_CASE(10) GRAD_TILE_CASE(11)
    GRAD_TILE_CASE(12) GRAD_TILE_CASE(13) GRAD_TILE_CASE(14)
    GRAD_TILE_CASE(15) GRAD_TILE_CASE(16)
#undef GRAD_TILE_CASE
  }
  return 0;
}

// Shared memory per block of the gradient kernel (static and dynamic)
// for a stack (B, m, n), in bytes, on the register or the warp path; 0
// outside 1 <= m <= kWarpMaxM.
int radic_grad_smem_bytes(int B, int m, int n) {
  using namespace radic;
  const int T = radic_grad_tile(m);
  if (T == 0 || B < 1 || n < m) return 0;
  if (m > kMaxM) return warp_grad_smem_bytes(m);
  return 4 * (grad_smem_words(T, m, n) + T / 32);
}

// As: (B, m, n) float32 contiguous; cts: (B,) float32; table: (n+1, m+1)
// int32; partials: (grid, B, m, n) float32 scratch; out: (B, m, n)
// float32.  Launches both kernels on `stream` and returns the first CUDA
// error code (0 on success).
int radic_batched_grad_partial(const float* As, const float* cts, int B,
                               int m, int n, const int* table, int q_start,
                               long long count, float* partials, int grid,
                               float* out, void* stream) {
  using namespace radic;
  if (B < 1 || m < 1 || m > kWarpMaxM || n < m || grid < 1 || count < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (m) {
#define GRAD_CASE(MM)                                                    \
  case MM:                                                               \
    e = launch_grad<MM>(grid, B, s, As, cts, n, table, q_start, count,   \
                        partials);                                       \
    break;
    GRAD_CASE(1) GRAD_CASE(2) GRAD_CASE(3) GRAD_CASE(4) GRAD_CASE(5)
    GRAD_CASE(6) GRAD_CASE(7) GRAD_CASE(8) GRAD_CASE(9) GRAD_CASE(10)
    GRAD_CASE(11) GRAD_CASE(12) GRAD_CASE(13)
#undef GRAD_CASE
    case 14:
    case 15:
    case 16:
      e = launch_grad_wide(m, grid, B, s, As, cts, n, table, q_start, count,
                           partials);
      break;
    default:  // 17..kWarpMaxM: one warp per (rank, matrix)
      e = launch_grad_warp(m, grid, B, s, As, cts, n, table, q_start, count,
                           partials);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long total = static_cast<long long>(B) * m * n;
  const long long blocks = (total + 255) / 256;
  reduce_grad_partials_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      partials, grid, total, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
