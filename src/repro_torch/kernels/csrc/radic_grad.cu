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
//   * one thread per rank, T(m) ranks per tile (grad_tile, radic_grad.cuh): the
//     rank is unranked once (common.cuh) and reused for every matrix of
//     the block's batch slice (gridDim.y slices B by kBatchChunk);
//   * cofactors in registers, never divided by det: when every pivot of
//     the partial-pivot LU is nonzero, cof = det(U) U^-1 L^-1 (up to the
//     row permutation and its sign), with det(U) U^-1 built column by
//     column from products of the other pivots.  When a pivot is exactly
//     zero (duplicate or zero columns, the queue's zero padding), the m^2
//     cofactors are computed directly as (m-1)x(m-1) determinants: right
//     at any rank (0, up to rounding, below rank m-1).  A matrix whose
//     cotangent is 0 (queue padding) contributes exactly 0 without any
//     arithmetic;
//   * a deterministic scatter, no float atomics: the tile's scaled
//     cofactors go to shared memory; then each thread owns entries (r, c)
//     of the block's (m, n) gradient and adds the tile's contributions in
//     rank order to its running partial partials[g][b][r][c] (a slice only
//     this block touches).  A second kernel adds the G partials of each
//     entry in order of g.  The tile T(m), the block count G (a function
//     of count, m and n) and both orders never depend on B or on a
//     matrix's slot, so a gradient is bit-identical alone, inside any
//     batch, and between the B = 1 and batched entries;
//   * shared memory: T(m) * (m^2 + m) * 4 bytes <= 48 KB, so the tile
//     shrinks from 256 ranks (m <= 6) to 32 (m >= 14); the partials
//     buffer holds G*B*m*n floats with G*m*n <= 131072 (the wrapper's
//     grad_grid_blocks), at most 512 KB per matrix: 32 MB at B = 64.
//   * m = 16 spills registers (the LU keeps an m x m array); accepted.
// The kernel lives in radic_grad.cuh; m = 14..16 are instantiated in
// radic_grad_wide.cu, so that nvcc compiles the two halves in parallel.
#include <cuda_runtime.h>

#include "radic_grad.cuh"

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

// Ranks per tile of the gradient kernel for m (0 outside 1..kMaxM).
int radic_grad_tile(int m) {
  using namespace radic;
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

// As: (B, m, n) float32 contiguous; cts: (B,) float32; table: (n+1, m+1)
// int32; partials: (grid, B, m, n) float32 scratch; out: (B, m, n)
// float32.  Launches both kernels on `stream` and returns the first CUDA
// error code (0 on success).
int radic_batched_grad_partial(const float* As, const float* cts, int B,
                               int m, int n, const int* table, int q_start,
                               long long count, float* partials, int grid,
                               float* out, void* stream) {
  using namespace radic;
  if (B < 1 || m < 1 || m > kMaxM || n < m || grid < 1 || count < 0)
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
    default:
      e = launch_grad_wide(m, grid, B, s, As, cts, n, table, q_start, count,
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
