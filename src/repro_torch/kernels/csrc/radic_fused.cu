// Radic partial sums on Hopper: per matrix b of a shape-uniform stack
// As (B, m, n), out[b] = sum over ranks q in [q_start, q_start + count) of
// sign(B_q) * det(A_b[:, B_q]).
//
// Replaces repro/kernels/radic_fused.py:156 radic_batched_combo_kernel
// (K1) and, launched at B = 1 through its own entry, radic_fused.py:39
// radic_fused_kernel (K2).
//
// What bounds it: arithmetic.  The inputs are B*m*n floats and a small
// Pascal table, the output B floats; each (rank, matrix) pair costs about
// 2m^3/3 flops of elimination, so the kernel is bound by float32 issue
// rate, never by memory.  Design:
//   * one thread per rank, 256 ranks per tile; a rank's subset is unranked
//     once (n-step walk, common.cuh) and reused for every matrix of the
//     block's batch slice, like the TPU kernel shares its tile across B;
//   * the minor is gathered by index from global memory (A stays in L1/L2)
//     into registers and eliminated there;
//   * no float atomics: a FIXED number of blocks (kMaxBlocks, or fewer for
//     short ranges) each walk tiles g, g+G, g+2G, ... in order; every
//     thread keeps a running sum per matrix, the block reduces it with a
//     fixed tree into partials[g][b], and a second kernel adds the G
//     partials of each matrix in order.  The tiling and both reduction
//     orders depend only on (count) -- never on B or on a matrix's slot --
//     so a matrix's result is bit-identical alone or inside any batch,
//     and between the B = 1 (K2) and batched (K1) entries.
//
// The same file holds K4, the by-grid twin: replaces radic_fused.py:92
// radic_batched_kernel, whose (B, tiles) grid unranks every tile again
// for each matrix.  Here gridDim.y = B, one matrix per block, and the
// rank walk, the per-thread running sum, the tree and the partials
// reduction are K1's, so K4 equals K1 bit for bit.  It pays the unranking
// B times; it exists as K1's reference, not for speed.
#include <cuda_runtime.h>

#include "common.cuh"

namespace radic {

template <int M>
__global__ void __launch_bounds__(kTile)
    radic_partial_kernel(const float* __restrict__ As, int B, int n,
                         const int* __restrict__ table, int q_start,
                         long long count, long long num_tiles,
                         float* __restrict__ partials) {
  __shared__ int combo_s[M * kTile];
  __shared__ float acc_s[kBatchChunk * kTile];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.y * kBatchChunk;
  const int nb = min(kBatchChunk, B - b0);
  int* combo = combo_s + tid;
  for (int bb = 0; bb < nb; ++bb) acc_s[bb * kTile + tid] = 0.0f;

  for (long long t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const long long off = t * kTile + tid;
    if (off >= count) continue;  // masked lane: adds nothing
    const int colsum =
        unrank_rank<M>(q_start + static_cast<int>(off), n, table, combo);
    const float sign = radic_sign<M>(colsum);
    for (int bb = 0; bb < nb; ++bb) {
      float a[M][M];
      gather_minor<M>(As + static_cast<size_t>(b0 + bb) * M * n, n, combo,
                      a);
      acc_s[bb * kTile + tid] += sign * det_ge<M>(a);
    }
  }
  __syncthreads();
  for (int s = kTile / 2; s > 0; s >>= 1) {
    if (tid < s) {
      for (int bb = 0; bb < nb; ++bb)
        acc_s[bb * kTile + tid] += acc_s[bb * kTile + tid + s];
    }
    __syncthreads();
  }
  if (tid < nb)
    partials[static_cast<size_t>(blockIdx.x) * B + b0 + tid] =
        acc_s[tid * kTile];
}

// K4: K1's walk for the one matrix b = blockIdx.y; the running sum and
// the tree are K1's, so partials[g][b] is K1's value bit for bit.
template <int M>
__global__ void __launch_bounds__(kTile)
    radic_bygrid_partial_kernel(const float* __restrict__ As, int B, int n,
                                const int* __restrict__ table, int q_start,
                                long long count, long long num_tiles,
                                float* __restrict__ partials) {
  __shared__ int combo_s[M * kTile];
  __shared__ float acc_s[kTile];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  int* combo = combo_s + tid;
  float acc = 0.0f;
  for (long long t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const long long off = t * kTile + tid;
    if (off >= count) continue;  // masked lane: adds nothing
    const int colsum =
        unrank_rank<M>(q_start + static_cast<int>(off), n, table, combo);
    const float sign = radic_sign<M>(colsum);
    float a[M][M];
    gather_minor<M>(As + static_cast<size_t>(b) * M * n, n, combo, a);
    acc += sign * det_ge<M>(a);
  }
  acc_s[tid] = acc;
  __syncthreads();
  for (int s = kTile / 2; s > 0; s >>= 1) {
    if (tid < s) acc_s[tid] += acc_s[tid + s];
    __syncthreads();
  }
  if (tid == 0)
    partials[static_cast<size_t>(blockIdx.x) * B + b] = acc_s[0];
}

// out[b] = sum_{g < grid} partials[g][b], in order of g.
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       int grid, int B,
                                       float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float s = 0.0f;
  for (int g = 0; g < grid; ++g) s += partials[static_cast<size_t>(g) * B + b];
  out[b] = s;
}

template <int M>
cudaError_t launch_partial(dim3 g, cudaStream_t stream, const float* As,
                           int B, int n, const int* table, int q_start,
                           long long count, long long num_tiles,
                           float* partials) {
  radic_partial_kernel<M><<<g, kTile, 0, stream>>>(
      As, B, n, table, q_start, count, num_tiles, partials);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_bygrid(dim3 g, cudaStream_t stream, const float* As,
                          int B, int n, const int* table, int q_start,
                          long long count, long long num_tiles,
                          float* partials) {
  radic_bygrid_partial_kernel<M><<<g, kTile, 0, stream>>>(
      As, B, n, table, q_start, count, num_tiles, partials);
  return cudaGetLastError();
}

}  // namespace radic

extern "C" {

// As: (B, m, n) float32 contiguous; table: (n+1, m+1) int32; partials:
// (grid, B) float32 scratch; out: (B,) float32.  Launches both kernels on
// `stream` and returns the first CUDA error code (0 on success).
int radic_batched_partial(const float* As, int B, int m, int n,
                          const int* table, int q_start, long long count,
                          float* partials, int grid, float* out,
                          void* stream) {
  using namespace radic;
  if (B < 1 || m < 1 || m > kMaxM || n < m || grid < 1 || count < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long num_tiles = (count + kTile - 1) / kTile;
  const dim3 g(grid, (B + kBatchChunk - 1) / kBatchChunk);
  cudaError_t e = cudaErrorInvalidValue;
  switch (m) {
#define RADIC_CASE(MM)                                                   \
  case MM:                                                               \
    e = launch_partial<MM>(g, s, As, B, n, table, q_start, count,        \
                           num_tiles, partials);                         \
    break;
    RADIC_CASE(1) RADIC_CASE(2) RADIC_CASE(3) RADIC_CASE(4)
    RADIC_CASE(5) RADIC_CASE(6) RADIC_CASE(7) RADIC_CASE(8)
    RADIC_CASE(9) RADIC_CASE(10) RADIC_CASE(11) RADIC_CASE(12)
    RADIC_CASE(13) RADIC_CASE(14) RADIC_CASE(15) RADIC_CASE(16)
#undef RADIC_CASE
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials_kernel<<<(B + 255) / 256, 256, 0, s>>>(partials, grid, B,
                                                          out);
  return static_cast<int>(cudaGetLastError());
}

// K4, the by-grid twin of radic_batched_partial: the same arguments and
// the same result bit for bit, on a (grid, B) grid.
int radic_bygrid_partial(const float* As, int B, int m, int n,
                         const int* table, int q_start, long long count,
                         float* partials, int grid, float* out,
                         void* stream) {
  using namespace radic;
  if (B < 1 || B > 65535 || m < 1 || m > kMaxM || n < m || grid < 1 ||
      count < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long num_tiles = (count + kTile - 1) / kTile;
  const dim3 g(grid, B);
  cudaError_t e = cudaErrorInvalidValue;
  switch (m) {
#define BYGRID_CASE(MM)                                                  \
  case MM:                                                               \
    e = launch_bygrid<MM>(g, s, As, B, n, table, q_start, count,         \
                          num_tiles, partials);                          \
    break;
    BYGRID_CASE(1) BYGRID_CASE(2) BYGRID_CASE(3) BYGRID_CASE(4)
    BYGRID_CASE(5) BYGRID_CASE(6) BYGRID_CASE(7) BYGRID_CASE(8)
    BYGRID_CASE(9) BYGRID_CASE(10) BYGRID_CASE(11) BYGRID_CASE(12)
    BYGRID_CASE(13) BYGRID_CASE(14) BYGRID_CASE(15) BYGRID_CASE(16)
#undef BYGRID_CASE
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials_kernel<<<(B + 255) / 256, 256, 0, s>>>(partials, grid, B,
                                                          out);
  return static_cast<int>(cudaGetLastError());
}

const char* radic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
