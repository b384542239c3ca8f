// Radic partial sums at m = 17..33 (the wide path of K1, K2 and K4, at
// the shapes walk_and_reduce does not route to the prefix walk of
// radic_prefix.cuh: n - m below its threshold, where consecutive ranks
// share little): per matrix b of a shape-uniform stack As (B, m, n),
// out[b] = sum over ranks q in [q_start, q_start + count) of
// sign(B_q) * det(A_b[:, B_q]).
//
// Replaces, for the m the register kernel (radic_fused.cu) cannot hold,
// repro/kernels/radic_fused.py:156 radic_batched_combo_kernel (K1), :39
// radic_fused_kernel (K2, the same kernel at B = 1) and :92
// radic_batched_kernel (K4, one matrix per block).
//
// What bounds it: its warp collectives, not arithmetic.  Each of a
// minor's m steps is a pivot search by two warp reductions and m - k
// pivot-row shuffles, a serial chain (kernel_ab.py wide_diag put 55 of
// its 161 ms at (3, 20, 30) in the search and 27 ms in the shuffles),
// while 32 - m lanes idle.  Design:
//   * one warp per (rank, matrix): lane i holds row i of the transposed
//     minor a[i][j] = A[j, c_i] and the elimination is warp_lu (warp.cuh):
//     a shuffle reduction finds the pivot, shuffles broadcast the pivot
//     row, rows exchange places instead of values;
//   * a tile is kWarps warps x kWarpRun consecutive ranks; warp w of tile
//     t owns ranks t*64 + w*8 + [0, 8): every lane walks the run's first
//     rank (warp_unrank) and the warp steps to each next rank with the
//     dictionary-order successor (warp_successor), so the combo costs one
//     walk a run; each combo feeds every matrix of the block's batch
//     slice;
//   * the block's batch slice of A and the Pascal table are staged in
//     shared memory (cp.async) for every shape: n <= 33 at m >= 17 (the
//     int32 table's bound), so a slice of 16 matrices takes at most 70 KB;
//   * no float atomics: a fixed number of blocks G (warp_grid_blocks in
//     the wrapper, a function of count alone) walk tiles g, g+G, ...; each
//     warp keeps a running sum per matrix over its runs in rank order, the
//     block adds its warps' sums in warp order into partials[g][b], and
//     reduce_partials_kernel (radic_fused.cu) adds the G partials of each
//     matrix in order of g.  Tiling, runs and both orders depend on count
//     only, so a matrix's result is bit-identical alone, in any batch
//     slot, and between K1, K2 (B = 1) and K4 (one matrix per block).
#include <cuda_runtime.h>

#include "warp.cuh"

namespace radic {

constexpr int kWarps = 8;                 // warps per block
constexpr int kWarpThreads = 32 * kWarps;
constexpr int kWarpRun = 8;               // consecutive ranks per warp

__host__ __device__ constexpr int warp_stage_bytes(int m, int n, int nb) {
  return 4 * ((n + 1) * (m + 1) + nb * m * n);
}
constexpr int kWarpMaxStageBytes =
    warp_stage_bytes(kWarpMaxM, kWarpMaxM, kBatchChunk);  // n <= 33

template <int M>
__global__ void __launch_bounds__(kWarpThreads)
    radic_warp_partial_kernel(const float* __restrict__ As, int B, int n,
                              const int* __restrict__ table, int q_start,
                              long long count, long long num_tiles, int chunk,
                              float* __restrict__ partials) {
  constexpr int R = warp_rows<M>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float acc_s[kBatchChunk][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.y * chunk;
  const int nb = min(chunk, B - b0);
  const int mn = M * n;
  int* tab_s = reinterpret_cast<int*>(smem);
  float* A_s = reinterpret_cast<float*>(tab_s + (n + 1) * (M + 1));
  copy_async(tab_s, table, (n + 1) * (M + 1));
  copy_async(A_s, As + static_cast<size_t>(b0) * mn, nb * mn);
  copy_wait();
  if (tid < kBatchChunk * kWarps) acc_s[tid / kWarps][tid % kWarps] = 0.0f;
  __syncthreads();

  for (long long t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const long long off = (t * kWarps + warp) * kWarpRun;
    if (off >= count) continue;  // a warp past the range adds nothing
    const int len =
        static_cast<int>(min(static_cast<long long>(kWarpRun), count - off));
    int c[R];
    int colsum =
        warp_unrank<M>(q_start + static_cast<int>(off), n, tab_s, c, lane);
    for (int r = 0; r < len; ++r) {
      if (r > 0) colsum = warp_successor<M>(c, n, lane);
      const float sign = radic_sign<M>(colsum);
      for (int bb = 0; bb < nb; ++bb) {
        const float* Ab = A_s + bb * mn;
        float a[R][M];
#pragma unroll
        for (int s = 0; s < R; ++s) {
          const bool row = warp_row(lane, s) < M;
#pragma unroll
          for (int j = 0; j < M; ++j) a[s][j] = row ? Ab[j * n + c[s]] : 0.0f;
        }
        const float d = warp_det<M>(a, lane);
        if (lane == 0) acc_s[bb][warp] += sign * d;
      }
    }
  }
  __syncthreads();
  if (tid < nb) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += acc_s[tid][w];
    partials[static_cast<size_t>(blockIdx.x) * B + b0 + tid] = s;
  }
}

// Which instances this library has opted in, by m and device.
static std::atomic<bool> warp_walk_opted[kWarpMaxM + 1][kMaxDevices];

template <int M>
cudaError_t launch_warp_walk_m(int grid, int chunk, cudaStream_t stream,
                               const float* As, int B, int n,
                               const int* table, int q_start,
                               long long count, float* partials) {
  const long long num_tiles =
      (count + kWarps * kWarpRun - 1) / (kWarps * kWarpRun);
  const dim3 g(grid, (B + chunk - 1) / chunk);
  const cudaError_t e = opt_in_smem(warp_walk_opted[M],
                                    radic_warp_partial_kernel<M>,
                                    kWarpMaxStageBytes);
  if (e != cudaSuccess) return e;
  const int bytes = warp_stage_bytes(M, n, min(chunk, B));
  radic_warp_partial_kernel<M><<<g, kWarpThreads, bytes, stream>>>(
      As, B, n, table, q_start, count, num_tiles, chunk, partials);
  return cudaGetLastError();
}

// The wide walk for 17 <= m <= 33 (called by
// radic_fused.cu's walk_and_reduce, which adds the reduction).
cudaError_t launch_warp_walk(int m, int grid, int chunk, cudaStream_t s,
                             const float* As, int B, int n, const int* table,
                             int q_start, long long count, float* partials) {
  switch (m) {
#define WARP_CASE(MM)                                                      \
  case MM:                                                                 \
    return launch_warp_walk_m<MM>(grid, chunk, s, As, B, n, table, q_start, \
                                  count, partials);
    WARP_CASE(17) WARP_CASE(18) WARP_CASE(19) WARP_CASE(20) WARP_CASE(21)
    WARP_CASE(22) WARP_CASE(23) WARP_CASE(24) WARP_CASE(25) WARP_CASE(26)
    WARP_CASE(27) WARP_CASE(28) WARP_CASE(29) WARP_CASE(30) WARP_CASE(31)
    WARP_CASE(32) WARP_CASE(33)
#undef WARP_CASE
  }
  return cudaErrorInvalidValue;
}

// Shared memory per block of the wide walk (static and dynamic).
int warp_partial_smem_bytes(int B, int m, int n) {
  return 4 * kBatchChunk * kWarps +
         warp_stage_bytes(m, n, min(kBatchChunk, B));
}

}  // namespace radic
