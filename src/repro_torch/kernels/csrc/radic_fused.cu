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
//   * a tile is kTile threads x kRun consecutive ranks; thread i of tile t
//     owns ranks t*kTile*kRun + i*kRun + [0, kRun).  It unranks the run's
//     first rank once (the n-step walk, common.cuh) and steps to each
//     next rank with the dictionary-order successor (common.cuh), its
//     combo in registers, so the walk's table loads are paid once per run
//     and not once per rank.  Each combo feeds every matrix of the block's
//     batch slice, like the TPU kernel shares its tile across B;
//   * where staged(m, n) holds (every m >= 5 within int32 ranks), the
//     block copies its batch slice of A and the Pascal table into shared
//     memory once (cp.async) and gathers each minor from there; otherwise
//     (m <= 4 with a wide n) the minor is gathered from global memory
//     through L1.  The minor is eliminated in registers with one
//     reciprocal per pivot (det_ge, common.cuh);
//   * no float atomics: a FIXED number of blocks G (grid_blocks in the
//     wrapper: a function of count alone) each walk tiles g, g+G, g+2G,
//     ... in order; every thread keeps a running sum per matrix over its
//     runs in rank order, the block reduces it with a fixed tree into
//     partials[g][b], and a second kernel adds the G partials of each
//     matrix in order of g.  The tiling, the runs and both reduction
//     orders depend only on count -- never on B, a matrix's slot or the
//     staging -- so a matrix's result is bit-identical alone or inside any
//     batch, and between the B = 1 (K2) and batched (K1) entries.
//
// m = 17..33 take the prefix walk of radic_prefix.cuh or the warp kernel
// of radic_warp.cu (by (m, n): prefix_walk) through the same entries
// (walk_and_reduce), with the same reduction.
//
// The same kernel is K4, the by-grid twin: replaces radic_fused.py:92
// radic_batched_kernel, whose (B, tiles) grid unranks every tile again
// for each matrix.  K4 launches it with one matrix per block on a (G, B)
// grid: the walk, the running sum, the tree and the partials reduction
// are K1's, so K4 equals K1 bit for bit.  It pays the unranking B times;
// it exists as K1's reference, not for speed.
#include <cuda_runtime.h>

#include "common.cuh"
#include "warp.cuh"

namespace radic {

// Dynamic shared memory of the staged kernel: the (n+1, m+1) table, then
// nb matrices of m*n floats.
__host__ __device__ constexpr int stage_bytes(int m, int n, int nb) {
  return 4 * ((n + 1) * (m + 1) + nb * m * n);
}
// Its largest value: m * n <= kStageFloats, so n <= kStageFloats / m.
constexpr int kMaxStageBytes =
    4 * (kStageFloats + kStageFloats + kMaxM + 1 + kBatchChunk * kStageFloats);

// Blocks per SM the compiler keeps registers for: 2 (128 registers) at
// m = 9..11, where the staged walk takes 156-254 registers uncapped and two
// blocks per SM measured 1.4-10 % faster on the H100 (kernel_ab.py),
// spills and all; 1 elsewhere (m <= 8 fits two blocks uncapped).
template <int M>
constexpr int walk_min_blocks() {
  return (M >= 9 && M <= 11) ? 2 : 1;
}

template <int M, bool Staged>
__global__ void __launch_bounds__(kTile, walk_min_blocks<M>())
    radic_partial_kernel(const float* __restrict__ As, int B, int n,
                         const int* __restrict__ table, int q_start,
                         long long count, long long num_tiles, int chunk,
                         float* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int combo_s[M * kTile];
  __shared__ float acc_s[kBatchChunk * kTile];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.y * chunk;
  const int nb = min(chunk, B - b0);
  const int mn = M * n;
  const int* tab = table;
  const float* A = As + static_cast<size_t>(b0) * mn;
  if constexpr (Staged) {
    int* tab_s = reinterpret_cast<int*>(smem);
    float* A_s = reinterpret_cast<float*>(tab_s + (n + 1) * (M + 1));
    copy_async(tab_s, table, (n + 1) * (M + 1));
    copy_async(A_s, A, nb * mn);
    copy_wait();
    tab = tab_s;
    A = A_s;
  }
  for (int bb = 0; bb < nb; ++bb) acc_s[bb * kTile + tid] = 0.0f;
  __syncthreads();

  for (long long t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const long long off = (t * kTile + tid) * kRun;
    if (off >= count) continue;  // masked lane: adds nothing
    const int len =
        static_cast<int>(min(static_cast<long long>(kRun), count - off));
    int colsum = unrank_rank<M, kTile, !Staged>(
        q_start + static_cast<int>(off), n, tab, combo_s + tid);
    int c[M];
#pragma unroll
    for (int i = 0; i < M; ++i) c[i] = combo_s[i * kTile + tid];
    for (int r = 0; r < len; ++r) {
      if (r > 0) colsum = successor<M>(c, n);
      const float sign = radic_sign<M>(colsum);
      for (int bb = 0; bb < nb; ++bb) {
        const float* Ab = A + bb * mn;
        float a[M][M];
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
          for (int j = 0; j < M; ++j)
            a[i][j] = load<!Staged>(&Ab[j * n + c[i]]);
        acc_s[bb * kTile + tid] += sign * det_ge<M>(a);
      }
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

// Which staged instances this library has opted in, by m and device.
static OptInFlags walk_opted;

// K1 (chunk = kBatchChunk matrices per block) and K4 (chunk = 1) on a
// (grid, ceil(B / chunk)) grid.
template <int M>
cudaError_t launch_walk(int grid, int chunk, cudaStream_t stream,
                        const float* As, int B, int n, const int* table,
                        int q_start, long long count, float* partials) {
  const long long num_tiles =
      (count + kTile * kRun - 1) / (kTile * kRun);
  const dim3 g(grid, (B + chunk - 1) / chunk);
  if (!staged(M, n)) {
    radic_partial_kernel<M, false><<<g, kTile, 0, stream>>>(
        As, B, n, table, q_start, count, num_tiles, chunk, partials);
    return cudaGetLastError();
  }
  // opt in to the most any staged launch can take, so that launches of
  // other sizes from other host threads never race on the attribute
  const cudaError_t e = opt_in_smem(walk_opted[M],
                                    radic_partial_kernel<M, true>,
                                    kMaxStageBytes);
  if (e != cudaSuccess) return e;
  const int bytes = stage_bytes(M, n, min(chunk, B));
  radic_partial_kernel<M, true><<<g, kTile, bytes, stream>>>(
      As, B, n, table, q_start, count, num_tiles, chunk, partials);
  return cudaGetLastError();
}

cudaError_t launch_walk_any(int m, int grid, int chunk, cudaStream_t s,
                            const float* As, int B, int n, const int* table,
                            int q_start, long long count, float* partials) {
  switch (m) {
#define RADIC_CASE(MM) \
  case MM:             \
    return launch_walk<MM>(grid, chunk, s, As, B, n, table, q_start, count, \
                           partials);
    RADIC_CASE(1) RADIC_CASE(2) RADIC_CASE(3) RADIC_CASE(4)
    RADIC_CASE(5) RADIC_CASE(6) RADIC_CASE(7) RADIC_CASE(8)
    RADIC_CASE(9) RADIC_CASE(10) RADIC_CASE(11) RADIC_CASE(12)
    RADIC_CASE(13) RADIC_CASE(14) RADIC_CASE(15) RADIC_CASE(16)
#undef RADIC_CASE
  }
  return cudaErrorInvalidValue;
}

int walk_and_reduce(int chunk, const float* As, int B, int m, int n,
                    const int* table, int q_start, long long count,
                    float* partials, int grid, float* out, void* stream) {
  if (B < 1 || m < 1 || m > kWarpMaxM || n < m || grid < 1 || count < 0 ||
      (B + chunk - 1) / chunk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // m <= 16: the register kernel above; 17..33: the prefix walk
  // (radic_prefix.cuh) where prefix_walk(m, n), else the warp kernel
  // (radic_warp.cu)
  const cudaError_t e =
      m <= kMaxM ? launch_walk_any(m, grid, chunk, s, As, B, n, table,
                                   q_start, count, partials)
      : prefix_walk(m, n)
          ? launch_prefix_walk(m, grid, s, As, B, n, table, q_start, count,
                               partials)
          : launch_warp_walk(m, grid, chunk, s, As, B, n, table, q_start,
                             count, partials);
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials_kernel<<<(B + 255) / 256, 256, 0, s>>>(partials, grid, B,
                                                          out);
  return static_cast<int>(cudaGetLastError());
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
  return radic::walk_and_reduce(radic::kBatchChunk, As, B, m, n, table,
                                q_start, count, partials, grid, out, stream);
}

// K4, the by-grid twin of radic_batched_partial: the same arguments and
// the same result bit for bit, on a (grid, B) grid.
int radic_bygrid_partial(const float* As, int B, int m, int n,
                         const int* table, int q_start, long long count,
                         float* partials, int grid, float* out,
                         void* stream) {
  return radic::walk_and_reduce(1, As, B, m, n, table, q_start, count,
                                partials, grid, out, stream);
}

// Shared memory per block of K1 (static and dynamic) for a stack
// (B, m, n), in bytes, on the register path (m <= kMaxM), the prefix walk
// or the warp kernel (m <= kWarpMaxM); 0 outside them.
int radic_partial_smem_bytes(int B, int m, int n) {
  using namespace radic;
  if (B < 1 || m < 1 || m > kWarpMaxM || n < m) return 0;
  if (m > kMaxM)
    return prefix_walk(m, n) ? prefix_smem_bytes(m, n)
                             : warp_partial_smem_bytes(B, m, n);
  const int fixed = 4 * (m * kTile + kBatchChunk * kTile);
  return fixed + (staged(m, n) ? stage_bytes(m, n, min(kBatchChunk, B)) : 0);
}

// The kernel K1, K2 and K4 launch for (m, n): 0 the register kernel,
// 1 the warp kernel (radic_warp.cu), 2 the prefix walk
// (radic_prefix.cuh); -1 outside them.
int radic_partial_route(int m, int n) {
  using namespace radic;
  if (m < 1 || m > kWarpMaxM || n < m) return -1;
  return m <= kMaxM ? 0 : prefix_walk(m, n) ? 2 : 1;
}

const char* radic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
