// Batched unranking on Hopper: int32 ranks qs (B,) -> 1-indexed
// m-subsets of {1..n} in dictionary order, (B, m) int32.
//
// Replaces repro/kernels/unrank_kernel.py:23 unrank_kernel (K5).
//
// What bounds it: bytes.  Each rank is read once (4 bytes) and its m
// entries written once (4m bytes); the walk is at most n integer
// compare/subtract steps against the (n+1, m+1) Pascal table.  Design:
// one thread per rank, the n-step walk of common.py:62-92 with m a
// runtime loop bound (no bound on m, as in the reference).  A position
// the walk does not fill (a rank outside [0, C(n, m))) stays 0, as in the
// reference's lane-uniform walk.
//   * staged (the table and the block's combos fit kUnrankStageBytes of
//     shared memory, as at every serving shape): the ranks are read
//     coalesced, the table is copied to shared memory once per block, each
//     thread writes its combo to a shared (tile, m) buffer whose rows are
//     m | 1 words apart (an odd stride: the lanes writing one position hit
//     32 different banks), and the block writes its (tile, m) output as
//     one contiguous span, neighbouring threads on neighbouring words;
//   * otherwise (a table or an m too large for that), each thread walks
//     the table through the read-only cache and writes its m entries to
//     global memory directly.
#include <cuda_runtime.h>

namespace radic {

constexpr int kUnrankStageBytes = 48 * 1024;

template <bool Staged>
__global__ void unrank_kernel(const int* __restrict__ qs, int B, int n,
                              int m, const int* __restrict__ table,
                              int* __restrict__ out) {
  extern __shared__ int sm[];
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * T;
  const int nb = static_cast<int>(
      min(static_cast<long long>(T), static_cast<long long>(B) - b0));
  const int stride = m | 1;          // a combo's row in the buffer
  const int tsize = (n + 1) * (m + 1);
  const int* tab = table;
  int* row = out + (b0 + tid) * static_cast<long long>(m);
  if constexpr (Staged) {
    for (int e = tid; e < tsize; e += T) sm[e] = table[e];
    tab = sm;
    row = sm + tsize + tid * stride;
    __syncthreads();
  }
  if (tid < nb) {
    int q = qs[b0 + tid];
    int pos = 0;
    for (int v = 1; v <= n && pos < m; ++v) {
      const int cnt = Staged ? tab[(n - v) * (m + 1) + (m - 1 - pos)]
                             : __ldg(&tab[(n - v) * (m + 1) + (m - 1 - pos)]);
      if (q < cnt) {
        row[pos] = v;
        ++pos;
      } else {
        q -= cnt;
      }
    }
    for (; pos < m; ++pos) row[pos] = 0;
  }
  if constexpr (Staged) {
    __syncthreads();
    // the block's span of nb * m words, element e = t m + p from row t,
    // position p of the buffer; (t, p) advance by (T / m, T % m)
    const int* buf = sm + tsize;
    int* dst = out + b0 * m;
    const int total = nb * m;
    const int dt = T / m;
    const int dp = T - dt * m;
    int t = tid / m;
    int p = tid - t * m;
    for (int e = tid; e < total; e += T) {
      dst[e] = buf[t * stride + p];
      t += dt;
      p += dp;
      if (p >= m) {
        p -= m;
        ++t;
      }
    }
  }
}

// Dynamic shared memory of the staged kernel for `block` threads, in
// bytes.
long long unrank_stage_bytes(int n, int m, int block) {
  return 4LL * ((static_cast<long long>(n) + 1) * (m + 1) +
                static_cast<long long>(block) * (m | 1));
}

}  // namespace radic

extern "C" {

// qs: (B,) int32; table: (n+1, m+1) int32; out: (B, m) int32.  Returns
// the CUDA error code of the launch (0 on success).
int radic_unrank(const int* qs, int B, int n, int m, const int* table,
                 int* out, int block, void* stream) {
  using namespace radic;
  if (B < 1 || m < 1 || n < 0 || block < 1 || block > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(
      (static_cast<long long>(B) + block - 1) / block);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long bytes = unrank_stage_bytes(n, m, block);
  if (bytes <= kUnrankStageBytes)
    unrank_kernel<true><<<grid, block, static_cast<int>(bytes), s>>>(
        qs, B, n, m, table, out);
  else
    unrank_kernel<false><<<grid, block, 0, s>>>(qs, B, n, m, table, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
