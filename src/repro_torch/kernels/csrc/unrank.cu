// Batched unranking on Hopper: int32 ranks qs (B,) -> 1-indexed
// m-subsets of {1..n} in dictionary order, (B, m) int32.
//
// Replaces repro/kernels/unrank_kernel.py:23 unrank_kernel (K5).
//
// What bounds it: bytes.  Each rank is read once (4 bytes) and its m
// entries written once (4m bytes); the walk is at most n integer
// compare/subtract steps against the (n+1, m+1) Pascal table, which stays
// in L1.  Design: one thread per rank, the n-step walk of common.py:62-92
// with m a runtime loop bound (no bound on m, as in the reference).  A
// position the walk does not fill (a rank outside [0, C(n, m))) stays 0,
// as in the reference's lane-uniform walk.
#include <cuda_runtime.h>

namespace radic {

__global__ void unrank_kernel(const int* __restrict__ qs, int B, int n,
                              int m, const int* __restrict__ table,
                              int* __restrict__ out) {
  const long long b = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (b >= B) return;
  int q = qs[b];
  int* o = out + b * static_cast<long long>(m);
  int pos = 0;
  for (int v = 1; v <= n && pos < m; ++v) {
    const int cnt = __ldg(&table[(n - v) * (m + 1) + (m - 1 - pos)]);
    if (q < cnt) {
      o[pos] = v;
      ++pos;
    } else {
      q -= cnt;
    }
  }
  for (; pos < m; ++pos) o[pos] = 0;
}

}  // namespace radic

extern "C" {

// qs: (B,) int32; table: (n+1, m+1) int32; out: (B, m) int32.  Returns
// the CUDA error code of the launch (0 on success).
int radic_unrank(const int* qs, int B, int n, int m, const int* table,
                 int* out, int block, void* stream) {
  if (B < 1 || m < 1 || n < 0 || block < 1 || block > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (static_cast<long long>(B) + block - 1) / block;
  radic::unrank_kernel<<<static_cast<unsigned>(grid), block, 0,
                         static_cast<cudaStream_t>(stream)>>>(qs, B, n, m,
                                                              table, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
