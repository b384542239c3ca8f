// K6 (minor_det.cu) at 17 <= m <= 32: one warp per matrix, lane i
// holding row i, det_ge's steps by warp_det (warp.cuh).  Its own
// translation unit, so that nvcc compiles these 32 instances beside the
// others.
#include <cuda_runtime.h>

#include "warp.cuh"

namespace radic {

constexpr int kDetWarps = 8;  // matrices (warps) per block

template <int M, typename T>
__global__ void __launch_bounds__(32 * kDetWarps)
    minor_det_warp_kernel(const T* __restrict__ mats, int B,
                          T* __restrict__ out) {
  const long long b =
      static_cast<long long>(blockIdx.x) * kDetWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp
  const int lane = threadIdx.x & 31;
  const T* src = mats + b * (M * M);
  T a[1][M];
#pragma unroll
  for (int j = 0; j < M; ++j) a[0][j] = lane < M ? src[lane * M + j] : T(0);
  const T d = warp_det<M>(a, lane);
  if (lane == 0) out[b] = d;
}

template <typename T>
cudaError_t launch_warp_any(const T* mats, int B, int m, T* out,
                            cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>(
      (static_cast<long long>(B) + kDetWarps - 1) / kDetWarps);
  switch (m) {
#define DET_WARP_CASE(MM)                                                   \
  case MM:                                                                  \
    minor_det_warp_kernel<MM, T><<<grid, 32 * kDetWarps, 0, s>>>(mats, B,   \
                                                                 out);      \
    return cudaGetLastError();
    DET_WARP_CASE(17) DET_WARP_CASE(18) DET_WARP_CASE(19) DET_WARP_CASE(20)
    DET_WARP_CASE(21) DET_WARP_CASE(22) DET_WARP_CASE(23) DET_WARP_CASE(24)
    DET_WARP_CASE(25) DET_WARP_CASE(26) DET_WARP_CASE(27) DET_WARP_CASE(28)
    DET_WARP_CASE(29) DET_WARP_CASE(30) DET_WARP_CASE(31) DET_WARP_CASE(32)
#undef DET_WARP_CASE
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_minor_det_warp(const float* mats, int B, int m,
                                  float* out, cudaStream_t s) {
  return launch_warp_any(mats, B, m, out, s);
}

cudaError_t launch_minor_det_warp(const double* mats, int B, int m,
                                  double* out, cudaStream_t s) {
  return launch_warp_any(mats, B, m, out, s);
}

}  // namespace radic
