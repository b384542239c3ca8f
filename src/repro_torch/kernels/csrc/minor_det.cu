// Batched small determinants on Hopper: mats (B, m, m) -> (B,), by
// Gaussian elimination with partial pivoting (det_ge, common.cuh: strict
// '>' pivot rule, a zero pivot gives det 0).
//
// Replaces repro/kernels/minor_det.py:23 minor_det_kernel (K6), which
// computes in the input dtype: here float64 input computes in float64 and
// float32 in float32 (the wrapper brings narrower floats to float32).
//
// What bounds it: at m = 8, bytes and operations are close: each matrix
// is read once (4m^2 bytes in float32) and costs about 2m^3/3 flops.
// Design: one thread per matrix, the m x m matrix in registers (m is a
// template parameter, 1..16), the row swap by predicated selects; B is
// masked, not padded.  A thread reads its matrix with stride m^2, so the
// loads are not coalesced: a later PR can stage tiles through shared
// memory.
#include <cuda_runtime.h>

#include "common.cuh"

namespace radic {

template <int M, typename T>
__global__ void minor_det_kernel(const T* __restrict__ mats, int B,
                                 T* __restrict__ out) {
  const long long b = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (b >= B) return;
  const T* src = mats + b * (M * M);
  T a[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) a[i][j] = src[i * M + j];
  out[b] = det_ge<M>(a);
}

template <typename T>
cudaError_t launch_minor_det(const T* mats, int B, int m, T* out, int block,
                             cudaStream_t s) {
  const unsigned grid =
      static_cast<unsigned>((static_cast<long long>(B) + block - 1) / block);
  switch (m) {
#define MINOR_CASE(MM)                                                   \
  case MM:                                                               \
    minor_det_kernel<MM, T><<<grid, block, 0, s>>>(mats, B, out);        \
    break;
    MINOR_CASE(1) MINOR_CASE(2) MINOR_CASE(3) MINOR_CASE(4) MINOR_CASE(5)
    MINOR_CASE(6) MINOR_CASE(7) MINOR_CASE(8) MINOR_CASE(9) MINOR_CASE(10)
    MINOR_CASE(11) MINOR_CASE(12) MINOR_CASE(13) MINOR_CASE(14)
    MINOR_CASE(15) MINOR_CASE(16)
#undef MINOR_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace radic

extern "C" {

// mats: (B, m, m) contiguous, float32 (is_double = 0) or float64
// (is_double = 1); out: (B,) of the same type.  Returns the CUDA error
// code of the launch (0 on success).
int radic_minor_det(const void* mats, int B, int m, int is_double,
                    void* out, int block, void* stream) {
  using namespace radic;
  if (B < 1 || m < 1 || m > kMaxM || block < 1 || block > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_double ? launch_minor_det(static_cast<const double*>(mats), B, m,
                                   static_cast<double*>(out), block, s)
                : launch_minor_det(static_cast<const float*>(mats), B, m,
                                   static_cast<float*>(out), block, s);
  return static_cast<int>(e);
}

}  // extern "C"
