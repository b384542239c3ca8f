// K3 (radic_grad.cu) for m = 14..16: its own translation unit, so that
// nvcc compiles it beside the others.
#include <cuda_runtime.h>

#include "radic_grad.cuh"

namespace radic {

cudaError_t launch_grad_wide(int m, int grid, int B, cudaStream_t stream,
                             const float* As, const float* cts, int n,
                             const int* table, int q_start, long long count,
                             float* partials) {
  switch (m) {
    case 14:
      return launch_grad<14>(grid, B, stream, As, cts, n, table, q_start,
                             count, partials);
    case 15:
      return launch_grad<15>(grid, B, stream, As, cts, n, table, q_start,
                             count, partials);
    case 16:
      return launch_grad<16>(grid, B, stream, As, cts, n, table, q_start,
                             count, partials);
  }
  return cudaErrorInvalidValue;
}

}  // namespace radic
