// K3 at m = 28..33 (radic_warp_grad.cuh): its own translation unit, so
// that nvcc compiles it beside radic_warp_grad.cu.
#include <cuda_runtime.h>

#include "radic_warp_grad.cuh"

namespace radic {

cudaError_t launch_grad_warp_hi(int m, int grid, int B, cudaStream_t s,
                                const float* As, const float* cts, int n,
                                const int* table, int q_start,
                                long long count, float* partials) {
  switch (m) {
#define GRAD_WARP_LAUNCH(MM)                                             \
  case MM:                                                               \
    return launch_grad_warp_m<MM>(grid, B, s, As, cts, n, table, q_start, \
                                  count, partials);
    GRAD_WARP_LAUNCH(28) GRAD_WARP_LAUNCH(29) GRAD_WARP_LAUNCH(30)
    GRAD_WARP_LAUNCH(31) GRAD_WARP_LAUNCH(32) GRAD_WARP_LAUNCH(33)
#undef GRAD_WARP_LAUNCH
  }
  return cudaErrorInvalidValue;
}

}  // namespace radic
