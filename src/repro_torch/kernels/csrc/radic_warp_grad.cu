// K3 at m = 17..33 (radic_warp_grad.cuh): the launches for m = 17..27,
// the dispatch to radic_warp_grad_hi.cu for 28..33, and the kernel's
// ranks per tile and shared memory for every m.
#include <cuda_runtime.h>

#include "radic_warp_grad.cuh"

namespace radic {

cudaError_t launch_grad_warp(int m, int grid, int B, cudaStream_t s,
                             const float* As, const float* cts, int n,
                             const int* table, int q_start, long long count,
                             float* partials) {
  if (n > 64) return cudaErrorInvalidValue;  // a rank's columns: 64 bits
  switch (m) {
#define GRAD_WARP_LAUNCH(MM)                                             \
  case MM:                                                               \
    return launch_grad_warp_m<MM>(grid, B, s, As, cts, n, table, q_start, \
                                  count, partials);
    GRAD_WARP_LAUNCH(17) GRAD_WARP_LAUNCH(18) GRAD_WARP_LAUNCH(19)
    GRAD_WARP_LAUNCH(20) GRAD_WARP_LAUNCH(21) GRAD_WARP_LAUNCH(22)
    GRAD_WARP_LAUNCH(23) GRAD_WARP_LAUNCH(24) GRAD_WARP_LAUNCH(25)
    GRAD_WARP_LAUNCH(26) GRAD_WARP_LAUNCH(27)
#undef GRAD_WARP_LAUNCH
  }
  return launch_grad_warp_hi(m, grid, B, s, As, cts, n, table, q_start,
                             count, partials);
}

int warp_grad_tile_of(int m) {
  switch (m) {
#define GRAD_WARP_TILE(MM) \
  case MM:                 \
    return warp_grad_tile<MM>();
    GRAD_WARP_TILE(17) GRAD_WARP_TILE(18) GRAD_WARP_TILE(19)
    GRAD_WARP_TILE(20) GRAD_WARP_TILE(21) GRAD_WARP_TILE(22)
    GRAD_WARP_TILE(23) GRAD_WARP_TILE(24) GRAD_WARP_TILE(25)
    GRAD_WARP_TILE(26) GRAD_WARP_TILE(27) GRAD_WARP_TILE(28)
    GRAD_WARP_TILE(29) GRAD_WARP_TILE(30) GRAD_WARP_TILE(31)
    GRAD_WARP_TILE(32) GRAD_WARP_TILE(33)
#undef GRAD_WARP_TILE
  }
  return 0;
}

int warp_grad_smem_bytes(int m) {
  const int W = warp_grad_tile_of(m);
  return W == 0 ? 0 : warp_grad_bytes(W, m);
}

}  // namespace radic
