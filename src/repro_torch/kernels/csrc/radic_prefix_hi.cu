// The prefix walk's launches for m = 26..27 (radic_prefix.cuh), a unit of
// their own so that no unit's compile holds up the build.
#include <cuda_runtime.h>

#include "radic_prefix.cuh"

namespace radic {

cudaError_t launch_prefix_walk_hi(int m, int grid, cudaStream_t s,
                                  const float* As, int B, int n,
                                  const int* table, int q_start,
                                  long long count, float* partials) {
  switch (m) {
#define PREFIX_CASE(MM)                                                     \
  case MM:                                                                  \
    return launch_prefix_walk_m<MM>(grid, s, As, B, n, table, q_start, count, \
                                    partials);
    PREFIX_CASE(26) PREFIX_CASE(27)
#undef PREFIX_CASE
  }
  return cudaErrorInvalidValue;
}

}  // namespace radic
