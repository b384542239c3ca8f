// The prefix walk (radic_prefix.cuh): the dispatch rule by (m, n), the
// run length, the shared memory per block, and the launches for
// m = 17..25 (radic_prefix_hi.cu: 26..27).
#include <cuda_runtime.h>

#include "radic_prefix.cuh"

namespace radic {

// The smallest n - m at which the prefix walk takes (m, n); below it the
// warp kernel of radic_warp.cu.  From the H100's times of both kernels
// (kernel_ab.py prefix_edge and prefix_ranks, PERF.md): at n - m >= 6 the
// walk won at every measured shape, at B = 2 and at B = 64; at 5 it lost
// at B = 2 for every m >= 20 (a short range gives it few runs, each a
// serial chain), though it won at B = 64 from n - m = 3.  A function of
// (m, n) only, so a matrix takes the same kernel in any batch.
constexpr int kPrefixMinGap = 6;
// The widest m with an instance: n - m >= 6 at n <= 33 reaches no wider.
constexpr int kPrefixMaxM = 27;
// A warp's run: kPrefixRunMax consecutive ranks, halved (down to
// kPrefixRunMin) while a matrix would have fewer than kPrefixRunsWanted
// runs.  A restart costs m steps, so long runs; short ones where the
// range is short, so that its runs fill the card.
constexpr int kPrefixRunMax = 512;
constexpr int kPrefixRunMin = 32;
constexpr long long kPrefixRunsWanted = 2048;

bool prefix_walk(int m, int n) {
  return m > kMaxM && m <= kPrefixMaxM && n <= kWarpMaxM &&
         n - m >= kPrefixMinGap;
}

int prefix_run(long long count) {
  int r = kPrefixRunMax;
  while (r > kPrefixRunMin && count < r * kPrefixRunsWanted) r >>= 1;
  return r;
}

int prefix_smem_bytes(int m, int n) { return prefix_stage_bytes(m, n); }

cudaError_t launch_prefix_walk(int m, int grid, cudaStream_t s,
                               const float* As, int B, int n,
                               const int* table, int q_start, long long count,
                               float* partials) {
  switch (m) {
#define PREFIX_CASE(MM)                                                     \
  case MM:                                                                  \
    return launch_prefix_walk_m<MM>(grid, s, As, B, n, table, q_start, count, \
                                    partials);
    PREFIX_CASE(17) PREFIX_CASE(18) PREFIX_CASE(19) PREFIX_CASE(20)
    PREFIX_CASE(21) PREFIX_CASE(22) PREFIX_CASE(23) PREFIX_CASE(24)
    PREFIX_CASE(25)
#undef PREFIX_CASE
  }
  return launch_prefix_walk_hi(m, grid, s, As, B, n, table, q_start, count,
                               partials);
}

}  // namespace radic
