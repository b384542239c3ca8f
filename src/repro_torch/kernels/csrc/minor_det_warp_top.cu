// K6 at kDetHiMaxM < m <= kDetWarpMaxM (49..64): minor_det_warp.cuh at
// register widths 56 and 64, m taken at run time (the smallest width
// >= m).  In float64 these rows pass the registers and spill, and still
// beat the block kernel (kernel_ab.py k6_block, PERF.md).  Its own
// translation unit, so that nvcc compiles these instances beside the
// others.
#include "minor_det_warp.cuh"

namespace radic {

DET_WARP_WIDTHS(launch_minor_det_warp_top, 56, kDetWarpMaxM)

}  // namespace radic
