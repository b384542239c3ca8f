// K6 at 34 <= m <= kDetHiMaxM (48): minor_det_warp.cuh at register
// widths 40 and 48, two rows of M columns a lane, m taken at run time
// (the smallest width >= m).  Its own translation unit, so that nvcc
// compiles these instances beside the others.
#include "minor_det_warp.cuh"

namespace radic {

DET_WARP_WIDTHS(launch_minor_det_warp_hi, 40, kDetHiMaxM)

}  // namespace radic
