// K6 at 17 <= m <= 33: an instance of minor_det_warp.cuh for each m.
// Its own translation unit, so that nvcc compiles these instances beside
// the others.
#include "minor_det_warp.cuh"

namespace radic {

static std::atomic<bool> det_warp_opted[2][kWarpMaxM + 1][kMaxDevices];
// blocks of each instance an SM holds, by device (0: not asked yet)
static std::atomic<int> det_warp_fit[2][kWarpMaxM + 1][kMaxDevices];

template <typename T>
cudaError_t launch_warp_any(const T* mats, int B, int m, T* out,
                            cudaStream_t s) {
  constexpr int d = sizeof(T) == 8;
  switch (m) {
#define DET_WARP_CASE(MM)                                              \
  case MM:                                                             \
    return launch_warp_m<MM, true, T>(mats, B, MM, out,                \
                                      det_warp_opted[d][MM],           \
                                      det_warp_fit[d][MM], s);
    DET_WARP_CASE(17) DET_WARP_CASE(18) DET_WARP_CASE(19) DET_WARP_CASE(20)
    DET_WARP_CASE(21) DET_WARP_CASE(22) DET_WARP_CASE(23) DET_WARP_CASE(24)
    DET_WARP_CASE(25) DET_WARP_CASE(26) DET_WARP_CASE(27) DET_WARP_CASE(28)
    DET_WARP_CASE(29) DET_WARP_CASE(30) DET_WARP_CASE(31) DET_WARP_CASE(32)
    DET_WARP_CASE(33)
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
