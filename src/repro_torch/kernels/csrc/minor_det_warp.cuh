// K6 (minor_det.cu) at 17 <= m <= 64: one warp per matrix, lane i
// holding row i (and row i + 32 at m > 32), det_ge's steps as warp_lu
// takes them (warp.cuh), the pivot row by a shuffle a column.
// Instances: minor_det_warp.cu (m = 17..33, one a value of m) and
// minor_det_warp_hi.cu with minor_det_warp_top.cu (m = 34..64, a few
// register widths, m taken at run time).
//
// What bounds it: bytes.  A matrix is 4 m^2 bytes in float32 (268 MB at
// (65536, 32, 32): 0.080 ms at 3.35 TB/s) for about 2 m^3 / 3 flops,
// well under the card's float32 rate.  Read directly, each lane its row
// from global memory word by word, the kernel reached 18 % of that bound
// at m = 32 (a load instruction's lanes on as many 128-byte lines as
// lanes), with nothing overlapping the loads and the elimination.  Where
// that costs (det_staged, by m and type), it stages instead:
//   * coalesced, asynchronous loads: each warp copies its next matrix
//     into its own buffer in shared memory with cp.async, row by row
//     (neighbouring lanes, neighbouring words), while it eliminates the
//     current one: the current matrix's rows, read from the buffer into
//     registers, are the second stage;
//   * the buffer's rows sit at an odd stride (m | 1 words), so that lane
//     i reading row i hits a bank no other lane hits;
//   * persistent warps: the grid is the SMs times the blocks an SM
//     holds, each warp walking the stack at a stride of the grid's warps.
// Elsewhere it reads directly.  Float64's pivot search takes three
// redux in place of a butterfly of 15 shuffles (warp_pivot_search).
// Rows past m (two rows a lane) take no part.  The search, the
// multipliers and every entry's update take the same operands in the
// same order as warp_lu, so the determinant is bit for bit warp_det's
// (and the block kernel's).
#pragma once

#include <cuda_runtime.h>

#include "warp.cuh"

namespace radic {

constexpr int kDetWarps = 8;  // warps per block

// Whether a warp stages its matrices in shared memory, each copied
// behind the elimination of the one before on persistent warps (else
// each lane reads its row from global memory word by word, one matrix a
// warp): the faster in kernel_ab.py k6_wide_moves (PERF.md).  Staging
// pays at one row a lane where a row's bytes are a multiple of 128
// (m = 32 in both types), where every lane's load falls at the same place
// of its own 128-byte line; elsewhere reading directly is as fast or
// faster (by up to 19 % in float64).
template <int M, typename T>
__host__ __device__ constexpr bool det_staged() {
  return M <= 32 && M * sizeof(T) % 128 == 0;
}

// A warp's buffer, in elements of T: rows at the odd stride M | 1, so
// that lane i reading row i hits a bank no other lane hits.
template <int M, typename T>
__host__ __device__ constexpr int det_buf_len() {
  return det_staged<M, T>() ? M * (M | 1) : 0;
}

// Each lane's rows (row lane + 32 s of an m x m matrix whose rows lie
// `stride` elements apart), 0 past m.
template <int M, typename T>
__device__ __forceinline__ void load_rows(T (&a)[warp_rows<M>()][M],
                                          const T* src, int stride, int m,
                                          int lane) {
#pragma unroll
  for (int s = 0; s < warp_rows<M>(); ++s) {
    const int r = warp_row(lane, s);
#pragma unroll
    for (int j = 0; j < M; ++j)
      a[s][j] = r < m && j < m ? src[r * stride + j] : T(0);
  }
}

// Copy one m x m matrix (m <= M) into a warp's buffer, row r at
// r (M | 1), with cp.async (committed as one group; copy_wait completes
// it).
template <int M, typename T>
__device__ __forceinline__ void stage_matrix(T* buf, const T* src, int m,
                                             int lane) {
#pragma unroll
  for (int r = 0; r < M; ++r) {
    if (r < m) {
#pragma unroll
      for (int c0 = 0; c0 < M; c0 += 32) {
        const int c = c0 + lane;
        if (c < m) copy_async_elem(buf + r * (M | 1) + c, src + r * m + c);
      }
    }
  }
  copy_commit();
}

// det_ge's determinant of the m x m matrix (m <= M) whose rows this warp
// holds, as warp_det computes it (the pivot row by a shuffle a column).
// Rows and columns m and past take no part: no pivot comes from them,
// and what their entries hold never reaches an entry of the matrix.
template <int M, typename T>
__device__ __forceinline__ T warp_det_m(T (&a)[warp_rows<M>()][M], int m,
                                        int lane) {
  constexpr int R = warp_rows<M>();
  int place[R];
#pragma unroll
  for (int s = 0; s < R; ++s) place[s] = warp_row(lane, s);
  T sign = T(1);
  T prod = T(1);
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int key = warp_pivot_search<M>(a, place, lane, k, m);
    const int p = key >> 6;     // the winner's place
    const int src = key & 63;   // and its row
    if (p != k) {
      sign = -sign;
#pragma unroll
      for (int s = 0; s < R; ++s)
        place[s] = (place[s] == k) ? p : (place[s] == p ? k : place[s]);
    }
    // the pivot row's column j (a constant once unrolled), from its lane
    auto col = [&](int j) {
      T v = a[0][j];
      if constexpr (R > 1) v = src >= 32 ? a[R - 1][j] : v;
      return __shfl_sync(kFullMask, v, src & 31);
    };
    const T piv = col(k);
    prod *= piv;
    if (k == m - 1) break;
    const T safe = (piv == T(0)) ? T(1) : piv;
    const T inv = T(1) / safe;
    T f[R];
    bool below[R];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      below[s] = warp_row(lane, s) < m && place[s] > k;
      f[s] = below[s] ? quotient(a[s][k], safe, inv) : T(0);
    }
#pragma unroll
    for (int j = k + 1; j < M; ++j) {
      const T top = col(j);
#pragma unroll
      for (int s = 0; s < R; ++s)
        if (below[s]) a[s][j] -= f[s] * top;
    }
  }
  return sign * prod;
}

// The kernel: m = M where Exact, else the argument (m <= M: the rows and
// columns past m of the registers are left out).
template <int M, bool Exact, typename T>
__global__ void __launch_bounds__(32 * kDetWarps)
    minor_det_warp_kernel(const T* __restrict__ mats, int B, int m_arg,
                          T* __restrict__ out) {
  constexpr int R = warp_rows<M>();
  const int m = Exact ? M : m_arg;
  const long long mm = static_cast<long long>(m) * m;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* buf = reinterpret_cast<T*>(smem) + warp * det_buf_len<M, T>();
  const long long stride = static_cast<long long>(gridDim.x) * kDetWarps;
  long long b = static_cast<long long>(blockIdx.x) * kDetWarps + warp;
  if (b >= B) return;  // a whole warp
  T a[R][M];
  if constexpr (!det_staged<M, T>()) {  // one matrix a warp
    load_rows<M>(a, mats + b * mm, m, m, lane);
    const T d = warp_det_m<M>(a, m, lane);
    if (lane == 0) out[b] = d;
  } else {
    stage_matrix<M>(buf, mats + b * mm, m, lane);
    for (;;) {
      copy_wait();
      __syncwarp();
      load_rows<M>(a, buf, M | 1, m, lane);
      __syncwarp();  // every row is in registers: the buffer is free
      const long long next = b + stride;
      if (next < B) stage_matrix<M>(buf, mats + next * mm, m, lane);
      const T d = warp_det_m<M>(a, m, lane);
      if (lane == 0) out[b] = d;
      if (next >= B) return;
      b = next;
    }
  }
}


template <int M, typename T>
int det_warp_smem_bytes() {
  return kDetWarps * det_buf_len<M, T>() * static_cast<int>(sizeof(T));
}

// Launch the instance for M on m (m = M where Exact).  Staged, the grid
// is the SMs times the blocks an SM holds (or fewer where B needs fewer),
// after one opt-in of the shared memory and one occupancy query per device
// (the flag and count tables of the including unit, by type and M);
// else one warp a matrix.
template <int M, bool Exact, typename T>
cudaError_t launch_warp_m(const T* mats, int B, int m, T* out,
                          std::atomic<bool> (&opted)[kMaxDevices],
                          std::atomic<int> (&fit)[kMaxDevices],
                          cudaStream_t s) {
  const long long need = (static_cast<long long>(B) + kDetWarps - 1) /
                         kDetWarps;
  long long grid = need;
  const int bytes = det_warp_smem_bytes<M, T>();
  if constexpr (det_staged<M, T>()) {
    cudaError_t e = opt_in_smem(opted, minor_det_warp_kernel<M, Exact, T>,
                                bytes);
    if (e != cudaSuccess) return e;
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    int per_sm =
        dev < kMaxDevices ? fit[dev].load(std::memory_order_acquire) : 0;
    if (per_sm == 0) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, minor_det_warp_kernel<M, Exact, T>, 32 * kDetWarps,
          bytes);
      if (e != cudaSuccess) return e;
      per_sm = per_sm < 1 ? 1 : per_sm;
      if (dev < kMaxDevices) fit[dev].store(per_sm, std::memory_order_release);
    }
    const long long most = static_cast<long long>(sms) * per_sm;
    grid = need < most ? need : most;
  }
  minor_det_warp_kernel<M, Exact, T>
      <<<static_cast<unsigned>(grid), 32 * kDetWarps, bytes, s>>>(mats, B, m,
                                                                  out);
  return cudaGetLastError();
}

// m taken at run time on the register widths W0 < W1 (the smaller that
// holds m), each instance's flags in the including unit's tables (by
// type, then width).
template <int W0, int W1, typename T>
cudaError_t launch_warp_widths(const T* mats, int B, int m, T* out,
                               std::atomic<bool> (&opted)[2][2][kMaxDevices],
                               std::atomic<int> (&fit)[2][2][kMaxDevices],
                               cudaStream_t s) {
  constexpr int d = sizeof(T) == 8;
  if (m <= W0)
    return launch_warp_m<W0, false, T>(mats, B, m, out, opted[d][0],
                                       fit[d][0], s);
  if (m <= W1)
    return launch_warp_m<W1, false, T>(mats, B, m, out, opted[d][1],
                                       fit[d][1], s);
  return cudaErrorInvalidValue;
}

// A unit's entry NAME (declared in warp.cuh) at the widths W0 and W1, in
// both types, on the unit's own namespace-scope flag tables (a
// function-local static of a template is shared across loaded
// libraries).
#define DET_WARP_WIDTHS(NAME, W0, W1)                                    \
  static std::atomic<bool> NAME##_opted[2][2][kMaxDevices];              \
  static std::atomic<int> NAME##_fit[2][2][kMaxDevices];                 \
  cudaError_t NAME(const float* mats, int B, int m, float* out,          \
                   cudaStream_t s) {                                     \
    return launch_warp_widths<W0, W1>(mats, B, m, out, NAME##_opted,     \
                                      NAME##_fit, s);                    \
  }                                                                      \
  cudaError_t NAME(const double* mats, int B, int m, double* out,        \
                   cudaStream_t s) {                                     \
    return launch_warp_widths<W0, W1>(mats, B, m, out, NAME##_opted,     \
                                      NAME##_fit, s);                    \
  }

}  // namespace radic
