// Warp-level routines of the wide path (17 <= m <= 33; K6 up to m = 64).
//
// The register path (common.cuh) keeps one m x m minor in one thread's
// registers, which stops at m = 16: at m = 17..33 a minor is 289..1,089
// floats against 255 registers a thread.  Here one warp owns one matrix:
// lane i holds row i (and row i + 32 where m > 32: m = 33 in the Radic
// kernels, up to 64 in K6).  Rows never move between lanes.  det_ge's row swap
// becomes an exchange of two rows' places in the elimination order
// (`place`), so every step is det_ge's step on the same values:
//   * the pivot search is a warp reduction of (|a[i][k]|, place) over the
//     rows with place >= k; the largest magnitude wins and, on equal
//     magnitudes, the smaller place: det_ge's strict '>' keeps the first
//     (a non-negative float orders as its bits, so it compares integers:
//     in float32 two redux instructions, a max of the bits, then a min of
//     the places that hold it; in float64 three, the high word's max,
//     the low word's among its holders, then the places').  A NaN counts
//     as +inf below place k and above every magnitude at place k, so
//     every step has a winner
//     (the row at place k, eligible and of the smallest key, wins every
//     tie); on finite input the pivots are det_ge's.  A NaN among the
//     rows makes the determinant NaN whichever row is the pivot, as in
//     det_ge (it stays in the rows still to be eliminated: a pivot row's
//     NaN reaches every row below, another row's stays in that row);
//   * the pivot row is broadcast by __shfl_sync, column by column;
//   * the multiplier is quotient() (common.cuh), so an exactly singular
//     minor still gives exactly 0, and a zero pivot divides by 1;
//   * det = sign * the pivots' product, taken in place order as det_ge
//     takes its diagonal.
// Every lane ends with the same determinant.  The same function computes
// a rank's determinant in K1, K2 and K4 (one kernel), so the three agree
// bit for bit on this path as on the register path.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace radic {

constexpr unsigned kFullMask = 0xffffffffu;
// Largest m of the wide Radic kernels, and their largest n: the int32
// table bounds n <= 33 for every m >= 17.
constexpr int kWarpMaxM = 33;
// Largest m of K6's warp kernels (two rows a lane), and of the first of
// their two units at m > 33
constexpr int kDetWarpMaxM = 64;
constexpr int kDetHiMaxM = 48;

// T's 16-byte vector, for loads of four floats or two doubles at once
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static void unpack(const float4& v, float* t) {
    t[0] = v.x;
    t[1] = v.y;
    t[2] = v.z;
    t[3] = v.w;
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static void unpack(const double2& v, double* t) {
    t[0] = v.x;
    t[1] = v.y;
  }
};

// Rows a lane holds: ceil(M / 32).
template <int M>
__host__ __device__ constexpr int warp_rows() {
  return (M + 31) / 32;
}

// Row r of slot s of this lane is row lane + 32 s of the matrix.
__device__ __forceinline__ int warp_row(int lane, int s) {
  return lane + 32 * s;
}

// The (|a[.][k]|, key) reduction of a pivot search: the larger value
// wins, on equal values the smaller key (here key = place * 64 + the
// row's lane + 32 * slot, so that comparing keys compares places).  V is
// a magnitude or its bits.
template <typename V>
__device__ __forceinline__ void pivot_max(V& v, int& key, V ov, int okey) {
  if (ov > v || (ov == v && okey < key)) {
    v = ov;
    key = okey;
  }
}

// |x|'s bits, which order as |x| does, and those of +inf: a NaN's are
// larger.
__device__ __forceinline__ unsigned abs_bits(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}
__device__ __forceinline__ unsigned long long abs_bits(double x) {
  return static_cast<unsigned long long>(__double_as_longlong(x)) &
         0x7fffffffffffffffull;
}
template <typename T>
__device__ __forceinline__ decltype(abs_bits(T())) inf_bits() {
  return sizeof(T) == 4 ? 0x7f800000ull : 0x7ff0000000000000ull;
}

// Step k's pivot search over the rows this warp holds, rows m and past
// left out (m <= M): the (|a[.][k]|, place) reduction of the header.
// Returns the winner's key, place * 64 + row, in every lane.
template <int M, typename T>
__device__ __forceinline__ int warp_pivot_search(
    const T (&a)[warp_rows<M>()][M], const int (&place)[warp_rows<M>()],
    int lane, int k, int m) {
  constexpr int R = warp_rows<M>();
  // this lane's best eligible row (bits, key); a lane with none keeps
  // (0, 1 << 30), which the row at place k always beats
  decltype(abs_bits(T())) best = 0;
  int key = 1 << 30;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    if (warp_row(lane, s) < m && place[s] >= k) {
      const auto cap = place[s] == k ? ~decltype(best)(0) : inf_bits<T>();
      const auto u = abs_bits(a[s][k]);
      const int kk = place[s] * 64 + warp_row(lane, s);
      if (s == 0) {
        best = u < cap ? u : cap;
        key = kk;
      } else {
        pivot_max(best, key, u < cap ? u : cap, kk);
      }
    }
  }
  if constexpr (sizeof(T) == 4) {
    // two warp reductions: the largest bits, then the smallest key
    // among their holders
    const unsigned top = __reduce_max_sync(kFullMask, best);
    key = static_cast<int>(__reduce_min_sync(
        kFullMask, best == top ? static_cast<unsigned>(key) : ~0u));
  } else {
    // the 64 bits in two halves: the largest high word, the largest low
    // word among its holders, then the smallest key among theirs (three
    // reductions, the same winner as a butterfly of pivot_max)
    const unsigned hi = static_cast<unsigned>(best >> 32);
    const unsigned lo = static_cast<unsigned>(best);
    const unsigned top_hi = __reduce_max_sync(kFullMask, hi);
    const unsigned top_lo =
        __reduce_max_sync(kFullMask, hi == top_hi ? lo : 0u);
    key = static_cast<int>(__reduce_min_sync(
        kFullMask, hi == top_hi && lo == top_lo ? static_cast<unsigned>(key)
                                                : ~0u));
  }
  return key;
}

// Gaussian elimination with partial pivoting of the M x M matrix whose
// rows this warp holds (a[s][j] = row warp_row(lane, s), column j; rows
// past M-1 are ignored).  Returns the pivots' product in every lane, and
// the permutation's sign in `sign`: det_ge's determinant is their
// product.  With KeepL, a[s][k] keeps the multiplier of step k (k < the row's
// place) and the row's entries from its place on are U's, so the rows
// hold P a = L U; `place[s]` is the row's place in P a, and `zero_pivot`
// says whether a pivot was exactly 0.  With `inv_of`, the lane that
// holds row k of the matrix (slot s: row warp_row(lane, s)) keeps step
// k's reciprocal 1 / U[k][k] in inv_of[s], for k < M - 1.
template <int M, bool KeepL, typename T>
__device__ __forceinline__ T warp_lu(T (&a)[warp_rows<M>()][M],
                                     int (&place)[warp_rows<M>()], int lane,
                                     bool& zero_pivot, T& sign,
                                     T* inv_of = nullptr) {
  constexpr int R = warp_rows<M>();
#pragma unroll
  for (int s = 0; s < R; ++s) place[s] = warp_row(lane, s);
  sign = T(1);
  T prod = T(1);
  zero_pivot = false;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int key = warp_pivot_search<M>(a, place, lane, k, M);
    const int p = key >> 6;          // the winner's place
    const int src = key & 63;        // and its row
    if (p != k) {
      sign = -sign;
#pragma unroll
      for (int s = 0; s < R; ++s)
        place[s] = (place[s] == k) ? p : (place[s] == p ? k : place[s]);
    }
    // the pivot row, column by column from its lane (a uniform slot)
    const int from = src & 31;
    const bool hi = src >= 32;
    auto col = [&](int j) {
      T v = a[0][j];
      if constexpr (R > 1) v = hi ? a[R - 1][j] : v;
      return __shfl_sync(kFullMask, v, from);
    };
    const T piv = col(k);
    prod *= piv;
    zero_pivot = zero_pivot || (piv == T(0));
    if (k == M - 1) break;
    const T safe = (piv == T(0)) ? T(1) : piv;
    const T inv = T(1) / safe;
    T f[R];
    bool below[R];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      if (inv_of != nullptr && warp_row(lane, s) == k) inv_of[s] = inv;
      below[s] = warp_row(lane, s) < M && place[s] > k;
      f[s] = below[s] ? quotient(a[s][k], safe, inv) : T(0);
      if (KeepL && below[s]) a[s][k] = f[s];
    }
#pragma unroll
    for (int j = k + 1; j < M; ++j) {
      const T top = col(j);
#pragma unroll
      for (int s = 0; s < R; ++s)
        if (below[s]) a[s][j] -= f[s] * top;
    }
  }
  return prod;
}

// det_ge's determinant of the M x M matrix this warp holds.
template <int M, typename T>
__device__ __forceinline__ T warp_det(T (&a)[warp_rows<M>()][M], int lane) {
  int place[warp_rows<M>()];
  bool zero_pivot;
  T sign;
  const T prod = warp_lu<M, false>(a, place, lane, zero_pivot, sign);
  return sign * prod;
}

// The n-step walk of unrank_rank (common.cuh) for one rank, walked by
// every lane alike: lane i keeps the rank's i-th column (0-indexed) in
// c[0] (and column i + 32 in c[1] where M = 33).  Returns the 1-indexed
// column sum.  `table` is the (n+1, M+1) Pascal table.
template <int M>
__device__ __forceinline__ int warp_unrank(int q, int n,
                                           const int* __restrict__ table,
                                           int (&c)[warp_rows<M>()],
                                           int lane) {
  constexpr int R = warp_rows<M>();
#pragma unroll
  for (int s = 0; s < R; ++s) c[s] = 0;
  int pos = 0;
  int sum = 0;
  for (int v = 1; v <= n && pos < M; ++v) {
    const int cnt = table[(n - v) * (M + 1) + (M - 1 - pos)];
    if (q < cnt) {
#pragma unroll
      for (int s = 0; s < R; ++s)
        if (pos == warp_row(lane, s)) c[s] = v - 1;
      sum += v;
      ++pos;
    } else {
      q -= cnt;
    }
  }
  return sum;
}

// successor (common.cuh) on columns spread over the warp: the rightmost
// place below its cap n - M + i is found by ballot, its column broadcast,
// and the suffix reset to a consecutive run.  Returns the new 1-indexed
// column sum.
template <int M>
__device__ __forceinline__ int warp_successor(int (&c)[warp_rows<M>()],
                                              int n, int lane) {
  constexpr int R = warp_rows<M>();
  int at = -1;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int i = warp_row(lane, s);
    const unsigned bits =
        __ballot_sync(kFullMask, i < M && c[s] < n - M + i);
    if (bits) at = 32 * s + 31 - __clz(bits);
  }
  const bool hi = at >= 32;
  int v = c[0];
  if constexpr (R > 1) v = hi ? c[R - 1] : v;
  const int base = __shfl_sync(kFullMask, v, at & 31);
  int local = 0;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int i = warp_row(lane, s);
    if (i < M) {
      if (i >= at) c[s] = base + 1 + (i - at);
      local += c[s] + 1;
    }
  }
  return __reduce_add_sync(kFullMask, local);
}

// Host launches of the warp kernels.  radic_warp.cu: the walk of K1, K2
// and K4 (without the reduction, which the caller adds) and its shared
// memory per block; radic_warp_grad.cu (and _hi.cu): K3's partials, its
// ranks per tile and its shared memory per block.
cudaError_t launch_warp_walk(int m, int grid, int chunk, cudaStream_t s,
                             const float* As, int B, int n, const int* table,
                             int q_start, long long count, float* partials);
int warp_partial_smem_bytes(int B, int m, int n);
// radic_prefix.cu: whether (m, n) takes the prefix walk (radic_prefix.cuh)
// in place of the warp kernel, its launch (without the reduction) and its
// shared memory per block.
bool prefix_walk(int m, int n);
cudaError_t launch_prefix_walk(int m, int grid, cudaStream_t s,
                               const float* As, int B, int n,
                               const int* table, int q_start, long long count,
                               float* partials);
int prefix_smem_bytes(int m, int n);
cudaError_t launch_grad_warp(int m, int grid, int B, cudaStream_t s,
                             const float* As, const float* cts, int n,
                             const int* table, int q_start, long long count,
                             float* partials);
int warp_grad_tile_of(int m);
int warp_grad_smem_bytes(int m);
// minor_det_warp.cu: K6 at 17 <= m <= 33; minor_det_warp_hi.cu: K6 at
// 34 <= m <= kDetHiMaxM; minor_det_warp_top.cu: up to kDetWarpMaxM.
cudaError_t launch_minor_det_warp(const float* mats, int B, int m,
                                  float* out, cudaStream_t s);
cudaError_t launch_minor_det_warp(const double* mats, int B, int m,
                                  double* out, cudaStream_t s);
cudaError_t launch_minor_det_warp_hi(const float* mats, int B, int m,
                                     float* out, cudaStream_t s);
cudaError_t launch_minor_det_warp_hi(const double* mats, int B, int m,
                                     double* out, cudaStream_t s);
cudaError_t launch_minor_det_warp_top(const float* mats, int B, int m,
                                      float* out, cudaStream_t s);
cudaError_t launch_minor_det_warp_top(const double* mats, int B, int m,
                                      double* out, cudaStream_t s);

}  // namespace radic
