// Radic partial sums at m = 17..33 by a walk that shares elimination
// prefixes: the wide path of K1, K2 and K4 wherever walk_and_reduce
// (radic_fused.cu) routes (m, n) to it (prefix_walk, radic_prefix.cu);
// radic_warp.cu's kernel takes the other wide shapes.  Per matrix b of a
// shape-uniform stack As (B, m, n), out[b] = sum over ranks q in
// [q_start, q_start + count) of sign(B_q) * det(A_b[:, B_q]).
//
// Replaces, at those shapes, repro/kernels/radic_fused.py:156
// radic_batched_combo_kernel (K1), :39 radic_fused_kernel (K2, the same
// kernel at B = 1) and :92 radic_batched_kernel (K4).
//
// What bounds it: the chain of a step.  Each elimination step is a few
// dependent instructions a live row in every lane (the pivot column's
// shuffles, the search, the reciprocal, the multipliers, the update), so
// the kernel is bound by the issue of these short dependent steps (far
// below the float32 peak on its own operation count), not by arithmetic
// or memory; a short range is bound by one run's serial chain (the
// dispatch leaves those to the warp kernel).  Design: do fewer steps, and
// keep each step off memory and barriers.
//   * Gaussian elimination of A[:, B] (not of the transposed minor) with
//     row partial pivoting, det_ge's rule: the largest magnitude wins, a
//     tie goes to the lower row, a NaN counts as +inf, so that every step
//     has a winner; quotient() divides a zero pivot's column by 1, so an
//     exactly singular minor gives exactly 0.  Rows never move: the live
//     rows stay packed in their original order, so the pivot's index
//     among them is the number of live rows above it, whose parity is
//     the permutation's sign; each step multiplies the pivots' running
//     product.
//   * The first k steps read only columns b_1..b_k, so the state after k
//     steps (every candidate column's m - k live entries) is the same for
//     each combination with that prefix.  Lane j holds column j (j + 1 at
//     n = 33, where column 0 is only ever the first pivot, read from
//     shared memory), so one step updates every candidate column at once,
//     and the step at level m - 2 for column c leaves each lane j > c
//     with the last pivot of the leaf (prefix, c, j).  A walk in
//     dictionary order eliminates each prefix once: C(n, m - 1) - 1 steps
//     for all C(n, m) minors of a full range, m / (n - m + 1) a minor,
//     where the parent kernel took m.
//   * The step (prefix_step), one function at every level: the pivot
//     column reaches every lane (by shuffles from its lane,
//     prefix_column; at level 0 from the staged matrix), and each
//     lane works out the pivot, its index, the reciprocal and the
//     multipliers itself, all lanes alike, then updates its column:
//     nothing goes through shared memory and no barrier waits.  Every
//     level carries the pivots' product with the sign folded in (exact:
//     a sign flip rounds nothing).
//   * The walk keeps levels K0..m-2 (the deepest prefix_deep(m) levels,
//     level k holding m - k floats a lane) in registers, by template
//     recursion, so that no instance spills at kPrefixMinBlocks blocks
//     an SM.  Where the walk's change reaches above them (a restart:
//     a run's start, or a prefix of length K0 used up) the levels up to
//     K0 are eliminated again, in a loop over fixed M-slot arrays masked
//     past L = M - k (an unrolled chain of them overflowed the
//     instruction cache at m >= 24), from the staged matrix or from the
//     snapshot of the deepest level the change leaves intact: levels
//     K0 - kPrefixSnap .. K0 - 1 are kept in shared memory as they are
//     built.
//   * Each lane adds its leaves in rank order; at a run's end a butterfly
//     adds the lanes (the same bits in every lane) and lane 0 adds that
//     to its warp's running sum.  A block walks one matrix at a time
//     (walking two together with their own states measured slower).
//   * A tile is kPrefixWarps warps x `run` consecutive ranks, run =
//     prefix_run(count); a fixed number of blocks G (a function of count
//     alone) walk tiles g, g+G, ...; the block adds its warps' sums in
//     warp order into partials[g][b], and reduce_partials_kernel adds the
//     G partials of each matrix in order of g.  Everything a matrix's
//     result depends on is a function of (m, n, count), so it is
//     bit-identical alone, in any batch slot, and between K1, K2 and K4.
#pragma once

#include <cuda_runtime.h>

#include "warp.cuh"

namespace radic {

constexpr int kPrefixWarps = 8;                  // warps per block
constexpr int kPrefixThreads = 32 * kPrefixWarps;
constexpr int kPrefixDeep = 10;                  // levels kept in registers
constexpr int kPrefixSnap = 6;   // levels above them kept in shared memory
constexpr int kComboInts = 36;                   // a warp's combination

// Levels a walk keeps in registers: levels m - D .. m - 2.
__host__ __device__ constexpr int prefix_deep(int m) {
  return kPrefixDeep < m - 1 ? kPrefixDeep : m - 1;
}

// Blocks per SM the compiler keeps registers for.
constexpr int kPrefixMinBlocks = 2;

// The levels a warp keeps a snapshot of in shared memory, lo..K0-1 with
// lo = max(1, K0 - kPrefixSnap): a restart whose change leaves the prefix's
// positions 0..k-1 alone resumes at level k if k >= lo.
__host__ __device__ constexpr int prefix_snap_lo(int m) {
  return m - prefix_deep(m) - kPrefixSnap > 1
             ? m - prefix_deep(m) - kPrefixSnap
             : 1;
}
// A lane's floats before level k's snapshot (k >= lo): each level's
// m - j live entries and the signed product.
__host__ __device__ constexpr int prefix_snap_base(int m, int k) {
  return (k - prefix_snap_lo(m)) * (2 * (m + 1) - prefix_snap_lo(m) - k + 1) /
         2;
}
// A warp's snapshots, in floats.
__host__ __device__ constexpr int prefix_snap_floats(int m) {
  return 32 * prefix_snap_base(m, m - prefix_deep(m));
}

// det_ge's pivot key of x: |x|'s bits (which order as |x| does), a NaN's
// taken as +inf's.
__device__ __forceinline__ unsigned pivot_key(float x) {
  const unsigned u = __float_as_uint(x) & 0x7fffffffu;
  return u < 0x7f800000u ? u : 0x7f800000u;
}

// A warp's walk of one run: the run's combination (`combo`, shared
// memory, written by the warp), the leaves still to visit, and each
// lane's sums.
template <int M>
struct PrefixWalk {
  int n, off, lane, left;
  bool first;   // still on the run's first path down from its combination
  int* combo;   // positions 0..M-1; 0..K0-1 are the current prefix
  float acc;
};

// (-1)^(c + 1): a 0-indexed column's share of the Radic sign.
__device__ __forceinline__ float column_sign(int c) {
  return (c & 1) ? 1.0f : -1.0f;
}

// The pivot column's N slots from lane `src`, to every lane.  Slots past
// the live rows go too (prefix_step masks them): a branch around each
// shuffle made the restarts cost the kernel 1.4-15 % more on an H100.
template <int N>
__device__ __forceinline__ void prefix_column(const float (&v)[N], int src,
                                              float (&u)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) u[r] = __shfl_sync(kFullMask, v[r], src);
}

// A step in every lane at once, on L live rows of N slots: from the pivot
// column's entries u, each lane works out the pivot (the first of the
// largest keys), its index p among the live rows and the multipliers of
// the other live rows itself, then packs its column v's live entries less
// the multipliers times its entry on the pivot row into w (w may be v:
// each slot is read before it is written).  Returns the pivot.  The deep
// levels take N = L, where the masks fold away.
template <int N, int NW>
__device__ __forceinline__ float prefix_step(const float (&u)[N],
                                             const float (&v)[N], int L,
                                             float (&w)[NW], int& p) {
  unsigned key = pivot_key(u[0]);
  float piv = u[0], top = v[0];
  p = 0;
#pragma unroll
  for (int r = 1; r < N; ++r) {
    const unsigned kr = r < L ? pivot_key(u[r]) : 0u;  // 0 never wins
    const bool later = kr > key;
    key = later ? kr : key;
    p = later ? r : p;
    piv = later ? u[r] : piv;
    top = later ? v[r] : top;
  }
  const float safe = (piv == 0.0f) ? 1.0f : piv;
  const float inv = 1.0f / safe;
#pragma unroll
  for (int r = 0; r + 1 < N; ++r) {
    const bool above = r < p;
    const float f = quotient(above ? u[r] : u[r + 1], safe, inv);
    if (r + 1 < L) w[r] = (above ? v[r] : v[r + 1]) - f * top;
  }
  return piv;
}

// Level K of the walk: its state S (M - K live entries a lane) and the
// pivots' product so far times the sign so far (exact: a sign flip
// rounds nothing, so each leaf gets the bits of sign times product);
// position K takes columns c, c + 1, ... up to its cap n - M + K.
template <int M, int K>
__device__ __forceinline__ void prefix_level(const float (&S)[M - K],
                                             float prod, int c,
                                             PrefixWalk<M>& w) {
  constexpr int L = M - K;
  for (; c <= w.n - M + K && w.left > 0; ++c) {
    float u[L], T[L - 1];
    prefix_column(S, c - w.off, u);
    int p;
    const float q = prod * prefix_step(u, S, L, T, p);
    // column c's share of the sign, (-1)^(c + 1), and the pivot's parity
    const float p2 = ((c ^ p) & 1) ? q : -q;
    if constexpr (K == M - 2) {
      // the leaves (prefix, c, j), j = js..je, one a lane
      const int js = w.first ? w.combo[M - 1] : c + 1;
      const int je = min(w.n - 1, js + w.left - 1);
      const int j = w.lane + w.off;
      if (j >= js && j <= je) w.acc += column_sign(j) * (p2 * T[0]);
      w.left -= je - js + 1;
      w.first = false;
    } else {
      prefix_level<M, K + 1>(T, p2, w.first ? w.combo[K + 1] : c + 1, w);
    }
  }
}

template <int M>
__global__ void __launch_bounds__(kPrefixThreads, kPrefixMinBlocks)
    radic_prefix_kernel(const float* __restrict__ As, int B, int n,
                        const int* __restrict__ table, int q_start,
                        long long count, long long num_tiles, int run,
                        float* __restrict__ partials) {
  constexpr int D = prefix_deep(M);
  constexpr int K0 = M - D;
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc_s = reinterpret_cast<float*>(smem);
  int* combo_s = reinterpret_cast<int*>(acc_s + kPrefixWarps);
  float* snap_s =
      reinterpret_cast<float*>(combo_s + kPrefixWarps * kComboInts);
  int* tab_s =
      reinterpret_cast<int*>(snap_s + kPrefixWarps * prefix_snap_floats(M));
  float* A_s = reinterpret_cast<float*>(tab_s + (n + 1) * (M + 1));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mn = M * n;
  PrefixWalk<M> w;
  w.n = n;
  w.off = n > 32 ? n - 32 : 0;
  w.lane = lane;
  w.combo = combo_s + warp * kComboInts;
  float* snap = snap_s + warp * prefix_snap_floats(M);
  constexpr int lo = prefix_snap_lo(M);
  const int col = lane + w.off;  // this lane's column
  const float base = ((M * (M + 1) / 2) & 1) ? -1.0f : 1.0f;
  copy_async(tab_s, table, (n + 1) * (M + 1));
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    copy_async(A_s, As + static_cast<size_t>(b) * mn, mn);
    copy_wait();
    if (tid < kPrefixWarps) acc_s[tid] = 0.0f;
    __syncthreads();

    for (long long t = blockIdx.x; t < num_tiles; t += gridDim.x) {
      const long long o = (t * kPrefixWarps + warp) * run;
      if (o >= count) continue;  // a warp past the range adds nothing
      int c[warp_rows<M>()];
      warp_unrank<M>(q_start + static_cast<int>(o), n, tab_s, c, lane);
      __syncwarp();  // the last run is done with the combination
#pragma unroll
      for (int s = 0; s < warp_rows<M>(); ++s)
        if (warp_row(lane, s) < M) w.combo[warp_row(lane, s)] = c[s];
      __syncwarp();
      w.left = static_cast<int>(min(static_cast<long long>(run), count - o));
      w.first = true;
      w.acc = 0.0f;
      int from = 0;  // the level a restart resumes at
      while (w.left > 0) {
        // a restart: levels from+1..K0 of the prefix combo[0..K0-1], from
        // the staged matrix (from = 0) or level from's snapshot; levels
        // lo..K0-1 are snapshotted on the way
        float v[M], prod;
        if (from == 0) {
#pragma unroll
          for (int r = 0; r < M; ++r) v[r] = col < n ? A_s[r * n + col] : 0.0f;
          prod = base;
        } else {
          const float* si = snap + prefix_snap_base(M, from) * 32 + lane;
#pragma unroll
          for (int r = 0; r < M; ++r) v[r] = r < M - from ? si[r * 32] : 0.0f;
          prod = si[(M - from) * 32];
        }
#pragma unroll 1
        for (int k = from; k < K0; ++k) {
          if (k >= lo && (k > from || from == 0)) {
            float* si = snap + prefix_snap_base(M, k) * 32 + lane;
#pragma unroll
            for (int r = 0; r < M; ++r)
              if (r < M - k) si[r * 32] = v[r];
            si[(M - k) * 32] = prod;
          }
          // the pivot column: at level 0 as staged (column 0 has no lane
          // at n = 33), below it from its lane
          const int ck = w.combo[k];
          float u[M];
          if (k == 0) {
#pragma unroll
            for (int r = 0; r < M; ++r) u[r] = A_s[r * n + ck];
          } else {
            prefix_column(v, ck - w.off, u);
          }
          int p;
          const float q = prod * prefix_step(u, v, M - k, v, p);
          prod = ((ck ^ p) & 1) ? q : -q;
        }
        float S[D];
#pragma unroll
        for (int r = 0; r < D; ++r) S[r] = v[r];
        prefix_level<M, K0>(S, prod,
                            w.first ? w.combo[K0] : w.combo[K0 - 1] + 1, w);
        if (w.left > 0) {
          // the prefix used up: its successor (positions 0..K0-1)
          int at = 0;
          for (int i = 0; i < K0; ++i)
            if (w.combo[i] < n - M + i) at = i;
          const int c0 = w.combo[at];
          __syncwarp();
          if (lane >= at && lane < K0) w.combo[lane] = c0 + 1 + (lane - at);
          __syncwarp();
          from = at >= lo ? at : 0;
        }
      }
      float s = w.acc;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(kFullMask, s, d);
      if (lane == 0) acc_s[warp] += s;
    }
    __syncthreads();
    if (tid == 0) {
      float s = 0.0f;
#pragma unroll
      for (int wi = 0; wi < kPrefixWarps; ++wi) s += acc_s[wi];
      partials[static_cast<size_t>(blockIdx.x) * B + b] = s;
    }
    __syncthreads();  // the sums are read before the next matrix
  }
}

// Shared memory per block: the warps' sums, combinations and snapshots,
// the Pascal table and the matrix.
__host__ __device__ constexpr int prefix_stage_bytes(int m, int n) {
  return 4 * (kPrefixWarps * (1 + kComboInts) +
              kPrefixWarps * prefix_snap_floats(m) + (n + 1) * (m + 1) +
              m * n);
}

// Which instances the launching unit has opted in, by m and device.
static std::atomic<bool> prefix_opted[kWarpMaxM + 1][kMaxDevices];

int prefix_run(long long count);

template <int M>
cudaError_t launch_prefix_walk_m(int grid, cudaStream_t stream,
                                 const float* As, int B, int n,
                                 const int* table, int q_start,
                                 long long count, float* partials) {
  const int run = prefix_run(count);
  const long long tile = static_cast<long long>(kPrefixWarps) * run;
  const long long num_tiles = (count + tile - 1) / tile;
  const dim3 g(grid, B < 65535 ? B : 65535);
  // opt in to the most any n takes, once
  const cudaError_t e = opt_in_smem(prefix_opted[M], radic_prefix_kernel<M>,
                                    prefix_stage_bytes(M, kWarpMaxM));
  if (e != cudaSuccess) return e;
  radic_prefix_kernel<M><<<g, kPrefixThreads, prefix_stage_bytes(M, n), stream>>>(
      As, B, n, table, q_start, count, num_tiles, run, partials);
  return cudaGetLastError();
}

// radic_prefix_hi.cu: the instances at m = 26..27
cudaError_t launch_prefix_walk_hi(int m, int grid, cudaStream_t s,
                                  const float* As, int B, int n,
                                  const int* table, int q_start,
                                  long long count, float* partials);

}  // namespace radic
