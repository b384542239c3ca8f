// The gradient kernel (K3) of radic_grad.cu, shared by the two
// translation units that instantiate it: radic_grad.cu for m <= 13 and
// radic_grad_wide.cu for m >= 14, compiled in parallel (the unrolled
// m x m arithmetic makes the large m slow to compile).
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace radic {

// Ranks per tile of the gradient kernel (== threads per block): the
// largest power of two <= 256, and at least one warp, whose cofactors
// (T * m^2 floats) fit 32 KB.  The wrapper reads it through
// radic_grad_tile to size its block count.
template <int M>
constexpr int grad_tile() {
  int t = 256;
  while (t > 32 && t * M * M * 4 > 32 * 1024) t /= 2;
  return t;
}

__host__ __device__ constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Slots of the tile's column index: a power of two no smaller than the
// number of distinct columns a tile of T ranks can hold (min(n, T*m)).
__host__ __device__ constexpr int grad_slots(int T, int m, int n) {
  return pow2_at_least(n < T * m ? n : T * m);
}

// Dynamic shared memory of the gradient kernel, in 4-byte words: the
// tile's cofactors ((T + 1) m^2: a row of T ranks plus one word of skew
// for each (j, r), so that owners reading one rank's entries of
// different rows hit different banks), combos, slots and lists (3 T m),
// and the index (H keys, H x T/32 rank masks, H slot starts, H dense
// columns, starts and lengths).
__host__ __device__ constexpr int grad_smem_words(int T, int m, int n) {
  return (T + 1) * m * m + 3 * T * m + grad_slots(T, m, n) * (5 + T / 32);
}

// Its largest value for m (any n: the index takes at most T * m slots),
// in bytes.
template <int M>
constexpr int grad_max_bytes() {
  constexpr int T = grad_tile<M>();
  return 4 * grad_smem_words(T, M, T * M);
}

// out[(j * M + r) * OutStride] = w * cof(a)[j][r] for the transposed
// minor a[j][r] = A[r, c_j] of one (M, n) matrix A, c_j =
// combo[j * Stride]; cof(a)[j][r] is d det / d A[r, c_j].
template <int M, int Stride, int OutStride>
__device__ __forceinline__ void scaled_cofactors(const float* __restrict__ A,
                                                 int n, const int* combo,
                                                 float w, float* out) {
  if (w == 0.0f) {
#pragma unroll
    for (int e = 0; e < M * M; ++e) out[e * OutStride] = 0.0f;
    return;
  }
  if constexpr (M == 1) {
    out[0] = w;  // d a / d a
  } else {
    float a[M][M];
    gather_minor<M, Stride>(A, n, combo, a);
    int rid[M];  // original row of each physical row (the permutation)
#pragma unroll
    for (int i = 0; i < M; ++i) rid[i] = i;
    float sign = 1.0f;
    bool zero_pivot = false;
    // P a = L U with det_ge's pivot rule; multipliers kept below the
    // diagonal, so the swap moves whole rows; one reciprocal per pivot
    // (quotient, common.cuh)
#pragma unroll
    for (int k = 0; k < M; ++k) {
      int p = k;
      float best = fabsf(a[k][k]);
#pragma unroll
      for (int i = k + 1; i < M; ++i) {
        const float v = fabsf(a[i][k]);
        if (v > best) {
          best = v;
          p = i;
        }
      }
      if (p != k) sign = -sign;
#pragma unroll
      for (int i = k + 1; i < M; ++i) {
        const bool sw = (i == p);
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const float top = a[k][j];
          const float row = a[i][j];
          a[k][j] = sw ? row : top;
          a[i][j] = sw ? top : row;
        }
        const int rt = rid[k];
        const int rr = rid[i];
        rid[k] = sw ? rr : rt;
        rid[i] = sw ? rt : rr;
      }
      const float piv = a[k][k];
      zero_pivot = zero_pivot || (piv == 0.0f);
      const float safe = (piv == 0.0f) ? 1.0f : piv;
      const float inv = 1.0f / safe;
#pragma unroll
      for (int i = k + 1; i < M; ++i) {
        const float f = quotient(a[i][k], safe, inv);
        a[i][k] = f;
#pragma unroll
        for (int j = k + 1; j < M; ++j) a[i][j] -= f * a[k][j];
      }
    }
    if (zero_pivot) {
      // cof(a)[j][r] = (-1)^(j+r) det(a without row j and column r),
      // gathered again from A
#pragma unroll 1
      for (int j = 0; j < M; ++j) {
#pragma unroll 1
        for (int r = 0; r < M; ++r) {
          float s[M - 1][M - 1];
#pragma unroll
          for (int jj = 0; jj < M - 1; ++jj) {
            const int c = combo[(jj + (jj >= j ? 1 : 0)) * Stride];
#pragma unroll
            for (int rr = 0; rr < M - 1; ++rr)
              s[jj][rr] = A[(rr + (rr >= r ? 1 : 0)) * n + c];
          }
          const float d = det_ge<M - 1>(s);
          out[(j * M + r) * OutStride] = ((j + r) & 1) ? -(w * d) : w * d;
        }
      }
      return;
    }
    // X = det(U) U^-1 over the upper triangle, in place, columns right to
    // left: X[c][c] = prod of the other pivots, X[r][c] = -(sum_{r<k<=c}
    // U[r][k] X[k][c]) / U[r][r], the division taken as one reciprocal
    // per row
    float d[M], dinv[M];
#pragma unroll
    for (int k = 0; k < M; ++k) {
      d[k] = a[k][k];
      dinv[k] = 1.0f / d[k];
    }
#pragma unroll
    for (int c = M - 1; c >= 0; --c) {
      float x = 1.0f;
#pragma unroll
      for (int k = 0; k < M; ++k)
        if (k != c) x *= d[k];
      a[c][c] = x;
#pragma unroll
      for (int r = c - 1; r >= 0; --r) {
        float s = 0.0f;
#pragma unroll
        for (int k = r + 1; k <= c; ++k) s += a[r][k] * a[k][c];
        a[r][c] = -s * dinv[r];
      }
    }
    // Z = X L^-1 in place, columns right to left (L unit lower, its
    // multipliers still below the diagonal of a)
#pragma unroll
    for (int k = M - 2; k >= 0; --k) {
      float col[M];
#pragma unroll
      for (int i = 0; i < M; ++i) col[i] = (i <= k) ? a[i][k] : 0.0f;
#pragma unroll
      for (int j = k + 1; j < M; ++j) {
        const float l = a[j][k];
#pragma unroll
        for (int i = 0; i < M; ++i) col[i] -= a[i][j] * l;
      }
#pragma unroll
      for (int i = 0; i < M; ++i) a[i][k] = col[i];
    }
    // cof(P a) = Z^T and cof(a) = sign * P^T cof(P a): physical row i
    // is original row rid[i]
    const float ws = w * sign;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float* o = out + rid[i] * M * OutStride;
#pragma unroll
      for (int r = 0; r < M; ++r) o[r * OutStride] = ws * a[r][i];
    }
  }
}

// Exclusive prefix sum of one int per thread over a block of T threads
// (T a multiple of 32); `total` gets the block's sum.  Two barriers.
template <int T>
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_s,
                                                    int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_s[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < T / 32 ? warp_s[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < T / 32) warp_s[lane] = w;
  }
  __syncthreads();
  total = warp_s[T / 32 - 1];
  return (warp > 0 ? warp_s[warp - 1] : 0) + x - v;
}

// One tile's column index: an open-addressed table of H slots, one per
// distinct column present, with a T-bit mask of the tile's ranks that hold
// it.  A slot's value for the scan: its rank count, plus 1 << 16 if taken.
template <int W>
__device__ __forceinline__ int slot_value(const int* key_s,
                                          const unsigned* mask_s, int s) {
  if (key_s[s] < 0) return 0;
  int cnt = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) cnt += __popc(mask_s[s * W + w]);
  return cnt | (1 << 16);
}

template <int M, int T>
__global__ void __launch_bounds__(T)
    radic_grad_partial_kernel(const float* __restrict__ As,
                              const float* __restrict__ cts, int B, int n,
                              const int* __restrict__ table, int q_start,
                              long long count, long long num_tiles, int H,
                              float* __restrict__ partials) {
  constexpr int W = T / 32;  // mask words per slot
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_s[W];
  constexpr int S = T + 1;  // cof_s row stride
  float* cof_s = reinterpret_cast<float*>(smem);  // [j][r][rank], rows of S
  int* combo_s = reinterpret_cast<int*>(cof_s + S * M * M);  // [j][rank]
  int* slot_s = combo_s + M * T;   // [j][rank]: slot of the rank's c_j
  int* list_s = slot_s + M * T;    // column lists, each in rank order
  int* key_s = list_s + M * T;     // [H]: column of a slot, -1 if free
  unsigned* mask_s = reinterpret_cast<unsigned*>(key_s + H);  // [H][W]
  int* sstart_s = reinterpret_cast<int*>(mask_s + H * W);  // [H]
  int* ucol_s = sstart_s + H;      // [D]: dense columns, in slot order
  int* ustart_s = ucol_s + H;      // [D]: their list starts
  int* ulen_s = ustart_s + H;      // [D]: their list lengths
  const int tid = threadIdx.x;
  const int b0 = blockIdx.y * kBatchChunk;
  const int nb = min(kBatchChunk, B - b0);
  const int mn = M * n;
  // this block's (nb, M, n) slice of partials[g] (B, M, n): its running
  // sums, which only this block touches
  float* part = partials + (static_cast<size_t>(blockIdx.x) * B + b0) * mn;
  const float* A0 = As + static_cast<size_t>(b0) * mn;
  for (int e = tid; e < nb * mn; e += T) part[e] = 0.0f;

  const int per = (H + T - 1) / T;  // slots scanned per thread
  const int lo = min(tid * per, H);
  const int hi = min(lo + per, H);
  for (long long t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const long long off = t * T + tid;
    const bool live = off < count;  // a masked lane is never indexed
    __syncthreads();  // the previous tile's owners are done
    for (int s = tid; s < H; s += T) key_s[s] = -1;
    for (int s = tid; s < H * W; s += T) mask_s[s] = 0u;
    const int colsum =
        live ? unrank_rank<M, T>(q_start + static_cast<int>(off), n, table,
                                 combo_s + tid)
             : 0;
    const float sign = radic_sign<M>(colsum);
    __syncthreads();
    // 1. each column of the rank takes the first slot from c mod H that
    //    is free or already holds c, and marks the rank in its mask.  The
    //    lanes of a warp that hold the same column at position j insert it
    //    once, through their lowest lane (integer atomics: the table's
    //    contents do not depend on their order, only which slot a column
    //    lands in does).  Every lane takes part in the warp intrinsics; a
    //    masked lane carries column -1 and inserts nothing.
    {
      const int lane = tid & 31;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const int c = live ? combo_s[j * T + tid] : -1;
        const unsigned grp = __match_any_sync(0xffffffffu, c);
        const int leader = __ffs(grp) - 1;
        int h = c & (H - 1);
        if (live && lane == leader) {
          for (;;) {
            const int old = atomicCAS(&key_s[h], -1, c);
            if (old == -1 || old == c) break;
            h = (h + 1) & (H - 1);
          }
          atomicOr(&mask_s[h * W + (tid >> 5)], grp);
        }
        h = __shfl_sync(grp, h, leader);
        if (live) slot_s[j * T + tid] = h;
      }
    }
    __syncthreads();
    // 2. a scan over the slots gives each column's list start and dense
    //    index
    int local = 0;
    for (int s = lo; s < hi; ++s) local += slot_value<W>(key_s, mask_s, s);
    int total;
    int run = block_exclusive_scan<T>(local, warp_s, total);
    for (int s = lo; s < hi; ++s) {
      const int v = slot_value<W>(key_s, mask_s, s);
      if (v) {
        const int d = run >> 16;
        sstart_s[s] = run & 0xFFFF;
        ucol_s[d] = key_s[s];
        ustart_s[d] = run & 0xFFFF;
        ulen_s[d] = v & 0xFFFF;
      }
      run += v;
    }
    const int D = total >> 16;  // distinct columns in the tile
    __syncthreads();
    // 3. each (rank, j) goes to its column's list at the number of the
    //    tile's lower ranks that hold the column: every list is in rank
    //    order.  An entry is the offset of its cofactor row in cof_s.
    if (live) {
      const int w = tid >> 5;
      const unsigned below = (1u << (tid & 31)) - 1u;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const int h = slot_s[j * T + tid];
        int pos = sstart_s[h] + __popc(mask_s[h * W + w] & below);
        for (int x = 0; x < w; ++x) pos += __popc(mask_s[h * W + x]);
        list_s[pos] = j * M * S + tid;
      }
    }
    for (int bb = 0; bb < nb; ++bb) {
      const float* A = A0 + static_cast<size_t>(bb) * mn;
      if (bb > 0) __syncthreads();  // owners are done with cof_s
      if (live)
        scaled_cofactors<M, T, S>(A, n, combo_s + tid, cts[b0 + bb] * sign,
                                  cof_s + tid);
      __syncthreads();
      // owners: item (column d, row r) adds the column's ranks in rank
      // order to its running partial; the M rows of a column are
      // neighbouring lanes, which read the same list entries and, through
      // the skew, different banks of cof_s
      float* pb = part + static_cast<size_t>(bb) * mn;
      for (int i = tid; i < D * M; i += T) {
        const int d = i / M;
        const int r = i - d * M;
        const float* cr = cof_s + r * S;
        const int* lst = list_s + ustart_s[d];
        const int len = ulen_s[d];
        float acc = 0.0f;
#pragma unroll 4
        for (int p = 0; p < len; ++p) acc += cr[lst[p]];
        pb[r * n + ucol_s[d]] += acc;
      }
    }
  }
}

// Which instances this translation unit has opted in, by m and device
// (each unit launches its own m: 1..13 or 14..16).
static OptInFlags grad_opted;

template <int M>
cudaError_t launch_grad(int grid, int B, cudaStream_t stream,
                        const float* As, const float* cts, int n,
                        const int* table, int q_start, long long count,
                        float* partials) {
  constexpr int T = grad_tile<M>();
  static_assert(grad_max_bytes<M>() + 4 * (T / 32) <= 232448,
                "K3's shared memory exceeds a block's 227 KB");
  const long long num_tiles = (count + T - 1) / T;
  const dim3 g(grid, (B + kBatchChunk - 1) / kBatchChunk);
  const int H = grad_slots(T, M, n);
  const int bytes = 4 * grad_smem_words(T, M, n);
  // opt in to the most any launch for this m can take, so that launches of
  // other sizes from other host threads never race on the attribute
  const cudaError_t e = opt_in_smem(
      grad_opted[M], radic_grad_partial_kernel<M, T>, grad_max_bytes<M>());
  if (e != cudaSuccess) return e;
  radic_grad_partial_kernel<M, T><<<g, T, bytes, stream>>>(
      As, cts, B, n, table, q_start, count, num_tiles, H, partials);
  return cudaGetLastError();
}

// The launch for m in 14..16 (radic_grad_wide.cu).
cudaError_t launch_grad_wide(int m, int grid, int B, cudaStream_t stream,
                             const float* As, const float* cts, int n,
                             const int* table, int q_start, long long count,
                             float* partials);

}  // namespace radic
