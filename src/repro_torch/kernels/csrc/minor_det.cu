// Batched determinants on Hopper: mats (B, m, m) -> (B,), by Gaussian
// elimination with partial pivoting (det_ge, common.cuh: strict '>'
// pivot rule, a zero pivot gives det 0), for every m.
//
// Replaces repro/kernels/minor_det.py:23 minor_det_kernel (K6), which
// computes in the input dtype: here float64 input computes in float64 and
// float32 in float32 (the wrapper brings narrower floats to float32).
//
// What bounds it: bytes at m <= 16 (each matrix is read once, 4m^2 bytes
// in float32, for about 2m^3/3 flops: at m = 8, 256 bytes for 317 flops);
// the elimination's operations at larger m.  Three designs by m:
//   * m <= 16: one thread per matrix, the matrix in registers (m a
//     template parameter), det_ge as in the Radic kernels.  The block's
//     tile of matrices is one contiguous span of global memory; the block
//     copies it into shared memory with coalesced cp.async (neighbouring
//     threads, neighbouring words), each matrix at a stride of m^2 + 1
//     elements, so that thread t reading its own matrix hits a bank no
//     other lane of its warp hits (at m = 8 a stride of 64 words would put
//     all 32 lanes on one bank); then each thread loads its matrix from
//     there.  Matrices per block: the wrapper's tile.  A tile that
//     passes kDetStageBytes (at m = 16 in float64: 128 x 257 x 8 bytes)
//     is not staged: each thread then reads its matrix from global memory
//     directly;
//   * 17 <= m <= 64: one warp per matrix, lane i holding row i (and row
//     i + 32), at m = 32 each warp copying its next matrix into shared
//     memory behind the current one (minor_det_warp.cuh; instances in
//     minor_det_warp.cu, minor_det_warp_hi.cu and minor_det_warp_top.cu);
//   * above: one block per matrix, det_ge's steps in panels of 8 or 16
//     (minor_det_block_kernel); the matrix sits in shared memory while it
//     fits in 227 KB beside the panel's multipliers, and otherwise the
//     block works on its copy in a global scratch buffer the wrapper
//     provides.
// B is masked, not padded.
#include <cuda_runtime.h>

#include "warp.cuh"

namespace radic {

// Largest staged tile of the m <= 16 kernel, in bytes (opted in per
// instance).
constexpr int kDetStageBytes = 232448;
constexpr int kDetBlockThreads = 256;       // threads of the block kernel
// Shared memory the block kernel may use (its matrix and side arrays).
constexpr int kDetSmemBytes = 232448 - 1024;
// Its steps a panel: 8 below m = 128, 16 from there (kernel_ab.py
// k6_panel: the narrower panel wins where there are few trailing
// columns, the wider one where the trailing matrix's traffic counts)
__host__ __device__ constexpr int det_panel(int m) { return m < 128 ? 8 : 16; }
// Where the block kernel keeps a matrix and its side arrays (det_placing)
constexpr int kDetAllShared = 0;
constexpr int kDetSideShared = 1;
constexpr int kDetAllGlobal = 2;

// The side arrays' bytes: a panel's multipliers, the rows' places.
__host__ __device__ constexpr long long det_side_bytes(int m, int elem) {
  return static_cast<long long>(m) * det_panel(m) * elem + 8LL * m;
}

// n elements rounded up to a multiple of 16 bytes: what follows them in
// the scratch (the multipliers, read as 16-byte vectors, and the next
// matrix's copy) starts on a 16-byte boundary at every m.
__host__ __device__ constexpr long long det_round16(long long n, int elem) {
  return (n * elem + 15) / 16 * 16 / elem;
}

// Elements of the global scratch a matrix takes (its copy, and its side
// arrays where they pass shared memory).
__host__ __device__ constexpr long long det_work_per_matrix(int m, int elem,
                                                            int placing) {
  return placing == kDetAllShared ? 0
         : det_round16(static_cast<long long>(m) * m, elem) +
               (placing == kDetAllGlobal
                    ? det_round16((det_side_bytes(m, elem) + elem - 1) / elem,
                                  elem)
                    : 0);
}

template <int M, typename T>
__global__ void minor_det_kernel(const T* __restrict__ mats, int B,
                                 int staged, T* __restrict__ out) {
  constexpr int MM = M * M;
  constexpr int S = MM + 1;  // a matrix's stride in the staged tile
  extern __shared__ __align__(16) unsigned char smem[];
  const long long b0 = static_cast<long long>(blockIdx.x) * blockDim.x;
  const long long b = b0 + threadIdx.x;
  T a[M][M];
  if (staged) {
    T* tile = reinterpret_cast<T*>(smem);
    const int nb = static_cast<int>(min(static_cast<long long>(blockDim.x),
                                        static_cast<long long>(B) - b0));
    const T* src = mats + b0 * MM;
    // element e of the span is entry e - t m^2 of matrix t = e / m^2, at
    // t S + e - t m^2 = e + t in the tile
    for (int e = threadIdx.x; e < nb * MM; e += blockDim.x)
      copy_async_elem(tile + e + e / MM, src + e);
    copy_wait();
    __syncthreads();
    if (b >= B) return;
    const T* mine = tile + threadIdx.x * S;
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) a[i][j] = mine[i * M + j];
  } else {
    if (b >= B) return;
    const T* src = mats + b * MM;
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) a[i][j] = src[i * M + j];
  }
  out[b] = det_ge<M>(a);
}

// Past the warp kernels: one block per matrix, det_ge's steps in panels
// of NB columns (a right-looking blocked elimination) on the
// matrix in shared memory or in the global scratch (det_placing).  What
// bounds the one-step form is the matrix's traffic: every step reads and
// writes the whole trailing matrix (83 MB at m = 250 in float64, which
// is larger than an SM's registers and shared memory together).  Here
// rows never move (pos[r] is row r's place, row_at[i] the row at place
// i, swapped as det_ge swaps rows), and a panel's steps run on its own
// columns first: warp 0 finds each step's pivot (the first place of the
// largest magnitude, det_ge's NaN rule) and writes every remaining row's
// multiplier into shared memory, then the block updates the panel's
// later columns.  Then each thread takes trailing columns of its own: it
// brings the panel's pivot rows up to date in registers, and updates
// each remaining row's entry by the panel's steps in order, one read
// and one write of the entry a panel.  Every entry takes det_ge's
// updates, with the same multipliers and pivot-row values, in the same
// order; the pivots' product is taken in step order, as det_ge takes its
// diagonal.  Two barriers a step, and one a panel.
template <int NB, typename T>
__global__ void __launch_bounds__(kDetBlockThreads)
    minor_det_block_kernel(const T* __restrict__ mats, T* work, int m,
                           int placing, T* __restrict__ out) {
  using V = Vec16<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int piv_row[NB];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t mm = static_cast<size_t>(m) * m;
  const size_t b = blockIdx.x;
  // F[r * NB + s]: row r's multiplier at the panel's step s, then the
  // rows' places, in shared memory (with the matrix, or alone) or, past
  // its size, beside the matrix's copy in work
  T* w = work + b * det_work_per_matrix(m, sizeof(T), placing);
  T* F = placing == kDetAllGlobal ? w + det_round16(mm, sizeof(T))
                                  : reinterpret_cast<T*>(smem);
  int* pos = reinterpret_cast<int*>(F + static_cast<size_t>(m) * NB);
  int* row_at = pos + m;
  T* a = placing == kDetAllShared ? reinterpret_cast<T*>(row_at + m) : w;
  for (size_t e = tid; e < mm; e += kDetBlockThreads) a[e] = mats[b * mm + e];
  for (int r = tid; r < m; r += kDetBlockThreads) pos[r] = row_at[r] = r;
  __syncthreads();
  T sign = T(1);  // thread 0's
  T prod = T(1);
  for (int k0 = 0; k0 < m; k0 += NB) {
    const int k1 = min(k0 + NB, m);
    for (int k = k0; k < k1; ++k) {
      if (tid < 32) {
        // the first place >= k of the largest |a[.][k]|, as det_ge finds
        // it: the row at place k wins unless a row beats it, its NaN
        // counting as +inf, a NaN elsewhere never winning
        const int q = row_at[k];
        T best = T(-1);
        int at = m;  // the best one's place
        for (int r = lane; r < m; r += 32) {
          const int pr = pos[r];
          if (pr < k) continue;
          T v = abs_of(a[static_cast<size_t>(r) * m + k]);
          if (r == q && v != v) v = static_cast<T>(HUGE_VALF);
          if (v > best || (v == best && pr < at)) {
            best = v;
            at = pr;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const T ob = __shfl_xor_sync(kFullMask, best, off);
          const int oat = __shfl_xor_sync(kFullMask, at, off);
          pivot_max(best, at, ob, oat);
        }
        const int p = row_at[at];
        const T piv = a[static_cast<size_t>(p) * m + k];
        const T safe = (piv == T(0)) ? T(1) : piv;
        const T inv = T(1) / safe;
        for (int r = lane; r < m; r += 32)
          if (pos[r] >= k && r != p)
            F[r * NB + (k - k0)] =
                quotient(a[static_cast<size_t>(r) * m + k], safe, inv);
        __syncwarp();
        if (lane == 0) {
          pos[q] = at;
          pos[p] = k;
          row_at[at] = q;
          row_at[k] = p;
          piv_row[k - k0] = p;
          if (at != k) sign = -sign;
          prod *= piv;
        }
      }
      __syncthreads();
      // the panel's columns past k, on the rows at places > k
      const int w = k1 - k - 1;
      if (w > 0) {
        const int p = piv_row[k - k0];
        const int rows = kDetBlockThreads / w;
        const int j = k + 1 + tid % w;
        const T* rp = a + static_cast<size_t>(p) * m;
        if (tid / w < rows) {
          const T top = rp[j];
          for (int r = tid / w; r < m; r += rows) {
            T* ar = a + static_cast<size_t>(r) * m;
            if (pos[r] > k) ar[j] = ar[j] - F[r * NB + (k - k0)] * top;
          }
        }
        __syncthreads();
      }
    }
    // the trailing columns, each by one thread or, where there are fewer
    // columns than threads, by `groups` threads splitting its rows: the
    // panel's pivot rows brought up to date (top), then every row left by
    // the panel's steps
    const int ns = k1 - k0;
    const int cols = m - k1;
    const int groups =
        cols > 0 && cols < kDetBlockThreads ? kDetBlockThreads / cols : 1;
    const int group = groups > 1 ? tid / cols : 0;
    for (int j = k1 + (groups > 1 ? tid % cols : tid);
         j < m && group < groups; j += kDetBlockThreads) {
      T top[NB];
#pragma unroll
      for (int s = 0; s < NB; ++s) {
        if (s < ns) {
          const int p = piv_row[s];
          T v = a[static_cast<size_t>(p) * m + j];
#pragma unroll
          for (int t = 0; t < s; ++t) v = v - F[p * NB + t] * top[t];
          top[s] = v;
        }
      }
      for (int r = group; r < m; r += groups) {
        if (pos[r] < k1) continue;  // a pivot row of this panel or before
        T f[NB];
#pragma unroll
        for (int s = 0; s < NB; s += V::n)
          V::unpack(*reinterpret_cast<const typename V::type*>(
                        F + r * NB + s), f + s);
        T* e = a + static_cast<size_t>(r) * m + j;
        T v = *e;
#pragma unroll
        for (int s = 0; s < NB; ++s)
          if (s < ns) v = v - f[s] * top[s];
        *e = v;
      }
    }
    __syncthreads();
  }
  if (tid == 0) out[b] = sign * prod;
}

// Where the block kernel keeps the matrix and its side arrays (a panel's
// multipliers and the rows' places): all in shared memory, the side
// arrays only, or none (both then in the global scratch).
int det_placing(int m, int elem) {
  const long long side = det_side_bytes(m, elem);
  if (static_cast<long long>(m) * m * elem + side <= kDetSmemBytes)
    return kDetAllShared;
  return side <= kDetSmemBytes ? kDetSideShared : kDetAllGlobal;
}

static std::atomic<bool> det_block_opted[2][2][kMaxDevices];

// The block kernel at its panel width NB (det_panel(m)).
template <int NB, typename T>
cudaError_t launch_block(const T* mats, int B, int m, T* out, T* work,
                         cudaStream_t s) {
  const int placing = det_placing(m, sizeof(T));
  if (placing != kDetAllShared && work == nullptr)
    return cudaErrorInvalidValue;
  const long long bytes =
      placing == kDetAllGlobal
          ? 0
          : det_side_bytes(m, sizeof(T)) +
                (placing == kDetAllShared
                     ? static_cast<long long>(m) * m * sizeof(T) : 0);
  const cudaError_t e =
      opt_in_smem(det_block_opted[sizeof(T) == 8][NB == 16],
                  minor_det_block_kernel<NB, T>, kDetSmemBytes);
  if (e != cudaSuccess) return e;
  minor_det_block_kernel<NB, T><<<B, kDetBlockThreads, bytes, s>>>(
      mats, work, m, placing, out);
  return cudaGetLastError();
}

static std::atomic<bool> det_tile_opted[2][kMaxM + 1][kMaxDevices];

template <typename T>
cudaError_t launch_minor_det(const T* mats, int B, int m, T* out, int block,
                             T* work, cudaStream_t s) {
  if (m > kMaxM && m <= kWarpMaxM)
    return launch_minor_det_warp(mats, B, m, out, s);
  if (m > kWarpMaxM && m <= kDetHiMaxM)
    return launch_minor_det_warp_hi(mats, B, m, out, s);
  if (m > kDetHiMaxM && m <= kDetWarpMaxM)
    return launch_minor_det_warp_top(mats, B, m, out, s);
  if (m > kDetWarpMaxM)
    return det_panel(m) == 8 ? launch_block<8>(mats, B, m, out, work, s)
                             : launch_block<16>(mats, B, m, out, work, s);
  const unsigned grid =
      static_cast<unsigned>((static_cast<long long>(B) + block - 1) / block);
  const int bytes = block * (m * m + 1) * static_cast<int>(sizeof(T));
  const bool staged = bytes <= kDetStageBytes;
  const int is_double = sizeof(T) == 8;
  switch (m) {
#define MINOR_CASE(MM)                                                     \
  case MM:                                                                 \
    if (staged) {                                                          \
      const cudaError_t e = opt_in_smem(det_tile_opted[is_double][MM],     \
                                        minor_det_kernel<MM, T>,           \
                                        kDetStageBytes);                   \
      if (e != cudaSuccess) return e;                                      \
    }                                                                      \
    minor_det_kernel<MM, T><<<grid, block, staged ? bytes : 0, s>>>(       \
        mats, B, staged ? 1 : 0, out);                                     \
    break;
    MINOR_CASE(1) MINOR_CASE(2) MINOR_CASE(3) MINOR_CASE(4) MINOR_CASE(5)
    MINOR_CASE(6) MINOR_CASE(7) MINOR_CASE(8) MINOR_CASE(9) MINOR_CASE(10)
    MINOR_CASE(11) MINOR_CASE(12) MINOR_CASE(13) MINOR_CASE(14)
    MINOR_CASE(15) MINOR_CASE(16)
#undef MINOR_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace radic

extern "C" {

// Elements of the global scratch the block kernel needs for B matrices
// (each matrix's copy, and its side arrays, where they pass shared
// memory; else 0).
long long radic_minor_det_work_elems(int B, int m, int is_double) {
  using namespace radic;
  const int elem = is_double ? 8 : 4;
  if (m <= kDetWarpMaxM || det_placing(m, elem) == kDetAllShared) return 0;
  return static_cast<long long>(B) *
         det_work_per_matrix(m, elem, det_placing(m, elem));
}

// mats: (B, m, m) contiguous, float32 (is_double = 0) or float64
// (is_double = 1); out: (B,) of the same type; block: matrices per block
// at m <= 16; work: radic_minor_det_work_elems elements of the same type
// (or null where that is 0).  Returns the CUDA error code of the launch
// (0 on success).
int radic_minor_det(const void* mats, int B, int m, int is_double,
                    void* out, int block, void* work, void* stream) {
  using namespace radic;
  if (B < 1 || m < 1 || block < 1 || block > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_double ? launch_minor_det(static_cast<const double*>(mats), B, m,
                                   static_cast<double*>(out), block,
                                   static_cast<double*>(work), s)
                : launch_minor_det(static_cast<const float*>(mats), B, m,
                                   static_cast<float*>(out), block,
                                   static_cast<float*>(work), s);
  return static_cast<int>(e);
}

}  // extern "C"
