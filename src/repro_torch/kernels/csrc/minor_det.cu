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
//   * 17 <= m <= 32: one warp per matrix, lane i holding row i
//     (warp_det, warp.cuh; instances in minor_det_warp.cu);
//   * m > 32: one block per matrix, 256 threads over its rows and
//     entries; the matrix sits in shared memory while m^2 elements fit in
//     227 KB, and otherwise the block works on its copy in a global
//     scratch buffer the wrapper provides.
// B is masked, not padded.
#include <cuda_runtime.h>

#include "warp.cuh"

namespace radic {

// Largest staged tile of the m <= 16 kernel, in bytes (opted in per
// instance).
constexpr int kDetStageBytes = 232448;
constexpr int kDetBlockThreads = 256;       // threads of the m > 32 kernel
// Largest matrix of the m > 32 kernel kept in shared memory.
constexpr int kDetSmemBytes = 232448 - 1024;

// One element from global to shared memory (cp.async, completed by
// copy_wait before a barrier).
template <typename T>
__device__ __forceinline__ void copy_async_elem(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  }
#else
  *dst = *src;
#endif
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

// m > 32: one block per matrix, det_ge's steps on the matrix in shared
// memory (in_smem) or in work[b] (a global copy).
template <typename T>
__global__ void __launch_bounds__(kDetBlockThreads)
    minor_det_block_kernel(const T* __restrict__ mats, T* work, int m,
                           int in_smem, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T red_v[kDetBlockThreads / 32];
  __shared__ int red_p[kDetBlockThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t mm = static_cast<size_t>(m) * m;
  const size_t b = blockIdx.x;
  T* a = in_smem ? reinterpret_cast<T*>(smem) : work + b * mm;
  for (size_t e = tid; e < mm; e += kDetBlockThreads) a[e] = mats[b * mm + e];
  __syncthreads();
  T sign = T(1);
  for (int k = 0; k < m - 1; ++k) {
    // the first row >= k of largest |a[i][k]|: each thread scans its rows
    // in order, then (value, row) pairs reduce keeping the smaller row.
    // As in det_ge, row k wins unless a row beats it: a NaN in row k
    // counts as +inf, a NaN below never wins (thread 0 always holds row k,
    // so every step has a pivot)
    T best = T(-1);
    int p = k;
    for (int i = k + tid; i < m; i += kDetBlockThreads) {
      T v = abs_of(a[static_cast<size_t>(i) * m + k]);
      if (i == k && v != v) v = static_cast<T>(HUGE_VALF);
      if (v > best) {
        best = v;
        p = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T ob = __shfl_xor_sync(kFullMask, best, off);
      const int op = __shfl_xor_sync(kFullMask, p, off);
      pivot_max(best, p, ob, op);
    }
    if (lane == 0) {
      red_v[warp] = best;
      red_p[warp] = p;
    }
    __syncthreads();
    best = red_v[0];
    p = red_p[0];
#pragma unroll
    for (int w = 1; w < kDetBlockThreads / 32; ++w)
      pivot_max(best, p, red_v[w], red_p[w]);
    T* rk = a + static_cast<size_t>(k) * m;
    if (p != k) {
      sign = -sign;
      T* rp = a + static_cast<size_t>(p) * m;
      for (int j = k + tid; j < m; j += kDetBlockThreads) {
        const T top = rk[j];
        rk[j] = rp[j];
        rp[j] = top;
      }
    }
    __syncthreads();
    const T safe = (rk[k] == T(0)) ? T(1) : rk[k];
    const T inv = T(1) / safe;
    // the multipliers, kept where the column below the pivot was
    for (int i = k + 1 + tid; i < m; i += kDetBlockThreads) {
      T* ri = a + static_cast<size_t>(i) * m;
      ri[k] = quotient(ri[k], safe, inv);
    }
    __syncthreads();
    const int w = m - k - 1;
    for (int e = tid; e < w * w; e += kDetBlockThreads) {
      const int i = k + 1 + e / w;
      const int j = k + 1 + e % w;
      T* ri = a + static_cast<size_t>(i) * m;
      ri[j] -= ri[k] * rk[j];
    }
    __syncthreads();
  }
  if (tid == 0) {
    T prod = T(1);
    for (int i = 0; i < m; ++i) prod *= a[static_cast<size_t>(i) * m + i];
    out[b] = sign * prod;
  }
}

bool det_in_smem(int m, int elem) {
  return static_cast<long long>(m) * m * elem <= kDetSmemBytes;
}

static std::atomic<bool> det_block_opted[2][kMaxDevices];
static std::atomic<bool> det_tile_opted[2][kMaxM + 1][kMaxDevices];

template <typename T>
cudaError_t launch_minor_det(const T* mats, int B, int m, T* out, int block,
                             T* work, cudaStream_t s) {
  if (m > kMaxM && m <= 32) return launch_minor_det_warp(mats, B, m, out, s);
  if (m > 32) {
    const bool in_smem = det_in_smem(m, sizeof(T));
    if (!in_smem && work == nullptr) return cudaErrorInvalidValue;
    const int bytes = in_smem ? m * m * static_cast<int>(sizeof(T)) : 0;
    if (in_smem) {
      const cudaError_t e = opt_in_smem(det_block_opted[sizeof(T) == 8],
                                        minor_det_block_kernel<T>,
                                        kDetSmemBytes);
      if (e != cudaSuccess) return e;
    }
    minor_det_block_kernel<T><<<B, kDetBlockThreads, bytes, s>>>(
        mats, work, m, in_smem ? 1 : 0, out);
    return cudaGetLastError();
  }
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

// Elements of the global scratch the m > 32 kernel needs for B matrices
// (B * m^2 where a matrix does not fit in shared memory, else 0).
long long radic_minor_det_work_elems(int B, int m, int is_double) {
  using namespace radic;
  if (m <= 32 || det_in_smem(m, is_double ? 8 : 4)) return 0;
  return static_cast<long long>(B) * m * m;
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
