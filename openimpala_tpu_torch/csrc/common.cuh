// Shared helpers of the hand-written stencil kernels (K1, K2, K4, K5).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace oit {

// Threads of one block: 32 along Z (the contiguous axis, one warp per
// row of a plane) by 8 along Y.
constexpr int BZ = 32;
constexpr int BY = 8;

__host__ __device__ inline int64_t ceil_div(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

// Index of the neighbour at offset d (+-1) of cell i on an axis of extent
// n: wrapped on a periodic axis, -1 when it lies outside a clamped one.
__device__ __forceinline__ int64_t neighbour(int64_t i, int d, int64_t n,
                                             int periodic) {
  const int64_t j = i + d;
  if (j < 0) return periodic ? n - 1 : -1;
  if (j >= n) return periodic ? 0 : -1;
  return j;
}

// Fixed-order tree sum of one double per thread over a block of
// BZ * BY threads; thread 0 gets the total.  Deterministic: the order
// depends only on the thread index.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double s[BZ * BY];
  const int t = threadIdx.y * BZ + threadIdx.x;
  s[t] = v;
  __syncthreads();
  for (int h = BZ * BY / 2; h > 0; h >>= 1) {
    if (t < h) s[t] += s[t + h];
    __syncthreads();
  }
  return s[0];
}

// Second stage of a deterministic reduction: each block of 1024 threads
// sums the n per-block partials of one lane (block b: partials[b*n ..
// (b+1)*n)) in a fixed order and writes the total as total[b].  A launch
// with one block reduces one unbatched volume.
template <typename T>
__global__ void __launch_bounds__(1024)
    reduce_partials(const double* __restrict__ partials, int64_t n,
                    T* __restrict__ total) {
  __shared__ double s[1024];
  partials += static_cast<int64_t>(blockIdx.x) * n;
  double a = 0.0;
  for (int64_t i = threadIdx.x; i < n; i += 1024) a += partials[i];
  s[threadIdx.x] = a;
  __syncthreads();
  for (int h = 512; h > 0; h >>= 1) {
    if (threadIdx.x < h) s[threadIdx.x] += s[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) total[blockIdx.x] = static_cast<T>(s[0]);
}

}  // namespace oit
