// Shared helpers of the binned-slot kernels.
//
// Layout (sph_pie_torch/neighbors/binned.py): slot i belongs to cell
// c = i / cap of a padded grid raveled row-major; the neighbour cells of c
// are, for each of the 3^(DIM-1) leading-axis offsets ("slabs"), the three
// contiguous cells c + shift - 1 .. c + shift + 1, i.e. 3*cap contiguous
// slots. Slots outside [0, S) count as empty.
#pragma once

#include <cuda_runtime.h>

namespace sph {

constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ T rsqrt_t(T x);
template <> __device__ __forceinline__ float rsqrt_t<float>(float x) { return rsqrtf(x); }
template <> __device__ __forceinline__ double rsqrt_t<double>(double x) { return rsqrt(x); }

template <typename T> __device__ __forceinline__ T max0(T x) { return x > T(0) ? x : T(0); }

// Flat cell shifts of the slabs, in the order of BinnedGrid.slab_shifts():
// the first leading axis outermost. s0, s1 are the padded-grid strides of
// the leading axes (s1 unused in 2D). Returns the slab count.
template <int DIM>
__device__ __forceinline__ int slab_shifts(long long s0, long long s1, long long* sh) {
  if (DIM == 2) {
    sh[0] = -s0; sh[1] = 0; sh[2] = s0;
    return 3;
  }
  int n = 0;
  for (int a = -1; a <= 1; ++a)
    for (int b = -1; b <= 1; ++b) sh[n++] = a * s0 + b * s1;
  return 9;
}

inline unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace sph
