// Center-slab poly6 density of every home slot, dense or compacted.
//
// Replaces the JAX package's scripts/micro_compact.py _make_arm with its
// two bodies: _dense_kernel sums m_j (c6 q) q q, q = max(h^2 - r^2, 0),
// over all 3*cap candidates of the cell's center-slab window (cells c-1,
// c, c+1; shift 0 only); _compact_kernel sums the same term over the first
// K candidates with r^2 < h^2 and m_j > 0, in window order (the TPU kernel
// ranks them with a lane cumsum and extracts pair k by a one-hot
// reduction). Inputs are the home pos [C, cap] per axis and the window pos
// and mass [C, 3*cap] (``micro/center_slab.py`` center_slab_inputs). No
// valid mask and no floor, as the arms have none: an empty home slot at
// pos 0 gets what its window gives the origin.
//
// One thread per home slot walks its window in order; the compact arm
// stops at the K-th candidate in support, which is the first-K rule
// exactly. r^2 is built from separately rounded products and sums (no
// fused multiply-add), as the plain version builds it, so the strict
// r^2 < h^2 test picks the same candidates in both. What bounds it: 3*cap
// window reads of 16 bytes per home slot, shared by the cap threads of a
// cell through L1 -- load-bound, as the dense fold is; the compact arm
// saves the tail of the window only where more than K candidates are in
// support.
#include "common.cuh"

namespace {

template <bool COMPACT>
__global__ void __launch_bounds__(sph::kThreads)
center_slab_kernel(const float* __restrict__ hx, const float* __restrict__ hy,
                   const float* __restrict__ hz, const float* __restrict__ wx,
                   const float* __restrict__ wy, const float* __restrict__ wz,
                   const float* __restrict__ wm, float* __restrict__ out,
                   long long n, int cap, float h2, float c6, int K) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const long long w0 = (i / cap) * 3 * cap;
  const float xi = hx[i], yi = hy[i], zi = hz[i];
  float acc = 0.f;
  int taken = 0;
  for (int l = 0; l < 3 * cap; ++l) {
    const long long j = w0 + l;
    const float dx = __fsub_rn(wx[j], xi);
    const float dy = __fsub_rn(wy[j], yi);
    const float dz = __fsub_rn(wz[j], zi);
    const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    const float m = wm[j];
    const float q = fmaxf(h2 - r2, 0.f);
    const float term = c6 * q * q * q * m;
    if (COMPACT) {
      if (r2 < h2 && m > 0.f) {
        acc += term;
        if (++taken == K) break;
      }
    } else {
      acc += term;
    }
  }
  out[i] = acc;
}

}  // namespace

// K == 0 runs the dense arm, K > 0 the compact arm with that K.
extern "C" int sph_center_slab_f32(const void* hx, const void* hy, const void* hz,
                                   const void* wx, const void* wy, const void* wz,
                                   const void* wm, void* out, long long n, int cap,
                                   float h2, float c6, int K, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto o = static_cast<float*>(out);
  if (n == 0) return cudaGetLastError();
  if (cap < 1 || K < 0) return cudaErrorInvalidValue;
  if (K > 0) {
    center_slab_kernel<true><<<sph::blocks_for(n), sph::kThreads, 0, st>>>(
        f(hx), f(hy), f(hz), f(wx), f(wy), f(wz), f(wm), o, n, cap, h2, c6, K);
  } else {
    center_slab_kernel<false><<<sph::blocks_for(n), sph::kThreads, 0, st>>>(
        f(hx), f(hy), f(hz), f(wx), f(wy), f(wz), f(wm), o, n, cap, h2, c6, 0);
  }
  return cudaGetLastError();
}
