// SPH density over the binned slots: rho_i = sum_j m_j W_poly6(|x_i - x_j|).
//
// Replaces three kernels of the JAX package with the same function in
// gather form: one thread per home slot loops over its cell's slab windows
// and sums m_j W(r) for every occupied window slot, the self pair giving
// W(0) naturally. Then, with MASK_VALID, 0 where the slot is not valid;
// then the floor max(rho, 1e-6 rho0). h^2, c6 and the floor come in prm,
// so each wrapper takes h from where its JAX function does.
//   * neighbors/pallas_sym.py density_sym (the main path, h = params.h) and
//     neighbors/pallas_pair.py density_pallas (h from the grid geometry):
//     MASK_VALID, as their wrappers mask before the floor;
//   * neighbors/pallas_density.py density_pallas (h = params.h): no mask,
//     so an empty slot (pos 0, mass 0) keeps whatever density its window
//     gives the origin, and is only floored.
//
// What bounds it on the H100: per home slot it reads 3^(DIM-1) windows of
// 3*cap slots (1080 at cap 40 in 3D), 16 bytes each, through L1/L2; the
// window of a cell is shared by the cap threads of that cell (neighbouring
// lanes of one warp), so the reads broadcast from cache and the kernel is
// bound by load instructions and latency, not by DRAM. The design keeps it
// simple: with MASK_VALID, empty home slots (most of the slots) exit at
// once; empty and out-of-range window slots are skipped before any math.
// Staging each slab's window in shared memory was measured slower than
// these L1 gathers with the mask and faster without it (PERF.md); staging
// the unmasked arm and pairs-once are later work.
#include "common.cuh"

namespace {

template <typename T, int DIM, bool MASK_VALID>
__global__ void __launch_bounds__(sph::kThreads)
density_kernel(const T* __restrict__ pos, const T* __restrict__ mass,
               const bool* __restrict__ valid, const T* __restrict__ prm,
               T* __restrict__ rho, long long S, int cap, long long s0,
               long long s1) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= S) return;
  const T h2 = prm[0], c6 = prm[1], floor_rho = prm[2];
  T acc = T(0);
  if (!MASK_VALID || mass[i] != T(0)) {  // masked: an empty home ends at 0
    T xi[DIM];
#pragma unroll
    for (int k = 0; k < DIM; ++k) xi[k] = pos[i * DIM + k];
    const long long c = i / cap;
    long long sh[9];
    const int ns = sph::slab_shifts<DIM>(s0, s1, sh);
    for (int s = 0; s < ns; ++s) {
      const long long j0 = (c + sh[s] - 1) * cap;
      const long long lo = j0 > 0 ? j0 : 0;
      const long long hi = j0 + 3 * cap < S ? j0 + 3 * cap : S;
      T part = T(0);
      for (long long j = lo; j < hi; ++j) {
        const T mj = mass[j];
        if (mj == T(0)) continue;  // empty slot: weight 0
        T d = xi[0] - pos[j * DIM];
        T r2 = d * d;
#pragma unroll
        for (int k = 1; k < DIM; ++k) {
          d = xi[k] - pos[j * DIM + k];
          r2 = r2 + d * d;
        }
        const T q = h2 - r2;
        if (q <= T(0)) continue;  // outside the support: W = 0 exactly
        part += mj * (c6 * q * q * q);
      }
      acc += part;
    }
  }
  if (MASK_VALID && !valid[i]) acc = T(0);
  rho[i] = acc < floor_rho ? floor_rho : acc;
}

template <typename T, int DIM, bool MASK_VALID>
void go(const T* p, const T* m, const bool* v, const T* c, T* out, long long S, int cap,
        long long s0, long long s1, cudaStream_t st) {
  density_kernel<T, DIM, MASK_VALID><<<sph::blocks_for(S), sph::kThreads, 0, st>>>(
      p, m, v, c, out, S, cap, s0, s1);
}

template <typename T>
int launch(const void* pos, const void* mass, const void* valid, const void* prm,
           void* rho, long long S, int cap, int dim, long long s0, long long s1,
           int mask_valid, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto p = static_cast<const T*>(pos);
  const auto m = static_cast<const T*>(mass);
  const auto v = static_cast<const bool*>(valid);
  const auto c = static_cast<const T*>(prm);
  const auto out = static_cast<T*>(rho);
  if (S == 0) return cudaGetLastError();
  if (dim == 2) {
    if (mask_valid) go<T, 2, true>(p, m, v, c, out, S, cap, s0, s1, st);
    else go<T, 2, false>(p, m, v, c, out, S, cap, s0, s1, st);
  } else if (dim == 3) {
    if (mask_valid) go<T, 3, true>(p, m, v, c, out, S, cap, s0, s1, st);
    else go<T, 3, false>(p, m, v, c, out, S, cap, s0, s1, st);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int sph_density_f32(const void* pos, const void* mass, const void* valid,
                               const void* prm, void* rho, long long S, int cap,
                               int dim, long long s0, long long s1, int mask_valid,
                               void* stream) {
  return launch<float>(pos, mass, valid, prm, rho, S, cap, dim, s0, s1, mask_valid, stream);
}

extern "C" int sph_density_f64(const void* pos, const void* mass, const void* valid,
                               const void* prm, void* rho, long long S, int cap,
                               int dim, long long s0, long long s1, int mask_valid,
                               void* stream) {
  return launch<double>(pos, mass, valid, prm, rho, S, cap, dim, s0, s1, mask_valid, stream);
}
