// Pressure, viscosity, cohesion and XSPH sums over the binned slots.
//
// Replaces the JAX package's neighbors/pallas_pair.py forces_pallas
// (_build_forces) -- the forces phase, which the reference ran as the XLA
// fold solvers/wcsph_binned.py _forces with the same per-pair math. One
// thread per home slot i, gather form, cap-general:
//
//   inv_r  = rsqrt(max(r^2, 1e-12)),  r = r^2 inv_r,  q = max(h - r, 0)
//   radial = [m_j (pr2_i + pr2_j) C_s q^2 + st m_j C(r)] inv_r
//   acc_i -= sum radial d          acc_i += mu/rho_i sum m_rho_j C_v q dv
//   xsph_i += sum m_rho_j W_poly6(r^2) dv           (d = x_i - x_j, dv = v_j - v_i)
//
// with the per-slot inv_rho, pr2 = p/rho^2 and m_rho = m/rho computed once
// by the wrapper. Each slab's partial sums are added as the fold adds them.
// Home slots that are not valid write 0.
//
// What bounds it on the H100: per occupied home slot, 3^(DIM-1) windows of
// 3*cap slots, 9 values (36 bytes in f32) per window slot, read through
// L1/L2 and shared by the cap threads of a cell (broadcast within a warp):
// load-instruction and latency bound, not DRAM bound, with about 60 flops
// per pair inside the support. The design skips empty window slots and
// pairs beyond the support (r^2 >= h^2, where every term is 0 up to the
// rounding of rsqrt) before any of that math. Window staging in shared
// memory and pairs-once are later work.
#include "common.cuh"

namespace {

template <typename T, int DIM, bool COH, bool XSPH>
__global__ void __launch_bounds__(sph::kThreads)
forces_kernel(const T* __restrict__ pos, const T* __restrict__ vel,
              const T* __restrict__ mass, const T* __restrict__ pr2,
              const T* __restrict__ m_rho, const T* __restrict__ inv_rho,
              const T* __restrict__ prm, T* __restrict__ acc_out,
              T* __restrict__ xsph_out, long long S, int cap, long long s0,
              long long s1) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= S) return;
  T acc[DIM], xs[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) acc[k] = xs[k] = T(0);

  if (mass[i] != T(0)) {
    const T h = prm[0], cs = prm[1], cv = prm[2], c6 = prm[3], kc = prm[4];
    const T h6_64 = prm[5], mu = prm[6], st = prm[7];
    const T h2 = h * h, half_h = T(0.5) * h, tiny = T(1e-12);
    T xi[DIM], vi[DIM];
#pragma unroll
    for (int k = 0; k < DIM; ++k) {
      xi[k] = pos[i * DIM + k];
      vi[k] = vel[i * DIM + k];
    }
    const T pr2_i = pr2[i];
    const T mu_i = mu * inv_rho[i];
    const long long c = i / cap;
    long long sh[9];
    const int ns = sph::slab_shifts<DIM>(s0, s1, sh);
    for (int s = 0; s < ns; ++s) {
      const long long j0 = (c + sh[s] - 1) * cap;
      const long long lo = j0 > 0 ? j0 : 0;
      const long long hi = j0 + 3 * cap < S ? j0 + 3 * cap : S;
      T sr[DIM], sv[DIM], sx[DIM];
#pragma unroll
      for (int k = 0; k < DIM; ++k) sr[k] = sv[k] = sx[k] = T(0);
      for (long long j = lo; j < hi; ++j) {
        const T mj = mass[j];
        if (mj == T(0)) continue;  // empty slot: every term has weight 0
        T d[DIM];
        d[0] = xi[0] - pos[j * DIM];
        T r2 = d[0] * d[0];
#pragma unroll
        for (int k = 1; k < DIM; ++k) {
          d[k] = xi[k] - pos[j * DIM + k];
          r2 = r2 + d[k] * d[k];
        }
        if (r2 >= h2) continue;  // outside the support
        const T inv_r = sph::rsqrt_t<T>(r2 > tiny ? r2 : tiny);
        const T r = r2 * inv_r;
        const T q = sph::max0(h - r);
        const T gw = cs * q * q;
        T radial = mj * (pr2_i + pr2[j]) * gw;
        if (COH) {
          const T hr3 = q * q * q;
          const T r3 = r * r * r;
          const T cc = r <= half_h ? T(2) * hr3 * r3 - h6_64 : hr3 * r3;
          const T coh = (r > T(0) && r < h) ? kc * cc : T(0);
          radial = radial + st * mj * coh;
        }
        radial = radial * inv_r;
        const T mr = m_rho[j];
        const T vw = mr * (cv * q);
        T xw = T(0);
        if (XSPH) {
          const T q6 = sph::max0(h2 - r2);
          xw = mr * (c6 * q6 * q6 * q6);
        }
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          const T dv = vel[j * DIM + k] - vi[k];
          sr[k] += radial * d[k];
          sv[k] += vw * dv;
          if (XSPH) sx[k] += xw * dv;
        }
      }
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        acc[k] = acc[k] - sr[k] + mu_i * sv[k];
        xs[k] += sx[k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    acc_out[i * DIM + k] = acc[k];
    xsph_out[i * DIM + k] = xs[k];
  }
}

template <typename T, int DIM, bool COH, bool XSPH>
void go(const T* p, const T* v, const T* m, const T* pr2, const T* mr, const T* ir,
        const T* prm, T* acc, T* xsph, long long S, int cap, long long s0,
        long long s1, cudaStream_t st) {
  forces_kernel<T, DIM, COH, XSPH><<<sph::blocks_for(S), sph::kThreads, 0, st>>>(
      p, v, m, pr2, mr, ir, prm, acc, xsph, S, cap, s0, s1);
}

template <typename T, int DIM>
void dispatch_terms(bool coh, bool xsph, const T* p, const T* v, const T* m,
                    const T* pr2, const T* mr, const T* ir, const T* prm, T* a,
                    T* x, long long S, int cap, long long s0, long long s1,
                    cudaStream_t st) {
  if (coh && xsph) go<T, DIM, true, true>(p, v, m, pr2, mr, ir, prm, a, x, S, cap, s0, s1, st);
  else if (coh) go<T, DIM, true, false>(p, v, m, pr2, mr, ir, prm, a, x, S, cap, s0, s1, st);
  else if (xsph) go<T, DIM, false, true>(p, v, m, pr2, mr, ir, prm, a, x, S, cap, s0, s1, st);
  else go<T, DIM, false, false>(p, v, m, pr2, mr, ir, prm, a, x, S, cap, s0, s1, st);
}

template <typename T>
int launch(const void* pos, const void* vel, const void* mass, const void* pr2,
           const void* m_rho, const void* inv_rho, const void* prm, void* acc,
           void* xsph, long long S, int cap, int dim, long long s0, long long s1,
           int use_cohesion, int use_xsph, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto p = static_cast<const T*>(pos);
  const auto v = static_cast<const T*>(vel);
  const auto m = static_cast<const T*>(mass);
  const auto q = static_cast<const T*>(pr2);
  const auto mr = static_cast<const T*>(m_rho);
  const auto ir = static_cast<const T*>(inv_rho);
  const auto c = static_cast<const T*>(prm);
  const auto a = static_cast<T*>(acc);
  const auto x = static_cast<T*>(xsph);
  if (S == 0) return cudaGetLastError();
  if (dim == 2) {
    dispatch_terms<T, 2>(use_cohesion, use_xsph, p, v, m, q, mr, ir, c, a, x, S, cap, s0, s1, st);
  } else if (dim == 3) {
    dispatch_terms<T, 3>(use_cohesion, use_xsph, p, v, m, q, mr, ir, c, a, x, S, cap, s0, s1, st);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int sph_forces_f32(const void* pos, const void* vel, const void* mass,
                              const void* pr2, const void* m_rho, const void* inv_rho,
                              const void* prm, void* acc, void* xsph, long long S,
                              int cap, int dim, long long s0, long long s1,
                              int use_cohesion, int use_xsph, void* stream) {
  return launch<float>(pos, vel, mass, pr2, m_rho, inv_rho, prm, acc, xsph, S, cap,
                       dim, s0, s1, use_cohesion, use_xsph, stream);
}

extern "C" int sph_forces_f64(const void* pos, const void* vel, const void* mass,
                              const void* pr2, const void* m_rho, const void* inv_rho,
                              const void* prm, void* acc, void* xsph, long long S,
                              int cap, int dim, long long s0, long long s1,
                              int use_cohesion, int use_xsph, void* stream) {
  return launch<double>(pos, vel, mass, pr2, m_rho, inv_rho, prm, acc, xsph, S, cap,
                        dim, s0, s1, use_cohesion, use_xsph, stream);
}
