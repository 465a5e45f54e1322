// Pressure, viscosity, cohesion and XSPH sums over the binned slots.
//
// Replaces the JAX package's neighbors/pallas_pair.py forces_pallas
// (_build_forces) -- the forces phase, which the reference ran as the XLA
// fold solvers/wcsph_binned.py _forces with the same per-pair math. Gather
// form, cap-general, for each occupied home slot i:
//
//   inv_r  = rsqrt(max(r^2, 1e-12)),  r = r^2 inv_r,  q = max(h - r, 0)
//   radial = [m_j (pr2_i + pr2_j) C_s q^2 + st m_j C(r)] inv_r
//   acc_i -= sum radial d          acc_i += mu/rho_i sum m_rho_j C_v q dv
//   xsph_i += sum m_rho_j W_poly6(r^2) dv           (d = x_i - x_j, dv = v_j - v_i)
//
// with the per-slot inv_rho, pr2 = p/rho^2 and m_rho = m/rho computed once
// by the wrapper. Each slab's partial sums are added as the fold adds them.
// Home slots with mass 0 write 0.
//
// What bounds it on the H100. Not DRAM: the function reads 36 bytes per slot
// (pos, vel, mass, density, pressure) and writes 24 (0.19 ms for the 10.7M
// slots of the 1M dam break at 3.35 TB/s), and its ~30 pairs in support per
// particle at 56 flops are 1.7 GFLOP (0.025 ms at 67 TFLOP/s). The walk over
// candidates and the pair math, which the lanes of a warp run whenever one
// of them has a pair in support, bound it. The first design (one thread per
// slot over all 10.7M slots, 9.3% occupied) gave every live thread all
// 9 x 3 x 40 = 1080 window slots, ~45% empty, ~97% of the rest beyond h,
// with scalar global loads of mass and x, y, z for each, and warps split
// across two cells: 3.11 ms on the 1M dam break.
//
// This design (forces_runs) is density.cu's: one CTA per run of R cells
// along the contiguous axis; an all-empty run writes zeros and exits before
// any barrier; one thread per occupied home slot; for each slab the run's
// (R+2)-cell window of pos and mass is bulk-copied into shared memory
// (cp.async.bulk on an mbarrier, double-buffered: slab s+2 in flight while
// s is packed and walked) and packed by warp ballot into (x, y, z, m)
// records of the occupied slots, beside (vx, vy, vz, pr2) records and m_rho
// read from global memory for those slots only (staging vel, pr2 and m_rho
// for every window slot too was measured slower: PERF.md). Each home thread
// walks only the records of its 3 window cells, 32 at a time: first the
// r^2 test of each, into a bit mask, then the pair math of the candidates in
// support, in slot order -- so the lanes of a warp, whose candidates are
// mostly the same records, run the pair math together (measured faster than
// the math inside the test loop). The velocity record is read only for a
// pair in support, inv_rho for the home slot only. Summation order as the
// first design.
#include "common.cuh"

namespace {

// r^2 of a home and a packed candidate, in the first design's order.
template <typename T, int DIM>
__device__ __forceinline__ T r2_of(const sph::Rec<T>& xi, const sph::Rec<T>& p) {
  T d = xi.v[0] - p.v[0];
  T r2 = d * d;
#pragma unroll
  for (int e = 1; e < DIM; ++e) {
    d = xi.v[e] - p.v[e];
    r2 = r2 + d * d;
  }
  return r2;
}

// Shared memory of one run: W = (R+2)*cap window slots, H = R*cap home slots.
template <typename T, int DIM>
struct RunSmem {
  uint64_t* bar;       // [2] one mbarrier per stage
  T* pos[2];           // [W*DIM] staged window positions
  T* mass[2];          // [W] staged window masses
  sph::Rec<T>* prec;   // [W] packed (x, y, z, m) of the occupied window slots
  sph::Rec<T>* vrec;   // [W] packed (vx, vy, vz, pr2)
  T* mr;               // [W] packed m_rho
  int* start;          // [R+3] first record of each window cell
  unsigned* wmask;     // [W/32] occupancy of the stage being packed
  unsigned* hmask;     // [H/32] occupancy of the home slots
  int* hidx;           // [H] home slot -> home record, -1 if empty
  int* hcell;          // [H] home record -> run cell
  sph::Rec<T>* hx;     // [H] home (x, y, z, pr2)
  sph::Rec<T>* hv;     // [H] home (vx, vy, vz, mu / rho)
  T* hacc;             // [H*DIM]
  T* hxs;              // [H*DIM]
  __host__ __device__ RunSmem(sph::Carve& c, int R, int cap) {
    const int W = (R + 2) * cap, H = R * cap;
    bar = c.take<uint64_t>(2);
    for (int b = 0; b < 2; ++b) {
      pos[b] = c.take<T>(static_cast<long long>(W) * DIM);
      mass[b] = c.take<T>(W);
    }
    prec = c.take<sph::Rec<T>>(W);
    vrec = c.take<sph::Rec<T>>(W);
    mr = c.take<T>(W);
    start = c.take<int>(R + 3);
    wmask = c.take<unsigned>((W + 31) / 32);
    hmask = c.take<unsigned>((H + 31) / 32);
    hidx = c.take<int>(H);
    hcell = c.take<int>(H);
    hx = c.take<sph::Rec<T>>(H);
    hv = c.take<sph::Rec<T>>(H);
    hacc = c.take<T>(static_cast<long long>(H) * DIM);
    hxs = c.take<T>(static_cast<long long>(H) * DIM);
  }
};

template <typename T, int DIM, bool COH, bool XSPH>
__global__ void __launch_bounds__(sph::kRunThreads)
forces_runs(const T* __restrict__ pos, const T* __restrict__ vel,
            const T* __restrict__ mass, const T* __restrict__ pr2,
            const T* __restrict__ m_rho, const T* __restrict__ inv_rho,
            const T* __restrict__ prm, T* __restrict__ acc_out,
            T* __restrict__ xsph_out, long long S, int cap, int R, long long s0,
            long long s1, long long c_first, long long c_end) {
  const long long c0 = c_first + static_cast<long long>(blockIdx.x) * R;
  const long long base = c0 * cap;  // first home slot
  const long long out0 = base - c_first * cap;  // its row in acc and xsph
  const long long left = (c_end - c0) * cap;
  const int H = static_cast<int>(left < static_cast<long long>(R) * cap
                                     ? left : static_cast<long long>(R) * cap);
  if (sph::warp_all_zero(mass + base, H)) {  // empty run: zeros
    for (int e = threadIdx.x; e < H * DIM; e += blockDim.x) {
      acc_out[out0 * DIM + e] = T(0);
      xsph_out[out0 * DIM + e] = T(0);
    }
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  sph::Carve carve(smem_raw);
  const RunSmem<T, DIM> sm(carve, R, cap);
  const int W = (R + 2) * cap, nchW = (W + 31) / 32, nchH = (H + 31) / 32;
  const int warp = threadIdx.x >> 5;
  const int ns = DIM == 2 ? 3 : 9;

  auto stage = [&](int s) {  // one thread: bulk-copy slab s's window
    const int b = s & 1;
    const T* src[2] = {pos, mass};
    T* const dst[2] = {sm.pos[b], sm.mass[b]};
    const int width[2] = {DIM, 1};
    const sph::Span w = sph::window(c0, sph::slab_shift<DIM>(s, s0, s1), cap, W, S);
    sph::stage_span(w, src, dst, width, &sm.bar[b]);
  };
  if (threadIdx.x == 0) {
    sph::mbar_init(&sm.bar[0]);
    sph::mbar_init(&sm.bar[1]);
    stage(0);
    if (ns > 1) stage(1);
  }

  const T h = prm[0], cs = prm[1], cv = prm[2], c6 = prm[3], kc = prm[4];
  const T h6_64 = prm[5], mu = prm[6], st = prm[7];
  const T h2 = h * h, half_h = T(0.5) * h, tiny = T(1e-12);

  // Home slots: one record per occupied slot, in slot order.
  for (int i = threadIdx.x; i < H; i += blockDim.x) sm.hidx[i] = -1;
  sph::occupancy(mass + base, H, 0, H, sm.hmask);
  __syncthreads();
  const sph::ChunkScan hs = sph::scan_chunks(sm.hmask, nchH);
  const int nh = hs.total;
  sph::pack_occupied(sm.hmask, nchH, hs, [&](int i, int r) {
    const long long g = base + i;
    sph::Rec<T> x{}, v{};
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      x.v[d] = pos[g * DIM + d];
      v.v[d] = vel[g * DIM + d];
      sm.hacc[r * DIM + d] = T(0);
      sm.hxs[r * DIM + d] = T(0);
    }
    x.v[3] = pr2[g];
    v.v[3] = mu * inv_rho[g];
    sm.hidx[i] = r;
    sm.hcell[r] = i / cap;
    sm.hx[r] = x;
    sm.hv[r] = v;
  });

  for (int s = 0; s < ns; ++s) {
    const int b = s & 1;
    const sph::Span w = sph::window(c0, sph::slab_shift<DIM>(s, s0, s1), cap, W, S);
    sph::mbar_wait(&sm.bar[b], (s >> 1) & 1);
    sph::occupancy(sm.mass[b], W, w.lo, w.hi, sm.wmask);
    __syncthreads();  // masks complete; the previous walk is over
    const sph::ChunkScan sc = sph::scan_chunks(sm.wmask, nchW);
    sph::pack_occupied(sm.wmask, nchW, sc, [&](int j, int r) {
      const long long g = w.j0 + j;
      sph::Rec<T> p{}, v{};
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        p.v[d] = sm.pos[b][j * DIM + d];
        v.v[d] = vel[g * DIM + d];
      }
      p.v[3] = sm.mass[b][j];
      v.v[3] = pr2[g];
      sm.prec[r] = p;
      sm.vrec[r] = v;
      sm.mr[r] = m_rho[g];
    });
    if (warp == 0) sph::cell_starts(sc, sm.wmask, nchW, R + 2, cap, sm.start);
    __syncthreads();  // records ready; stage b is free again
    if (threadIdx.x == 0 && s + 2 < ns) {
      sph::fence_proxy_async();
      stage(s + 2);
    }
    for (int k = threadIdx.x; k < nh; k += blockDim.x) {
      const int lc = sm.hcell[k];
      const int j1 = sm.start[lc + 3];
      const sph::Rec<T> xi = sm.hx[k], vi = sm.hv[k];
      const T pr2_i = xi.v[3];
      T sr[DIM], sv[DIM], sx[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) sr[d] = sv[d] = sx[d] = T(0);
      for (int jb = sm.start[lc]; jb < j1; jb += 32) {
        const int je = jb + 32 < j1 ? jb + 32 : j1;
        unsigned hit = 0;  // candidates in support, collected first
        for (int j = jb; j < je; ++j)
          if (r2_of<T, DIM>(xi, sm.prec[j]) < h2) hit |= 1u << (j - jb);
        for (; hit; hit &= hit - 1) {
          const int j = jb + __ffs(hit) - 1;
          const sph::Rec<T> p = sm.prec[j];
          T dd[DIM];
#pragma unroll
          for (int d = 0; d < DIM; ++d) dd[d] = xi.v[d] - p.v[d];
          const T r2 = r2_of<T, DIM>(xi, p);
          const T mj = p.v[3];
          const sph::Rec<T> vj = sm.vrec[j];
          const T inv_r = sph::rsqrt_t<T>(r2 > tiny ? r2 : tiny);
          const T r = r2 * inv_r;
          const T q = sph::max0(h - r);
          const T gw = cs * q * q;
          T radial = mj * (pr2_i + vj.v[3]) * gw;
          if (COH) {
            const T hr3 = q * q * q;
            const T r3 = r * r * r;
            const T cc = r <= half_h ? T(2) * hr3 * r3 - h6_64 : hr3 * r3;
            const T coh = (r > T(0) && r < h) ? kc * cc : T(0);
            radial = radial + st * mj * coh;
          }
          radial = radial * inv_r;
          const T mr = sm.mr[j];
          const T vw = mr * (cv * q);
          T xw = T(0);
          if (XSPH) {
            const T q6 = sph::max0(h2 - r2);
            xw = mr * (c6 * q6 * q6 * q6);
          }
#pragma unroll
          for (int d = 0; d < DIM; ++d) {
            const T dv = vj.v[d] - vi.v[d];
            sr[d] += radial * dd[d];
            sv[d] += vw * dv;
            if (XSPH) sx[d] += xw * dv;
          }
        }
      }
      const T mu_i = vi.v[3];
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        sm.hacc[k * DIM + d] = sm.hacc[k * DIM + d] - sr[d] + mu_i * sv[d];
        sm.hxs[k * DIM + d] += sx[d];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < H * DIM; e += blockDim.x) {
    const int r = sm.hidx[e / DIM], d = e % DIM;
    acc_out[out0 * DIM + e] = r >= 0 ? sm.hacc[r * DIM + d] : T(0);
    xsph_out[out0 * DIM + e] = r >= 0 ? sm.hxs[r * DIM + d] : T(0);
  }
}

template <typename T, int DIM, bool COH, bool XSPH>
cudaError_t go(const T* p, const T* v, const T* m, const T* pr2, const T* mr, const T* ir,
               const T* prm, T* acc, T* xsph, long long S, int cap, long long s0,
               long long s1, long long c_first, long long n_home, cudaStream_t st) {
  const int run = sph::run_cells(cap);
  sph::Carve carve(nullptr);  // counts the bytes of the layout
  const RunSmem<T, DIM> layout(carve, run, cap);
  (void)layout;
  const auto kernel = forces_runs<T, DIM, COH, XSPH>;
  const cudaError_t err = sph::allow_smem(kernel, carve.off);
  if (err != cudaSuccess) return err;
  const long long runs = (n_home + run - 1) / run;
  kernel<<<static_cast<unsigned>(runs), sph::kRunThreads, carve.off, st>>>(
      p, v, m, pr2, mr, ir, prm, acc, xsph, S, cap, run, s0, s1, c_first, c_first + n_home);
  return cudaGetLastError();
}

template <typename T, int DIM>
cudaError_t dispatch_terms(bool coh, bool xsph, const T* p, const T* v, const T* m,
                           const T* pr2, const T* mr, const T* ir, const T* prm, T* a,
                           T* x, long long S, int cap, long long s0, long long s1,
                           long long c_first, long long n_home, cudaStream_t st) {
#define SPH_FORCES_GO(COH, XSPH) \
  go<T, DIM, COH, XSPH>(p, v, m, pr2, mr, ir, prm, a, x, S, cap, s0, s1, c_first, n_home, st)
  if (coh && xsph) return SPH_FORCES_GO(true, true);
  if (coh) return SPH_FORCES_GO(true, false);
  if (xsph) return SPH_FORCES_GO(false, true);
  return SPH_FORCES_GO(false, false);
#undef SPH_FORCES_GO
}

template <typename T>
int launch(const void* pos, const void* vel, const void* mass, const void* pr2,
           const void* m_rho, const void* inv_rho, const void* prm, void* acc,
           void* xsph, long long S, int cap, int dim, long long s0, long long s1,
           long long c_first, long long n_home, int use_cohesion, int use_xsph,
           void* stream) {
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
  if (S == 0 || n_home == 0) return cudaGetLastError();
  if (!sph::run_cap_ok(cap) || c_first < 0 || n_home < 0 || (c_first + n_home) * cap > S)
    return cudaErrorInvalidValue;
  if (dim == 2)
    return dispatch_terms<T, 2>(use_cohesion, use_xsph, p, v, m, q, mr, ir, c, a, x, S, cap,
                                s0, s1, c_first, n_home, st);
  if (dim == 3)
    return dispatch_terms<T, 3>(use_cohesion, use_xsph, p, v, m, q, mr, ir, c, a, x, S, cap,
                                s0, s1, c_first, n_home, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Home cells [c_first, c_first + n_home) of the S / cap cells of the inputs;
// acc and xsph hold their n_home * cap slots. The whole grid is c_first 0,
// n_home S / cap.
extern "C" int sph_forces_f32(const void* pos, const void* vel, const void* mass,
                              const void* pr2, const void* m_rho, const void* inv_rho,
                              const void* prm, void* acc, void* xsph, long long S,
                              int cap, int dim, long long s0, long long s1,
                              long long c_first, long long n_home, int use_cohesion,
                              int use_xsph, void* stream) {
  return launch<float>(pos, vel, mass, pr2, m_rho, inv_rho, prm, acc, xsph, S, cap,
                       dim, s0, s1, c_first, n_home, use_cohesion, use_xsph, stream);
}

extern "C" int sph_forces_f64(const void* pos, const void* vel, const void* mass,
                              const void* pr2, const void* m_rho, const void* inv_rho,
                              const void* prm, void* acc, void* xsph, long long S,
                              int cap, int dim, long long s0, long long s1,
                              long long c_first, long long n_home, int use_cohesion,
                              int use_xsph, void* stream) {
  return launch<double>(pos, vel, mass, pr2, m_rho, inv_rho, prm, acc, xsph, S, cap,
                        dim, s0, s1, c_first, n_home, use_cohesion, use_xsph, stream);
}
