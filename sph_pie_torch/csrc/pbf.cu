// The five pair folds of Position-Based Fluids over the binned slots.
//
// The kernels of sph_pie_torch/neighbors/pbf_folds.py. The reference runs
// these folds as XLA slab folds (sph_pie_tpu/solvers/pbf.py _lambda_fold,
// _dx_fold, _density_xsph_fold, _vorticity_fold, _vorticity_force); they
// reach no pl.pallas_call. For each occupied home slot i, over the occupied
// slots j of its 3^(DIM-1) slab windows with r^2 < h^2 (d = x_i - x_j,
// inv_r = rsqrt(max(r^2, 1e-12)), r = r^2 inv_r, W = C_p max(h^2 - r^2, 0)^3,
// g = C_s max(h - r, 0)^2 inv_r):
//
//   lambda         rho = sum m_j W;  G2 = sum |m_j g d|^2;  G = sum m_j g d
//                  lambda = -(rho / rho0 - 1) / ((G2 + |G|^2) / rho0^2 + eps)
//   dx             (1 / rho0) sum m_j (lam_i + lam_j + s_corr) g d,
//                  s_corr = -k h^2 (W / W(dq h))^n by repeated squaring
//   density_xsph   rho = sum m_j W;  dv = S1 - v_i S0 with S0 = sum (m/rho)_j W,
//                  S1 = sum (m/rho)_j W v_j (the moment form)
//   vorticity      omega = sum (m/rho)_j (v_j - v_i) x (g d)  (2D: the z-curl)
//   vorticity_eta  eta = sum (m/rho |omega|)_j g d
//
// with the arithmetic of the plain folds: the same per-pair expressions in
// the same order, 1/rho0 applied once after the sums. Each slab's partial
// sums are added as the plain fold adds them; only the order within a slab
// differs. Home slots with mass 0 write 0.
//
// Two kernels share forces.cu's runs design: one CTA per run of R cells
// along the contiguous axis; an all-empty run writes zeros and exits before
// any barrier; one thread per occupied home slot; for each slab the run's
// (R+2)-cell window is bulk-copied into shared memory (cp.async.bulk on an
// mbarrier) and packed by warp ballot into (x, y, z, m) records of the
// occupied slots, in slot order.
//
// pbf_runs (density_xsph, vorticity, vorticity_eta, and dx without words;
// two staging buffers): each home thread tests r^2 of 32 candidates into a
// bit mask, then runs the op's pair math on the candidates in support, in
// slot order, reading their extras (lam_j, v_j, m_rho_j, ...) from global
// memory for those pairs only.
//
// pbf_walk (lambda, and dx with lambda's words): lambda makes pbf_runs'
// tests and pair math in pbf_runs' order, and writes each 32-candidate test
// mask out as a hit word, M = 3^(DIM-1) * ceil(3 cap / 32) a home slot,
// slab-major (bit b of word w of slab s: the home's (32 w + b)-th occupied
// candidate of that slab's window, its three cells in slot order, lies
// within h). dx on the same pos, mass and home range reads those words and
// makes no r^2 test at all: the ballot packing is deterministic, so the
// same bit names the same record, and the same pairs in the same order give
// pbf_runs' bits. dx stages lam with the window and packs lam_j beside each
// record, so no pair reads device memory, and runs the pair math over the
// set bits of up to kGroupWords words in one loop, so a warp waits on its
// busiest lane once a group (once a slab up to cap 40), not once a word.
// One staging buffer: the copy of slab s + 1 overlaps the walk of slab s,
// and the shared memory it saves is more CTAs on an SM. Bound: bytes
// (PERF.md); what holds the two kernels back (the staging and packing of
// nine windows a run, lambda's 580 tests a home) is measured there.
#include "common.cuh"

namespace {

using sph::Rec;

// Inputs and outputs of one launch; a and b are per-slot inputs of the
// buffer (unused ones null), out0 / out1 span the home slots.
template <typename T>
struct Args {
  const T* pos;   // [S, DIM]
  const T* mass;  // [S]
  const T* a;     // dx: lam [S]; density_xsph, vorticity: vel [S, DIM]
  const T* b;     // density_xsph, vorticity: m_rho [S]; vorticity_eta: m_rho |omega| [S]
  const T* prm;   // the op's constants (pbf_folds.py builds them)
  T* out0;
  T* out1;
  int n_pow;      // dx: the artificial-pressure exponent
};

// r^2 of a home and a packed candidate, in the plain fold's order.
template <typename T, int DIM>
__device__ __forceinline__ T r2_of(const Rec<T>& xi, const Rec<T>& p) {
  T d = xi.v[0] - p.v[0];
  T r2 = d * d;
#pragma unroll
  for (int e = 1; e < DIM; ++e) {
    d = xi.v[e] - p.v[e];
    r2 = r2 + d * d;
  }
  return r2;
}

// The spiky gradient over r, C_s max(h - r, 0)^2 inv_r, with
// inv_r = rsqrt(max(r^2, 1e-12)) and r = r^2 inv_r.
template <typename T>
__device__ __forceinline__ T grad_over_r(T r2, T h, T cs) {
  const T tiny = T(1e-12);
  const T inv_r = sph::rsqrt_t<T>(r2 > tiny ? r2 : tiny);
  const T r = r2 * inv_r;
  const T q = sph::max0(h - r);
  return cs * q * q * inv_r;
}

// W_poly6 from r^2: C_p max(h^2 - r^2, 0)^3.
template <typename T>
__device__ __forceinline__ T poly6(T r2, T h2, T c6) {
  const T q = sph::max0(h2 - r2);
  return c6 * q * q * q;
}

// Each op: kAcc sums a home slot; home() loads its home extras, pair() adds
// one pair in support, finish() / zero() write an occupied / empty home row.

template <typename T, int DIM>
struct LambdaOp {  // prm: h, C_p, C_s, 1/rho0, relax_eps
  static constexpr int kAcc = 2 + DIM;  // rho, G2, G
  T h, h2, c6, cs, inv_rho0, eps;
  __device__ explicit LambdaOp(const Args<T>& a)
      : h(a.prm[0]), h2(a.prm[0] * a.prm[0]), c6(a.prm[1]), cs(a.prm[2]),
        inv_rho0(a.prm[3]), eps(a.prm[4]) {}
  __device__ Rec<T> home(const Args<T>&, long long) const { return Rec<T>{}; }
  // pbf_walk's pair: ej, the candidate's packed extra, is unused.
  __device__ void pair_with(T (&s)[kAcc], const Rec<T>& xi, const Rec<T>&, const Rec<T>& p,
                            T, T r2) const {
    const T mj = p.v[3];
    s[0] += mj * poly6(r2, h2, c6);
    const T coef = mj * grad_over_r(r2, h, cs);
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      const T g = coef * (xi.v[d] - p.v[d]);
      s[1] += g * g;
      s[2 + d] += g;
    }
  }
  __device__ void finish(const Args<T>& a, const T* s, const Rec<T>&, long long row) const {
    T denom = s[1];
#pragma unroll
    for (int d = 0; d < DIM; ++d) denom = denom + s[2 + d] * s[2 + d];
    denom = denom * (inv_rho0 * inv_rho0);
    const T c = s[0] * inv_rho0 - T(1);
    a.out0[row] = -c / (denom + eps);
    a.out1[row] = s[0];
  }
  __device__ void zero(const Args<T>& a, long long row) const {
    a.out0[row] = T(0);
    a.out1[row] = T(0);
  }
};

template <typename T, int DIM>
struct DxOp {  // prm: h, C_p, C_s, 1/rho0, 1/W(dq h), -k h^2
  static constexpr int kAcc = DIM;
  T h, h2, c6, cs, inv_rho0, inv_wdq, neg_k_h2;
  int n;
  __device__ explicit DxOp(const Args<T>& a)
      : h(a.prm[0]), h2(a.prm[0] * a.prm[0]), c6(a.prm[1]), cs(a.prm[2]),
        inv_rho0(a.prm[3]), inv_wdq(a.prm[4]), neg_k_h2(a.prm[5]), n(a.n_pow) {}
  __device__ Rec<T> home(const Args<T>& a, long long g) const {
    Rec<T> e{};
    e.v[0] = a.a[g];
    return e;
  }
  // One pair with lam_j given: pbf_walk passes the packed lam_j.
  __device__ __forceinline__ void pair_with(T (&s)[kAcc], const Rec<T>& xi, const Rec<T>& ei,
                                            const Rec<T>& p, T lam_j, T r2) const {
    // (W / W(dq h))^n by repeated squaring, as the plain _integer_pow
    T x = poly6(r2, h2, c6) * inv_wdq, pw = T(1);
    for (int k = n; k > 0;) {
      if (k & 1) pw = pw * x;
      k >>= 1;
      if (k > 0) x = x * x;
    }
    const T lam_sum = ei.v[0] + lam_j + neg_k_h2 * pw;
    const T coef = (p.v[3] * lam_sum) * grad_over_r(r2, h, cs);
#pragma unroll
    for (int d = 0; d < DIM; ++d) s[d] += coef * (xi.v[d] - p.v[d]);
  }
  // pbf_runs' pair (the test walk): lam_j from global memory.
  __device__ void pair(T (&s)[kAcc], const Rec<T>& xi, const Rec<T>& ei, const Rec<T>& p,
                       long long gj, T r2, const Args<T>& a) const {
    pair_with(s, xi, ei, p, __ldg(a.a + gj), r2);
  }
  __device__ void finish(const Args<T>& a, const T* s, const Rec<T>&, long long row) const {
#pragma unroll
    for (int d = 0; d < DIM; ++d) a.out0[row * DIM + d] = s[d] * inv_rho0;
  }
  __device__ void zero(const Args<T>& a, long long row) const {
#pragma unroll
    for (int d = 0; d < DIM; ++d) a.out0[row * DIM + d] = T(0);
  }
};

template <typename T, int DIM>
struct DensityXsphOp {  // prm: h, C_p
  static constexpr int kAcc = 2 + DIM;  // rho, S0, S1
  T h2, c6;
  __device__ explicit DensityXsphOp(const Args<T>& a)
      : h2(a.prm[0] * a.prm[0]), c6(a.prm[1]) {}
  __device__ Rec<T> home(const Args<T>& a, long long g) const {
    Rec<T> e{};
#pragma unroll
    for (int d = 0; d < DIM; ++d) e.v[d] = a.a[g * DIM + d];
    return e;
  }
  __device__ void pair(T (&s)[kAcc], const Rec<T>&, const Rec<T>&, const Rec<T>& p,
                       long long gj, T r2, const Args<T>& a) const {
    const T wk = poly6(r2, h2, c6);
    const T ww = __ldg(a.b + gj) * wk;
    s[0] += p.v[3] * wk;
    s[1] += ww;
#pragma unroll
    for (int d = 0; d < DIM; ++d) s[2 + d] += ww * __ldg(a.a + gj * DIM + d);
  }
  __device__ void finish(const Args<T>& a, const T* s, const Rec<T>& ei, long long row) const {
    a.out0[row] = s[0];
#pragma unroll
    for (int d = 0; d < DIM; ++d) a.out1[row * DIM + d] = s[2 + d] - ei.v[d] * s[1];
  }
  __device__ void zero(const Args<T>& a, long long row) const {
    a.out0[row] = T(0);
#pragma unroll
    for (int d = 0; d < DIM; ++d) a.out1[row * DIM + d] = T(0);
  }
};

template <typename T, int DIM>
struct VorticityOp {  // prm: h, C_s
  static constexpr int kAcc = DIM == 3 ? 3 : 1;  // omega (2D: its z component)
  T h, cs;
  __device__ explicit VorticityOp(const Args<T>& a) : h(a.prm[0]), cs(a.prm[1]) {}
  __device__ Rec<T> home(const Args<T>& a, long long g) const {
    Rec<T> e{};
#pragma unroll
    for (int d = 0; d < DIM; ++d) e.v[d] = a.a[g * DIM + d];
    return e;
  }
  __device__ void pair(T (&s)[kAcc], const Rec<T>& xi, const Rec<T>& ei, const Rec<T>& p,
                       long long gj, T r2, const Args<T>& a) const {
    const T coef = __ldg(a.b + gj) * grad_over_r(r2, h, cs);
    T dv[DIM], g[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      dv[d] = __ldg(a.a + gj * DIM + d) - ei.v[d];
      g[d] = coef * (xi.v[d] - p.v[d]);
    }
    if constexpr (DIM == 3) {
      s[0] += dv[1] * g[2] - dv[2] * g[1];
      s[1] += dv[2] * g[0] - dv[0] * g[2];
      s[2] += dv[0] * g[1] - dv[1] * g[0];
    } else {
      s[0] += dv[0] * g[1] - dv[1] * g[0];
    }
  }
  __device__ void finish(const Args<T>& a, const T* s, const Rec<T>&, long long row) const {
#pragma unroll
    for (int q = 0; q < kAcc; ++q) a.out0[row * kAcc + q] = s[q];
  }
  __device__ void zero(const Args<T>& a, long long row) const {
#pragma unroll
    for (int q = 0; q < kAcc; ++q) a.out0[row * kAcc + q] = T(0);
  }
};

template <typename T, int DIM>
struct VorticityEtaOp {  // prm: h, C_s
  static constexpr int kAcc = DIM;
  T h, cs;
  __device__ explicit VorticityEtaOp(const Args<T>& a) : h(a.prm[0]), cs(a.prm[1]) {}
  __device__ Rec<T> home(const Args<T>&, long long) const { return Rec<T>{}; }
  __device__ void pair(T (&s)[kAcc], const Rec<T>& xi, const Rec<T>&, const Rec<T>& p,
                       long long gj, T r2, const Args<T>& a) const {
    const T coef = __ldg(a.b + gj) * grad_over_r(r2, h, cs);
#pragma unroll
    for (int d = 0; d < DIM; ++d) s[d] += coef * (xi.v[d] - p.v[d]);
  }
  __device__ void finish(const Args<T>& a, const T* s, const Rec<T>&, long long row) const {
#pragma unroll
    for (int d = 0; d < DIM; ++d) a.out0[row * DIM + d] = s[d];
  }
  __device__ void zero(const Args<T>& a, long long row) const {
#pragma unroll
    for (int d = 0; d < DIM; ++d) a.out0[row * DIM + d] = T(0);
  }
};

// Shared memory of one run: W = (R+2)*cap window slots, H = R*cap home slots.
template <typename T, int DIM, int NACC>
struct RunSmem {
  uint64_t* bar;      // [2] one mbarrier per stage
  T* pos[2];          // [W*DIM] staged window positions
  T* mass[2];         // [W] staged window masses
  Rec<T>* prec;       // [W] packed (x, y, z, m) of the occupied window slots
  long long* gidx;    // [W] their slots in the buffer
  int* start;         // [R+3] first record of each window cell
  unsigned* wmask;    // [W/32] occupancy of the stage being packed
  unsigned* hmask;    // [H/32] occupancy of the home slots
  int* hidx;          // [H] home slot -> home record, -1 if empty
  int* hcell;         // [H] home record -> run cell
  Rec<T>* hx;         // [H] home (x, y, z, 0)
  Rec<T>* he;         // [H] home extras of the op
  T* acc;             // [H*NACC] the sums
  __host__ __device__ RunSmem(sph::Carve& c, int R, int cap) {
    const int W = (R + 2) * cap, H = R * cap;
    bar = c.take<uint64_t>(2);
    for (int b = 0; b < 2; ++b) {
      pos[b] = c.take<T>(static_cast<long long>(W) * DIM);
      mass[b] = c.take<T>(W);
    }
    prec = c.take<Rec<T>>(W);
    gidx = c.take<long long>(W);
    start = c.take<int>(R + 3);
    wmask = c.take<unsigned>((W + 31) / 32);
    hmask = c.take<unsigned>((H + 31) / 32);
    hidx = c.take<int>(H);
    hcell = c.take<int>(H);
    hx = c.take<Rec<T>>(H);
    he = c.take<Rec<T>>(H);
    acc = c.take<T>(static_cast<long long>(H) * NACC);
  }
};

template <typename T, int DIM, class Op>
__global__ void __launch_bounds__(sph::kRunThreads)
pbf_runs(const Args<T> a, long long S, int cap, int R, long long s0, long long s1,
         long long c_first, long long c_end) {
  constexpr int NA = Op::kAcc;
  const long long c0 = c_first + static_cast<long long>(blockIdx.x) * R;
  const long long base = c0 * cap;              // first home slot
  const long long out0 = base - c_first * cap;  // its row in the outputs
  const long long left = (c_end - c0) * cap;
  const int H = static_cast<int>(left < static_cast<long long>(R) * cap
                                     ? left : static_cast<long long>(R) * cap);
  const Op op(a);
  if (sph::warp_all_zero(a.mass + base, H)) {  // empty run: zeros
    for (int i = threadIdx.x; i < H; i += blockDim.x) op.zero(a, out0 + i);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  sph::Carve carve(smem_raw);
  const RunSmem<T, DIM, NA> sm(carve, R, cap);
  const int W = (R + 2) * cap, nchW = (W + 31) / 32, nchH = (H + 31) / 32;
  const int warp = threadIdx.x >> 5;
  const int ns = DIM == 2 ? 3 : 9;
  const T h = a.prm[0];
  const T h2 = h * h;

  auto stage = [&](int s) {  // one thread: bulk-copy slab s's window
    const int b = s & 1;
    const T* src[2] = {a.pos, a.mass};
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

  // Home slots: one record per occupied slot, in slot order.
  for (int i = threadIdx.x; i < H; i += blockDim.x) sm.hidx[i] = -1;
  sph::occupancy(a.mass + base, H, 0, H, sm.hmask);
  __syncthreads();
  const sph::ChunkScan hs = sph::scan_chunks(sm.hmask, nchH);
  const int nh = hs.total;
  sph::pack_occupied(sm.hmask, nchH, hs, [&](int i, int r) {
    const long long g = base + i;
    Rec<T> x{};
#pragma unroll
    for (int d = 0; d < DIM; ++d) x.v[d] = a.pos[g * DIM + d];
#pragma unroll
    for (int q = 0; q < NA; ++q) sm.acc[r * NA + q] = T(0);
    sm.hidx[i] = r;
    sm.hcell[r] = i / cap;
    sm.hx[r] = x;
    sm.he[r] = op.home(a, g);
  });

  for (int s = 0; s < ns; ++s) {
    const int b = s & 1;
    const sph::Span w = sph::window(c0, sph::slab_shift<DIM>(s, s0, s1), cap, W, S);
    sph::mbar_wait(&sm.bar[b], (s >> 1) & 1);
    sph::occupancy(sm.mass[b], W, w.lo, w.hi, sm.wmask);
    __syncthreads();  // masks complete; the previous walk is over
    const sph::ChunkScan sc = sph::scan_chunks(sm.wmask, nchW);
    sph::pack_occupied(sm.wmask, nchW, sc, [&](int j, int r) {
      Rec<T> p{};
#pragma unroll
      for (int d = 0; d < DIM; ++d) p.v[d] = sm.pos[b][j * DIM + d];
      p.v[3] = sm.mass[b][j];
      sm.prec[r] = p;
      sm.gidx[r] = w.j0 + j;
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
      const Rec<T> xi = sm.hx[k], ei = sm.he[k];
      T part[NA];
#pragma unroll
      for (int q = 0; q < NA; ++q) part[q] = T(0);
      for (int jb = sm.start[lc]; jb < j1; jb += 32) {
        const int je = jb + 32 < j1 ? jb + 32 : j1;
        unsigned hit = 0;  // candidates in support, collected first
        for (int j = jb; j < je; ++j)
          if (r2_of<T, DIM>(xi, sm.prec[j]) < h2) hit |= 1u << (j - jb);
        for (; hit; hit &= hit - 1) {
          const int j = jb + __ffs(hit) - 1;
          const Rec<T> p = sm.prec[j];
          op.pair(part, xi, ei, p, sm.gidx[j], r2_of<T, DIM>(xi, p), a);
        }
      }
#pragma unroll
      for (int q = 0; q < NA; ++q) sm.acc[k * NA + q] += part[q];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    const int r = sm.hidx[i];
    if (r >= 0)
      op.finish(a, sm.acc + r * NA, sm.he[r], out0 + i);
    else
      op.zero(a, out0 + i);
  }
}

template <typename T, int DIM, class Op>
cudaError_t go(const Args<T>& a, long long S, int cap, long long s0, long long s1,
               long long c_first, long long n_home, cudaStream_t st) {
  const int run = sph::run_cells(cap);
  sph::Carve carve(nullptr);  // counts the bytes of the layout
  const RunSmem<T, DIM, Op::kAcc> layout(carve, run, cap);
  (void)layout;
  const auto kernel = pbf_runs<T, DIM, Op>;
  const cudaError_t err = sph::allow_smem(kernel, carve.off);
  if (err != cudaSuccess) return err;
  const long long runs = (n_home + run - 1) / run;
  kernel<<<static_cast<unsigned>(runs), sph::kRunThreads, carve.off, st>>>(
      a, S, cap, run, s0, s1, c_first, c_first + n_home);
  return cudaGetLastError();
}

// ---- lambda and dx: the walk over hit words --------------------------------

// pbf_walk takes pbf_runs' launch shape (common.cuh: runs of kRunCells
// cells, kRunThreads threads); runs of 8 cells and 64 threads measured no
// better (PERF.md).

// Slab windows staged ahead: a ring of kWalkStages buffers, the copy of
// slab s + kWalkStages issued once slab s is packed. One buffer measured
// fastest (PERF.md): it overlaps the copy with the walk, and the
// shared memory it saves is more CTAs on an SM.
constexpr int kWalkStages = 1;
// Hit words a home thread holds in registers at once (128 candidates): a
// slab's whole range up to cap 40, larger caps in groups, still in order.
constexpr int kGroupWords = 4;

// Hit words of one slab of one home slot: its candidates span at most the
// 3 cap slots of three cells.
__host__ __device__ inline int slab_words(int cap) { return (3 * cap + 31) / 32; }

// Shared memory of one walk run: W = (R+2)*cap window slots, H = R*cap home
// slots; kRead (dx) also stages lam and packs lam_j beside each record.
template <typename T, int DIM, int NACC, bool kRead>
struct WalkSmem {
  uint64_t* bar;                // [kWalkStages] one mbarrier per stage
  T* pos[kWalkStages];          // [W*DIM] staged window positions
  T* mass[kWalkStages];         // [W] staged window masses
  T* lam[kWalkStages];          // [W] staged window lambdas (kRead)
  Rec<T>* prec;                 // [W] packed (x, y, z, m) of the occupied window slots
  T* pex;                       // [W] their lam_j (kRead)
  int* start;                   // [R+3] first record of each window cell
  unsigned* wmask;              // [W/32] occupancy of the stage being packed
  unsigned* hmask;              // [H/32] occupancy of the home slots
  int* hslot;                   // [H] home record -> home slot
  Rec<T>* hx;                   // [H] home (x, y, z, 0)
  T* hlam;                      // [H] home lam_i (kRead)
  T* acc;                       // [H*NACC] the sums
  __host__ __device__ WalkSmem(sph::Carve& c, int R, int cap) {
    const int W = (R + 2) * cap, H = R * cap, WX = kRead ? W : 0, HX = kRead ? H : 0;
    bar = c.take<uint64_t>(kWalkStages);
    for (int b = 0; b < kWalkStages; ++b) {
      pos[b] = c.take<T>(static_cast<long long>(W) * DIM);
      mass[b] = c.take<T>(W);
      lam[b] = c.take<T>(WX);
    }
    prec = c.take<Rec<T>>(W);
    pex = c.take<T>(WX);
    start = c.take<int>(R + 3);
    wmask = c.take<unsigned>((W + 31) / 32);
    hmask = c.take<unsigned>((H + 31) / 32);
    hslot = c.take<int>(H);
    hx = c.take<Rec<T>>(H);
    hlam = c.take<T>(HX);
    acc = c.take<T>(static_cast<long long>(H) * NACC);
  }
};

// n <= kGroupWords hit words at p (16-byte vectors when ``vec``).
__device__ __forceinline__ void load_words(const unsigned* p, int n, bool vec,
                                           unsigned (&w)[kGroupWords]) {
  if (vec) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < kGroupWords; ++q) w[q] = q < n ? __ldg(p + q) : 0u;
}

__device__ __forceinline__ void store_words(unsigned* p, int n, bool vec,
                                            const unsigned (&w)[kGroupWords]) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int q = 0; q < kGroupWords; ++q)
    if (q < n) p[q] = w[q];
}

// kRead false (lambda): pbf_runs' test walk, writing each word's test mask
// to wo (rows of the home slots, M a row). kRead true (dx): the pair math
// over the words of wi (rows of the buffer), no tests.
template <typename T, int DIM, class Op, bool kRead>
__global__ void __launch_bounds__(sph::kRunThreads)
pbf_walk(const Args<T> a, const unsigned* __restrict__ wi, unsigned* __restrict__ wo,
         long long S, int cap, int R, long long s0, long long s1, long long c_first,
         long long c_end) {
  constexpr int NA = Op::kAcc;
  const long long c0 = c_first + static_cast<long long>(blockIdx.x) * R;
  const long long base = c0 * cap;              // first home slot
  const long long out0 = base - c_first * cap;  // its row in the outputs
  const long long left = (c_end - c0) * cap;
  const int H = static_cast<int>(left < static_cast<long long>(R) * cap
                                     ? left : static_cast<long long>(R) * cap);
  const Op op(a);
  if (sph::warp_all_zero(a.mass + base, H)) {  // empty run: zeros, no words
    for (int i = threadIdx.x; i < H; i += blockDim.x) op.zero(a, out0 + i);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  sph::Carve carve(smem_raw);
  const WalkSmem<T, DIM, NA, kRead> sm(carve, R, cap);
  const int W = (R + 2) * cap, nchW = (W + 31) / 32, nchH = (H + 31) / 32;
  const int warp = threadIdx.x >> 5;
  const int ns = DIM == 2 ? 3 : 9;
  const int nw = slab_words(cap), M = ns * nw;
  const bool vec = nw % kGroupWords == 0;  // then every group is 16-byte aligned
  const T h = a.prm[0];
  const T h2 = h * h;

  auto stage = [&](int s) {  // one thread: bulk-copy slab s's window
    const int b = s % kWalkStages;
    const sph::Span w = sph::window(c0, sph::slab_shift<DIM>(s, s0, s1), cap, W, S);
    if constexpr (kRead) {
      const T* src[3] = {a.pos, a.mass, a.a};
      T* const dst[3] = {sm.pos[b], sm.mass[b], sm.lam[b]};
      const int width[3] = {DIM, 1, 1};
      sph::stage_span(w, src, dst, width, &sm.bar[b]);
    } else {
      const T* src[2] = {a.pos, a.mass};
      T* const dst[2] = {sm.pos[b], sm.mass[b]};
      const int width[2] = {DIM, 1};
      sph::stage_span(w, src, dst, width, &sm.bar[b]);
    }
  };
  if (threadIdx.x == 0) {
    for (int b = 0; b < kWalkStages; ++b) sph::mbar_init(&sm.bar[b]);
    for (int b = 0; b < kWalkStages && b < ns; ++b) stage(b);
  }

  // Home slots: one record per occupied slot, in slot order.
  sph::occupancy(a.mass + base, H, 0, H, sm.hmask);
  __syncthreads();
  const sph::ChunkScan hs = sph::scan_chunks(sm.hmask, nchH);
  const int nh = hs.total;
  sph::pack_occupied(sm.hmask, nchH, hs, [&](int i, int r) {
    const long long g = base + i;
    Rec<T> x{};
#pragma unroll
    for (int d = 0; d < DIM; ++d) x.v[d] = a.pos[g * DIM + d];
#pragma unroll
    for (int q = 0; q < NA; ++q) sm.acc[r * NA + q] = T(0);
    sm.hslot[r] = i;
    sm.hx[r] = x;
    if constexpr (kRead) sm.hlam[r] = op.home(a, g).v[0];
  });

  for (int s = 0; s < ns; ++s) {
    const int b = s % kWalkStages;
    const sph::Span w = sph::window(c0, sph::slab_shift<DIM>(s, s0, s1), cap, W, S);
    sph::mbar_wait(&sm.bar[b], (s / kWalkStages) & 1);
    sph::occupancy(sm.mass[b], W, w.lo, w.hi, sm.wmask);
    __syncthreads();  // masks complete; the previous walk is over
    const sph::ChunkScan sc = sph::scan_chunks(sm.wmask, nchW);
    sph::pack_occupied(sm.wmask, nchW, sc, [&](int j, int r) {
      Rec<T> p{};
#pragma unroll
      for (int d = 0; d < DIM; ++d) p.v[d] = sm.pos[b][j * DIM + d];
      p.v[3] = sm.mass[b][j];
      sm.prec[r] = p;
      if constexpr (kRead) sm.pex[r] = sm.lam[b][j];
    });
    if (warp == 0) sph::cell_starts(sc, sm.wmask, nchW, R + 2, cap, sm.start);
    __syncthreads();  // records ready; stage b is free again
    if (threadIdx.x == 0 && s + kWalkStages < ns) {
      sph::fence_proxy_async();
      stage(s + kWalkStages);
    }
    for (int k = threadIdx.x; k < nh; k += blockDim.x) {
      const int i = sm.hslot[k];
      const int lc = i / cap;
      const int j0 = sm.start[lc], j1 = sm.start[lc + 3];
      const Rec<T> xi = sm.hx[k];
      Rec<T> ei{};
      if constexpr (kRead) ei.v[0] = sm.hlam[k];
      T part[NA];
#pragma unroll
      for (int q = 0; q < NA; ++q) part[q] = T(0);
      for (int w0 = 0; w0 < nw; w0 += kGroupWords) {
        const int jg = j0 + 32 * w0;  // candidate of the group's bit 0
        unsigned hw[kGroupWords];
        if constexpr (kRead) {
          load_words(wi + (base + i) * M + s * nw + w0, nw - w0, vec, hw);
          // the group's set bits in order, in one loop: a warp waits on its
          // busiest lane once a group
          unsigned long long m0 = hw[0] | static_cast<unsigned long long>(hw[1]) << 32;
          unsigned long long m1 = hw[2] | static_cast<unsigned long long>(hw[3]) << 32;
          int jm = jg;  // candidate of m0's bit 0
          while (m0 | m1) {
            if (m0 == 0) {
              m0 = m1;
              m1 = 0;
              jm += 64;
            }
            const int j = jm + __ffsll(static_cast<long long>(m0)) - 1;
            m0 &= m0 - 1;
            const Rec<T> p = sm.prec[j];
            op.pair_with(part, xi, ei, p, sm.pex[j], r2_of<T, DIM>(xi, p));
          }
        } else {
          // each word's pairs right after its tests, in order: measured
          // faster than after the whole group's tests (PERF.md)
#pragma unroll
          for (int q = 0; q < kGroupWords; ++q) {
            const int jb = jg + 32 * q;
            const int je = jb + 32 < j1 ? jb + 32 : j1;
            unsigned hit = 0;
            for (int j = jb; j < je; ++j)
              if (r2_of<T, DIM>(xi, sm.prec[j]) < h2) hit |= 1u << (j - jb);
            hw[q] = hit;
            for (; hit; hit &= hit - 1) {
              const int j = jb + __ffs(hit) - 1;
              const Rec<T> p = sm.prec[j];
              op.pair_with(part, xi, ei, p, T(0), r2_of<T, DIM>(xi, p));
            }
          }
          store_words(wo + (out0 + i) * M + s * nw + w0, nw - w0, vec, hw);
        }
      }
#pragma unroll
      for (int q = 0; q < NA; ++q) sm.acc[k * NA + q] += part[q];
    }
  }
  __syncthreads();
  // Each home slot's row: its record's sums, 0 if empty (the record from
  // the home masks' scan; every lane runs the same trips for the shuffles).
  for (int i0 = 0; i0 < H; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const int k = (i < H ? i : H - 1) >> 5;
    const int off = hs.offset(k);
    if (i >= H) continue;
    const unsigned m = sm.hmask[k], bit = 1u << (i & 31);
    if (m & bit)
      op.finish(a, sm.acc + (off + __popc(m & (bit - 1u))) * NA, Rec<T>{}, out0 + i);
    else
      op.zero(a, out0 + i);
  }
}

template <typename T, int DIM, class Op, bool kRead>
cudaError_t go_walk(const Args<T>& a, const unsigned* wi, unsigned* wo, long long S, int cap,
                    long long s0, long long s1, long long c_first, long long n_home,
                    cudaStream_t st) {
  const int run = sph::run_cells(cap);
  sph::Carve carve(nullptr);  // counts the bytes of the layout
  const WalkSmem<T, DIM, Op::kAcc, kRead> layout(carve, run, cap);
  (void)layout;
  const auto kernel = pbf_walk<T, DIM, Op, kRead>;
  const cudaError_t err = sph::allow_smem(kernel, carve.off);
  if (err != cudaSuccess) return err;
  const long long runs = (n_home + run - 1) / run;
  kernel<<<static_cast<unsigned>(runs), sph::kRunThreads, carve.off, st>>>(
      a, wi, wo, S, cap, run, s0, s1, c_first, c_first + n_home);
  return cudaGetLastError();
}

// Op codes of pbf_folds.py.
enum { kLambda = 0, kDx = 1, kDensityXsph = 2, kVorticity = 3, kVorticityEta = 4 };

template <typename T, int DIM>
cudaError_t dispatch_op(int op, const Args<T>& a, long long S, int cap, long long s0,
                        long long s1, long long c_first, long long n_home, cudaStream_t st) {
  switch (op) {
    case kDx:
      return go<T, DIM, DxOp<T, DIM>>(a, S, cap, s0, s1, c_first, n_home, st);
    case kDensityXsph:
      return go<T, DIM, DensityXsphOp<T, DIM>>(a, S, cap, s0, s1, c_first, n_home, st);
    case kVorticity:
      return go<T, DIM, VorticityOp<T, DIM>>(a, S, cap, s0, s1, c_first, n_home, st);
    case kVorticityEta:
      return go<T, DIM, VorticityEtaOp<T, DIM>>(a, S, cap, s0, s1, c_first, n_home, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
Args<T> make_args(const void* pos, const void* mass, const void* in_a, const void* in_b,
                  const void* prm, void* out0, void* out1, int n_pow) {
  return Args<T>{static_cast<const T*>(pos),  static_cast<const T*>(mass),
                 static_cast<const T*>(in_a), static_cast<const T*>(in_b),
                 static_cast<const T*>(prm),  static_cast<T*>(out0),
                 static_cast<T*>(out1),       n_pow};
}

bool layout_ok(long long S, int cap, long long c_first, long long n_home) {
  return sph::run_cap_ok(cap) && c_first >= 0 && n_home >= 0 && (c_first + n_home) * cap <= S;
}

template <typename T>
int launch(int op, const void* pos, const void* mass, const void* in_a, const void* in_b,
           const void* prm, void* out0, void* out1, long long S, int cap, int dim,
           long long s0, long long s1, long long c_first, long long n_home, int n_pow,
           void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const Args<T> a = make_args<T>(pos, mass, in_a, in_b, prm, out0, out1, n_pow);
  if (S == 0 || n_home == 0) return cudaGetLastError();
  if (!layout_ok(S, cap, c_first, n_home)) return cudaErrorInvalidValue;
  if (dim == 2) return dispatch_op<T, 2>(op, a, S, cap, s0, s1, c_first, n_home, st);
  if (dim == 3) return dispatch_op<T, 3>(op, a, S, cap, s0, s1, c_first, n_home, st);
  return cudaErrorInvalidValue;
}

template <typename T, int DIM>
cudaError_t dispatch_walk(int op, const Args<T>& a, const unsigned* wi, unsigned* wo,
                          long long S, int cap, long long s0, long long s1, long long c_first,
                          long long n_home, cudaStream_t st) {
  if (op == kLambda && wo && !wi)
    return go_walk<T, DIM, LambdaOp<T, DIM>, false>(a, nullptr, wo, S, cap, s0, s1, c_first,
                                                    n_home, st);
  if (op == kDx && wi && !wo)
    return go_walk<T, DIM, DxOp<T, DIM>, true>(a, wi, nullptr, S, cap, s0, s1, c_first,
                                               n_home, st);
  return cudaErrorInvalidValue;
}

template <typename T>
int launch_walk(int op, const void* pos, const void* mass, const void* lam, const void* prm,
                void* out0, void* out1, const void* words_in, void* words_out, long long S,
                int cap, int dim, long long s0, long long s1, long long c_first,
                long long n_home, int n_words, int n_pow, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const Args<T> a = make_args<T>(pos, mass, lam, nullptr, prm, out0, out1, n_pow);
  if (S == 0 || n_home == 0) return cudaGetLastError();
  if (!layout_ok(S, cap, c_first, n_home) || (dim != 2 && dim != 3) ||
      n_words != (dim == 2 ? 3 : 9) * slab_words(cap))
    return cudaErrorInvalidValue;
  const auto wi = static_cast<const unsigned*>(words_in);
  const auto wo = static_cast<unsigned*>(words_out);
  if (dim == 2) return dispatch_walk<T, 2>(op, a, wi, wo, S, cap, s0, s1, c_first, n_home, st);
  return dispatch_walk<T, 3>(op, a, wi, wo, S, cap, s0, s1, c_first, n_home, st);
}

}  // namespace

// Fold ``op`` (dx without words, density_xsph, vorticity, vorticity_eta)
// over home cells [c_first, c_first + n_home) of the S / cap cells of the
// inputs; out0 and out1 hold their n_home * cap rows. The whole grid is
// c_first 0, n_home S / cap.
extern "C" int sph_pbf_f32(int op, const void* pos, const void* mass, const void* in_a,
                           const void* in_b, const void* prm, void* out0, void* out1,
                           long long S, int cap, int dim, long long s0, long long s1,
                           long long c_first, long long n_home, int n_pow, void* stream) {
  return launch<float>(op, pos, mass, in_a, in_b, prm, out0, out1, S, cap, dim, s0, s1,
                       c_first, n_home, n_pow, stream);
}

extern "C" int sph_pbf_f64(int op, const void* pos, const void* mass, const void* in_a,
                           const void* in_b, const void* prm, void* out0, void* out1,
                           long long S, int cap, int dim, long long s0, long long s1,
                           long long c_first, long long n_home, int n_pow, void* stream) {
  return launch<double>(op, pos, mass, in_a, in_b, prm, out0, out1, S, cap, dim, s0, s1,
                        c_first, n_home, n_pow, stream);
}

// The walk: op lambda (lam_in null) writes out0 = lambda, out1 = rho and the
// hit words to words_out, n_words = 3^(DIM-1) ceil(3 cap / 32) a home row
// (rows of empty home slots are not written); op dx (lam_in = lam of the
// buffer) walks words_in, lambda's words on the same pos, mass and home
// range, rows of the buffer. Home range and outputs as sph_pbf_*.
extern "C" int sph_pbf_walk_f32(int op, const void* pos, const void* mass, const void* lam_in,
                                const void* prm, void* out0, void* out1, const void* words_in,
                                void* words_out, long long S, int cap, int dim, long long s0,
                                long long s1, long long c_first, long long n_home, int n_words,
                                int n_pow, void* stream) {
  return launch_walk<float>(op, pos, mass, lam_in, prm, out0, out1, words_in, words_out, S,
                            cap, dim, s0, s1, c_first, n_home, n_words, n_pow, stream);
}

extern "C" int sph_pbf_walk_f64(int op, const void* pos, const void* mass, const void* lam_in,
                                const void* prm, void* out0, void* out1, const void* words_in,
                                void* words_out, long long S, int cap, int dim, long long s0,
                                long long s1, long long c_first, long long n_home, int n_words,
                                int n_pow, void* stream) {
  return launch_walk<double>(op, pos, mass, lam_in, prm, out0, out1, words_in, words_out, S,
                             cap, dim, s0, s1, c_first, n_home, n_words, n_pow, stream);
}
