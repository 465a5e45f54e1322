// SPH density over the binned slots: rho_i = sum_j m_j W_poly6(|x_i - x_j|).
//
// Replaces three kernels of the JAX package with the same function in
// gather form: each home slot sums m_j W(r) over the occupied slots of its
// cell's slab windows, the self pair giving W(0) naturally. Then, with
// MASK, 0 where the slot is not valid; then the floor max(rho, 1e-6 rho0).
// h^2, c6 and the floor come in prm, so each wrapper takes h from where its
// JAX function does.
//   * neighbors/pallas_sym.py density_sym (the main path, h = params.h) and
//     neighbors/pallas_pair.py density_pallas (h from the grid geometry):
//     MASK, as their wrappers mask before the floor (sph_density_*);
//   * neighbors/pallas_density.py density_pallas (h = params.h): no mask,
//     so an empty slot (mass 0) keeps whatever density its windows give its
//     stored position, and is only floored (sph_density_window_f32).
//
// What bounds it on the H100. Not DRAM: the function reads 17 bytes per
// slot and writes 4 (0.067 ms for the 10.7M slots of the 1M dam break at
// 3.35 TB/s), and its ~30 pairs in support per particle at 14 flops are
// 0.4 GFLOP (0.006 ms at 67 TFLOP/s). The walk over candidates bounds it:
// instruction issue and latency. The first design (one thread per slot
// over all 10.7M slots, 9.3% of them occupied) gave every live thread all
// 9 x 3 x 40 = 1080 window slots to walk, ~45% of them empty and ~97% of
// the rest beyond h, with a global load for each mass and coordinate, and
// warps split across two cells: 1.18 ms on the 1M dam break.
//
// This design (density_runs) gives work only to what is occupied. One CTA
// takes a run of R cells along the contiguous axis. Each warp first checks
// the run's masses itself; an all-empty run (most of the grid at 1M) writes
// the floor with coalesced stores and exits before any barrier. Otherwise
// the occupied home slots are packed by warp ballot, one thread per
// occupied home slot. For each slab the run's (R+2)-cell window of pos and
// mass is one linear span per field, copied into shared memory by the bulk
// copy engine (cp.async.bulk on an mbarrier), double-buffered so that slab
// s+2 is in flight while s is packed and walked; the staged slots are
// packed by ballot into float4 (x, y, z, m) records of the occupied slots,
// with each window cell's start. A home thread then walks only the records
// of its 3 window cells. What is left is the walk of occupied candidates
// (~600 per particle, ~5% of them in support) and, per run and slab, the
// copy, the packing and two barriers. The summation order is the first
// design's: within a slab, candidates in slot order into a partial,
// partials added in slab order.
//
// Without the mask (density_runs<.., false>) every slot is a home slot, but
// 91% of them at 1M are empty slots that sit at one stored position per
// cell (the zeros the placement wrote), and a candidate of mass 0 adds
// exactly 0. So the walk shrinks to that of the masked kernel plus one home
// per cell. A small pass first flags the cells that hold mass (cell_flags);
// a run exits early only when no cell of any of its slab windows is
// flagged, for then no home slot of it, occupied or empty, can gather
// anything: an empty run beside occupied cells is walked. Home records are
// the occupied slots and, of each cell's empty slots, the first one and
// every one whose stored position differs from the first one's in any bit;
// the others share the first one's record, hence its result, which is
// theirs bit for bit. Candidates stay the occupied window slots only. The
// first design (density_every_slot: a thread for every slot, walking every
// window slot from global memory) stays as the arm for a cap outside the
// runs' rule or inputs that do not start on 16-byte boundaries.
#include "common.cuh"

namespace {

template <typename T> struct Bits;
template <> struct Bits<float> {
  static __device__ __forceinline__ unsigned of(float x) { return __float_as_uint(x); }
};
template <> struct Bits<double> {
  static __device__ __forceinline__ long long of(double x) { return __double_as_longlong(x); }
};

// True when slots i and j store the same position, bit for bit.
template <typename T, int DIM>
__device__ __forceinline__ bool same_pos(const T* __restrict__ pos, long long i, long long j) {
  bool same = true;
#pragma unroll
  for (int d = 0; d < DIM; ++d)
    same = same && Bits<T>::of(pos[i * DIM + d]) == Bits<T>::of(pos[j * DIM + d]);
  return same;
}

// flags[c] = 1 where cell c holds a slot of mass != 0; flags start at 0.
// One thread per 16 bytes of mass, which lie in one cell as cap % 4 == 0.
template <typename T>
__global__ void __launch_bounds__(sph::kThreads)
cell_flags(const T* __restrict__ mass, int* __restrict__ flags, long long S, int cap) {
  constexpr int kPer = 16 / sizeof(T);
  const long long v = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (v * kPer >= S) return;
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(mass) + v);
  T x[kPer];
  memcpy(x, &u, sizeof(u));
  bool any = false;
#pragma unroll
  for (int e = 0; e < kPer; ++e) any = any || x[e] != T(0);
  if (any) flags[static_cast<unsigned>(v) / static_cast<unsigned>(cap / kPer)] = 1;
}

// The first design, kept as the unmasked arm of other caps: one thread per slot.
template <typename T, int DIM>
__global__ void __launch_bounds__(sph::kThreads)
density_every_slot(const T* __restrict__ pos, const T* __restrict__ mass,
                   const T* __restrict__ prm, T* __restrict__ rho, long long S, int cap,
                   long long s0, long long s1) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= S) return;
  const T h2 = prm[0], c6 = prm[1], floor_rho = prm[2];
  T acc = T(0);
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
  rho[i] = acc < floor_rho ? floor_rho : acc;
}

// Shared memory of one run: W = (R+2)*cap window slots, H = R*cap home slots.
template <typename T, int DIM>
struct RunSmem {
  uint64_t* bar;       // [2] one mbarrier per stage
  T* pos[2];           // [W*DIM] staged window positions
  T* mass[2];          // [W] staged window masses
  sph::Rec<T>* rec;    // [W] packed (x, y, z, m) of the occupied window slots
  int* start;          // [R+3] first record of each window cell
  unsigned* wmask;     // [W/32] occupancy of the stage being packed
  unsigned* hmask;     // [H/32] home slots that get a record
  int* rep;            // [R] first empty slot of each run cell, -1 if full
  int* hidx;           // [H] home slot -> home record, -1 if empty
  int* hcell;          // [H] home record -> run cell
  sph::Rec<T>* hrec;   // [H] home (x, y, z, -)
  T* hacc;             // [H] home density
  __host__ __device__ RunSmem(sph::Carve& c, int R, int cap) {
    const int W = (R + 2) * cap, H = R * cap;
    bar = c.take<uint64_t>(2);
    for (int b = 0; b < 2; ++b) {
      pos[b] = c.take<T>(static_cast<long long>(W) * DIM);
      mass[b] = c.take<T>(W);
    }
    rec = c.take<sph::Rec<T>>(W);
    start = c.take<int>(R + 3);
    wmask = c.take<unsigned>((W + 31) / 32);
    hmask = c.take<unsigned>((H + 31) / 32);
    rep = c.take<int>(R);
    hidx = c.take<int>(H);
    hcell = c.take<int>(H);
    hrec = c.take<sph::Rec<T>>(H);
    hacc = c.take<T>(H);
  }
};

// MASK: ``valid`` masks the result and ``flags`` is unused; otherwise
// ``valid`` is unused and ``flags`` are cell_flags' over the S / cap cells.
// The home cells are [c_first, c_end) of the S / cap cells of pos and mass;
// ``valid`` and ``rho`` hold the home slots only (their slot 0 is the first
// home slot). Windows read all S slots, so a buffer [margin | home |
// margin] gives its home slots what the whole grid would.
template <typename T, int DIM, bool MASK>
__global__ void __launch_bounds__(sph::kRunThreads)
density_runs(const T* __restrict__ pos, const T* __restrict__ mass,
             const bool* __restrict__ valid, const int* __restrict__ flags,
             const T* __restrict__ prm, T* __restrict__ rho,
             long long S, int cap, int R, long long s0, long long s1,
             long long c_first, long long c_end) {
  const long long c0 = c_first + static_cast<long long>(blockIdx.x) * R;
  const long long base = c0 * cap;  // first home slot
  const long long out0 = base - c_first * cap;  // its index in valid and rho
  const long long left = (c_end - c0) * cap;
  const int H = static_cast<int>(left < static_cast<long long>(R) * cap
                                     ? left : static_cast<long long>(R) * cap);
  const T h2 = prm[0], c6 = prm[1], floor_rho = prm[2];
  const int ns = DIM == 2 ? 3 : 9;
  bool idle;  // nothing in the run can be non-zero; every warp finds it itself
  if (MASK) {
    idle = sph::warp_all_zero(mass + base, H);
  } else {
    const long long C = S / cap;
    bool any = false;
    for (int t = threadIdx.x & 31; t < ns * (R + 2); t += 32) {
      const int s = t / (R + 2);
      const long long c = c0 + sph::slab_shift<DIM>(s, s0, s1) - 1 + (t - s * (R + 2));
      any = any || (c >= 0 && c < C && flags[c] != 0);
    }
    idle = !__any_sync(~0u, any);
  }
  if (idle) {  // 0, floored
    const T out = T(0) < floor_rho ? floor_rho : T(0);
    for (int i = threadIdx.x; i < H; i += blockDim.x) rho[out0 + i] = out;
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  sph::Carve carve(smem_raw);
  const RunSmem<T, DIM> sm(carve, R, cap);
  const int W = (R + 2) * cap, nchW = (W + 31) / 32, nchH = (H + 31) / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;

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

  // Home slots: one record per occupied slot, in slot order.
  for (int i = threadIdx.x; i < H; i += blockDim.x) sm.hidx[i] = -1;
  sph::occupancy(mass + base, H, 0, H, sm.hmask);
  __syncthreads();
  if (!MASK) {
    // Also one per cell for its empty slots, at the cell's first empty slot,
    // and one for each empty slot stored elsewhere than that one.
    for (int ci = threadIdx.x; ci < H / cap; ci += blockDim.x) {
      const int lo = ci * cap, hi = lo + cap;
      int r = -1;
      for (int k = lo >> 5; k <= (hi - 1) >> 5 && r < 0; ++k) {
        unsigned z = ~sm.hmask[k];
        if (k == lo >> 5) z &= ~0u << (lo & 31);
        if (k == hi >> 5) z &= (1u << (hi & 31)) - 1u;
        if (z) r = 32 * k + __ffs(z) - 1;
      }
      sm.rep[ci] = r;
    }
    __syncthreads();
    for (int k = warp; k < nchH; k += nw) {
      const int i = k * 32 + lane;
      bool rec = false;
      if (i < H) {
        rec = (sm.hmask[k] >> lane) & 1u;
        if (!rec) {
          const int r = sm.rep[i / cap];
          rec = i == r || !same_pos<T, DIM>(pos, base + i, base + r);
        }
      }
      const unsigned bits = __ballot_sync(~0u, rec);
      if (lane == 0) sm.hmask[k] = bits;
    }
    __syncthreads();
  }
  const sph::ChunkScan hs = sph::scan_chunks(sm.hmask, nchH);
  const int nh = hs.total;
  sph::pack_occupied(sm.hmask, nchH, hs, [&](int i, int r) {
    sph::Rec<T> x{};
#pragma unroll
    for (int d = 0; d < DIM; ++d) x.v[d] = pos[(base + i) * DIM + d];
    sm.hidx[i] = r;
    sm.hcell[r] = i / cap;
    sm.hrec[r] = x;
    sm.hacc[r] = T(0);
  });

  for (int s = 0; s < ns; ++s) {
    const int b = s & 1;
    const sph::Span w = sph::window(c0, sph::slab_shift<DIM>(s, s0, s1), cap, W, S);
    sph::mbar_wait(&sm.bar[b], (s >> 1) & 1);
    sph::occupancy(sm.mass[b], W, w.lo, w.hi, sm.wmask);
    __syncthreads();  // masks complete; the previous walk is over
    const sph::ChunkScan sc = sph::scan_chunks(sm.wmask, nchW);
    sph::pack_occupied(sm.wmask, nchW, sc, [&](int j, int r) {
      sph::Rec<T> p{};
#pragma unroll
      for (int d = 0; d < DIM; ++d) p.v[d] = sm.pos[b][j * DIM + d];
      p.v[3] = sm.mass[b][j];
      sm.rec[r] = p;
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
      const sph::Rec<T> xi = sm.hrec[k];
      T part = T(0);
      for (int j = sm.start[lc]; j < j1; ++j) {
        const sph::Rec<T> p = sm.rec[j];
        T d = xi.v[0] - p.v[0];
        T r2 = d * d;
#pragma unroll
        for (int e = 1; e < DIM; ++e) {
          d = xi.v[e] - p.v[e];
          r2 = r2 + d * d;
        }
        const T q = h2 - r2;
        if (q <= T(0)) continue;  // outside the support: W = 0 exactly
        part += p.v[3] * (c6 * q * q * q);
      }
      sm.hacc[k] += part;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    const int r = sm.hidx[i];
    T acc;
    if (MASK) {
      acc = r >= 0 && valid[out0 + i] ? sm.hacc[r] : T(0);
    } else {  // an empty slot without a record shares its cell's
      acc = sm.hacc[r >= 0 ? r : sm.hidx[sm.rep[i / cap]]];
    }
    rho[out0 + i] = acc < floor_rho ? floor_rho : acc;
  }
}

template <typename T, int DIM, bool MASK>
cudaError_t go_runs(const T* p, const T* m, const bool* v, const int* flags, const T* c, T* out,
                    long long S, int cap, long long s0, long long s1, long long c_first,
                    long long n_home, cudaStream_t st) {
  const int run = sph::run_cells(cap);
  sph::Carve carve(nullptr);  // counts the bytes of the layout
  const RunSmem<T, DIM> layout(carve, run, cap);
  (void)layout;
  const auto kernel = density_runs<T, DIM, MASK>;
  const cudaError_t err = sph::allow_smem(kernel, carve.off);
  if (err != cudaSuccess) return err;
  const long long runs = (n_home + run - 1) / run;
  if (runs == 0) return cudaGetLastError();
  kernel<<<static_cast<unsigned>(runs), sph::kRunThreads, carve.off, st>>>(
      p, m, v, flags, c, out, S, cap, run, s0, s1, c_first, c_first + n_home);
  return cudaGetLastError();
}

// The unmasked density: the runs where they can stage the layout (then
// ``flags``, S / cap ints of scratch, is written), else a thread per slot.
template <typename T, int DIM>
cudaError_t go_window(const T* p, const T* m, const T* c, int* flags, T* out, long long S,
                      int cap, long long s0, long long s1, cudaStream_t st) {
  constexpr int kPer = 16 / sizeof(T);
  if (!sph::run_cap_ok(cap) || !sph::aligned16(p) || !sph::aligned16(m) ||
      S / kPer > 0xffffffffLL) {
    density_every_slot<T, DIM><<<sph::blocks_for(S), sph::kThreads, 0, st>>>(
        p, m, c, out, S, cap, s0, s1);
    return cudaGetLastError();
  }
  cudaError_t err = cudaMemsetAsync(flags, 0, static_cast<size_t>(S / cap) * sizeof(int), st);
  if (err != cudaSuccess) return err;
  cell_flags<T><<<sph::blocks_for(S / kPer), sph::kThreads, 0, st>>>(m, flags, S, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return go_runs<T, DIM, false>(p, m, nullptr, flags, c, out, S, cap, s0, s1, 0, S / cap, st);
}

template <typename T>
int launch(const void* pos, const void* mass, const void* valid, const void* prm,
           void* rho, long long S, int cap, int dim, long long s0, long long s1,
           long long c_first, long long n_home, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto p = static_cast<const T*>(pos);
  const auto m = static_cast<const T*>(mass);
  const auto v = static_cast<const bool*>(valid);
  const auto c = static_cast<const T*>(prm);
  const auto out = static_cast<T*>(rho);
  if (S == 0 || n_home == 0) return cudaGetLastError();
  if (!sph::run_cap_ok(cap) || c_first < 0 || n_home < 0 || (c_first + n_home) * cap > S)
    return cudaErrorInvalidValue;
  if (dim == 2)
    return go_runs<T, 2, true>(p, m, v, nullptr, c, out, S, cap, s0, s1, c_first, n_home, st);
  if (dim == 3)
    return go_runs<T, 3, true>(p, m, v, nullptr, c, out, S, cap, s0, s1, c_first, n_home, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Home cells [c_first, c_first + n_home) of the S / cap cells of pos and
// mass; valid and rho hold their n_home * cap slots. The whole grid is
// c_first 0, n_home S / cap.
extern "C" int sph_density_f32(const void* pos, const void* mass, const void* valid,
                               const void* prm, void* rho, long long S, int cap,
                               int dim, long long s0, long long s1, long long c_first,
                               long long n_home, void* stream) {
  return launch<float>(pos, mass, valid, prm, rho, S, cap, dim, s0, s1, c_first, n_home,
                       stream);
}

extern "C" int sph_density_f64(const void* pos, const void* mass, const void* valid,
                               const void* prm, void* rho, long long S, int cap,
                               int dim, long long s0, long long s1, long long c_first,
                               long long n_home, void* stream) {
  return launch<double>(pos, mass, valid, prm, rho, S, cap, dim, s0, s1, c_first, n_home,
                        stream);
}

extern "C" int sph_density_window_f32(const void* pos, const void* mass, const void* prm,
                                      void* flags, void* rho, long long S, int cap, int dim,
                                      long long s0, long long s1, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto p = static_cast<const float*>(pos), m = static_cast<const float*>(mass);
  const auto c = static_cast<const float*>(prm);
  const auto f = static_cast<int*>(flags);
  const auto out = static_cast<float*>(rho);
  if (S == 0) return cudaGetLastError();
  if (cap <= 0) return cudaErrorInvalidValue;
  if (dim == 2) return go_window<float, 2>(p, m, c, f, out, S, cap, s0, s1, st);
  if (dim == 3) return go_window<float, 3>(p, m, c, f, out, S, cap, s0, s1, st);
  return cudaErrorInvalidValue;
}
