// The per-slot passes of the binned solvers' step loop, one launch each.
//
// Replaces no TPU kernel: the JAX package leaves these elementwise passes
// to XLA, which fuses them. The port ran them as eager torch operations,
// each a pass over all S slots (about 40 a WCSPH step: the body forces, the
// move mask, Euler, the speed clamp, XSPH, the max reduction of travel),
// 1.8 ms of a 5.8 ms step of the 1M dam break (PERF.md); the obstacle
// penalty (scenes/obstacles.accel) was ~28 more launches over every slot,
// with [S, M, DIM] temporaries; PBF's projections and epilogue ~4.7 ms of
// a 13.2 ms step. This kernel makes each group one pass, in instantiations
// chosen by the call site (solvers/integrate.py):
//
//   UPDATE (wcsph_binned.step, after forces), on the slots that move:
//     a  = ((acc + g) + wall(x, v)) [+ obstacle(x, v, t)]
//     v' = clamp(v + dt a),  va = v' + xsph_eps xsph,  x' = x + dt va
//   other slots keep x and get v' = 0; travel' = travel + dt sqrt(max |va|^2).
//   PREDICT (pbf.step): a = ((0 + g) + wall(x, v)) [+ obstacle(x, v, t)],
//     x* = x + dt clamp(v + dt a) on the slots that move, x elsewhere;
//   travel' = travel + sqrt(max |x* - x|^2).
// The obstacle term is the OBS instantiations' (a scene with an Obstacles,
// even one with no shapes); the others compile without it.
//   PBF's other passes, an overload of the same name on PbfArgs (pbf.step):
//   PROJECT after each dx fold, d = sor dx capped at proj_cap, x' = x + d
//     clamped to the box on the wall axes, travel' = travel + max |d|;
//   VELOCITY before the epilogue's fold, m / rho_prev (rho0 where it is not
//     positive) and v = clamp((x* - x0) / dt), minimum image on the periodic
//     axes; MIX after each later fold, max(valid ? rho : 0, floor) and
//     v' = clamp(v + coef dv). Slots that do not move keep x (PROJECT) or get
//     v = 0.
//
// wall(x, v) = k (lo - hi) - (c min(max_k(lo_k + hi_k) / (0.1 h), 1)) v with
// lo = max(bmin - x, 0), hi = max(x - bmax, 0), zeroed on the axes without
// walls (periodic ones); clamp(v) = v max_speed rsqrt(|v|^2) where |v| passes
// max_speed. A slot moves when it is valid and its owner is below
// frozen_from (frozen boundary particles; -1: none is frozen).
//
// obstacle(x, v, t) is obstacles.accel's: each shape moves by off(t) = lin t
// + amp sin(w t + phase) with w = 2 pi freq, its surface at vob = lin +
// amp (w cos(w t + phase)). A sphere of radius r pushes with pen = max(r -
// |x - c|, 0) along (x - c) / |x - c| (|d| = sqrt(max(|d|^2, 1e-12))); a box
// pushes a slot strictly inside it by pen = the least distance to a face,
// out through that face (the first axis on ties). Per kind, k_o sum(pen
// dir) - c_o sum(min(pen / ramp_dist, 1) (v - vob)); spheres, then boxes
// added; no shape at all gives +0, as torch's zeros_like does.
//
// Arithmetic: the torch composition's (integrate.py update_plain,
// predict_plain, project_plain, pbf_velocity_plain, pbf_mix_plain),
// operation by operation and in its order: each product
// and sum rounded on its own (__fmul_rn / __fadd_rn: torch runs them as
// separate kernels, so nothing may be contracted into an FMA), rsqrt, sqrt,
// sin, cos and round (half to even) as torch's CUDA kernels call them,
// clamps, minimums and maximums that pass NaN through, the sum of squares in the order of torch's reduction
// over a row of 2 or 3: x^2 + y^2, and (x^2 + z^2) + y^2 (two lanes, the
// first holding elements 0 and 2), and the sums over the shapes in the order
// of its reduction over the middle axis of [S, M, DIM]: four accumulators
// from 0, shape m into m % 4, then ((l0 + l1) + l2) + l3.
//
// travel: each thread keeps the largest squared norm it saw as the bits of
// the non-negative float, which order as unsigned integers (a NaN above
// every number, as torch's amax propagates it); the block's largest goes to
// scratch[0] by atomicMax, and the last block to finish (scratch[1] counts
// them) writes travel'. The wrapper zeroes scratch; nothing is read back
// to the host.
//
// What bounds it on the H100: bytes. Every slot's valid flag, pos in and
// out, and (UPDATE) vel out; vel, acc and xsph (PREDICT: vel) only of the
// slots that move: 0.43 GB (0.13 ms at 3.35 TB/s) for UPDATE on the 10.7M
// slots of the 1M dam break in float32, 0.28 GB (0.084 ms) for PREDICT and
// PROJECT (dx in place of vel), 0.29 GB (0.087 ms) for VELOCITY (mass and
// rho_prev in, m / rho out of every slot), 0.21 GB (0.063 ms) for MIX.
// The obstacle term adds no bytes a slot: it reads the x and v the update
// loads, and a few dozen shape constants every thread reads alike (cached);
// its sines and cosines, a few dozen flops a shape, run only on the slots
// that move.
// The design: a grid-stride loop, one slot a thread per pass, as many
// blocks as fill the card, scalar loads (a warp's 32 slots are contiguous,
// so its loads of one field cover whole lines), the gathers of the moving
// slots' inputs skipped for the 90% of slots that are empty.
#include "common.cuh"

namespace {

constexpr int kUpdate = 0;
constexpr int kPredict = 1;
constexpr int kProject = 2;
constexpr int kVelocity = 3;
constexpr int kMix = 4;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double quot(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }

__device__ __forceinline__ unsigned long long bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ unsigned long long bits(double x) {
  return static_cast<unsigned long long>(__double_as_longlong(x));
}
template <typename T> __device__ __forceinline__ T from_bits(unsigned long long b);
template <> __device__ __forceinline__ float from_bits<float>(unsigned long long b) {
  return __uint_as_float(static_cast<unsigned>(b));
}
template <> __device__ __forceinline__ double from_bits<double>(unsigned long long b) {
  return __longlong_as_double(static_cast<long long>(b));
}

// torch.clamp(x, min=lo) and torch.clamp(x, max=hi): NaN passes through.
__device__ __forceinline__ float clamp_lo(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp_hi(float x, float hi) { return isnan(x) ? x : fminf(x, hi); }
__device__ __forceinline__ double clamp_lo(double x, double lo) { return isnan(x) ? x : fmax(x, lo); }
__device__ __forceinline__ double clamp_hi(double x, double hi) { return isnan(x) ? x : fmin(x, hi); }

__device__ __forceinline__ unsigned long long umax(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

// The largest over the grid of every thread's ``best`` (the bits of a
// non-negative float, or of a NaN): the block's largest, then the grid's by
// atomicMax into scratch[0]. True in one thread of the last block to finish
// (scratch[1] counts them), with m the largest; false in every other.
template <typename T>
__device__ __forceinline__ bool grid_max(unsigned long long best, unsigned long long* scratch,
                                         T& m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) best = umax(best, __shfl_xor_sync(0xffffffffu, best, off));
  __shared__ unsigned long long warp_best[sph::kThreads / 32];
  if (threadIdx.x % 32 == 0) warp_best[threadIdx.x / 32] = best;
  __syncthreads();
  if (threadIdx.x != 0) return false;
  for (int w = 1; w < sph::kThreads / 32; ++w) best = umax(best, warp_best[w]);
  atomicMax(&scratch[0], best);
  __threadfence();
  if (atomicAdd(&scratch[1], 1ull) != gridDim.x - 1) return false;
  m = from_bits<T>(atomicMax(&scratch[0], 0ull));  // every block's, read at L2
  return true;
}

// The sum of squares of a row, in the order of torch's CUDA sum over it.
template <typename T, int DIM> __device__ __forceinline__ T sumsq(const T (&v)[DIM]) {
  if (DIM == 2) return add(mul(v[0], v[0]), mul(v[1], v[1]));
  return add(add(mul(v[0], v[0]), mul(v[2], v[2])), mul(v[1], v[1]));
}

// torch.round of CUDA tensors: half to even.
__device__ __forceinline__ float round_t(float x) { return nearbyintf(x); }
__device__ __forceinline__ double round_t(double x) { return nearbyint(x); }

// torch.sin and torch.cos of CUDA tensors call these.
__device__ __forceinline__ float sin_t(float x) { return sinf(x); }
__device__ __forceinline__ float cos_t(float x) { return cosf(x); }
__device__ __forceinline__ double sin_t(double x) { return sin(x); }
__device__ __forceinline__ double cos_t(double x) { return cos(x); }

// torch.minimum: NaN where either is NaN.
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) || isnan(b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ double minimum(double a, double b) {
  return isnan(a) || isnan(b) ? __longlong_as_double(0x7ff8000000000000ll) : fmin(a, b);
}

// The obstacles (scenes/obstacles.Obstacles), OBS only: shapes of a kind
// one after another, [DIM] vectors row by row; the clock t is sim_time.
template <typename T>
struct Shapes {
  const T* sphere_center;  // [ms, DIM]
  const T* sphere_radius;  // [ms]
  const T* box_lo;         // [mb, DIM]
  const T* box_hi;         // [mb, DIM]
  const T* sphere_lin;     // [ms, DIM]
  const T* sphere_amp;     // [ms, DIM]
  const T* sphere_freq;    // [ms]
  const T* sphere_phase;   // [ms]
  const T* box_lin;        // [mb, DIM]
  const T* box_amp;        // [mb, DIM]
  const T* box_freq;       // [mb]
  const T* box_phase;      // [mb]
  const T* stiffness;
  const T* damping;
  const T* ramp_dist;
  const T* t;
  int ms;
  int mb;
};

// A shape's translation and surface velocity at time t (obstacles._offsets).
template <typename T, int DIM>
__device__ __forceinline__ void offsets(const T* lin, const T* amp, T freq, T phase, T t,
                                        T (&off)[DIM], T (&vob)[DIM]) {
  const T w = mul(T(6.283185307179586), freq);
  const T ang = add(mul(w, t), phase);
  const T s = sin_t(ang), c = mul(w, cos_t(ang));
#pragma unroll
  for (int e = 0; e < DIM; ++e) {
    off[e] = add(mul(lin[e], t), mul(amp[e], s));
    vob[e] = add(lin[e], mul(amp[e], c));
  }
}

// The two sums over one kind's shapes (spring: pen dir; damper: ramp (v -
// vob)), in the order of torch's reduction over the shapes' axis; kind 0
// spheres, 1 boxes.
template <typename T, int DIM, int KIND>
__device__ __forceinline__ void shape_sums(const Shapes<T>& o, const T (&x)[DIM],
                                           const T (&v)[DIM], T t, T rd, T (&s1)[DIM],
                                           T (&s2)[DIM]) {
  const int n = KIND == 0 ? o.ms : o.mb;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    T l1[DIM], l2[DIM];
#pragma unroll
    for (int e = 0; e < DIM; ++e) l1[e] = l2[e] = T(0);
    for (int m = j; m < n; m += 4) {
      T off[DIM], vob[DIM], dir[DIM], pen;
      if (KIND == 0) {
        offsets<T, DIM>(o.sphere_lin + m * DIM, o.sphere_amp + m * DIM, o.sphere_freq[m],
                        o.sphere_phase[m], t, off, vob);
        T d[DIM];
#pragma unroll
        for (int e = 0; e < DIM; ++e) d[e] = sub(x[e], add(o.sphere_center[m * DIM + e], off[e]));
        const T dist = root(clamp_lo(sumsq<T, DIM>(d), T(1e-12)));
        pen = clamp_lo(sub(o.sphere_radius[m], dist), T(0));
#pragma unroll
        for (int e = 0; e < DIM; ++e) dir[e] = quot(d[e], dist);
      } else {
        offsets<T, DIM>(o.box_lin + m * DIM, o.box_amp + m * DIM, o.box_freq[m],
                        o.box_phase[m], t, off, vob);
        // inside, and the face of least distance (argmin: a NaN first,
        // then the first axis on ties) with its side
        bool inside = true, low = false;
        int ax = 0;
        T best = T(0);
#pragma unroll
        for (int e = 0; e < DIM; ++e) {
          const T lo = add(o.box_lo[m * DIM + e], off[e]);
          const T hi = add(o.box_hi[m * DIM + e], off[e]);
          inside = inside && x[e] > lo && x[e] < hi;
          const T d_lo = sub(x[e], lo), d_hi = sub(hi, x[e]);
          const T f = minimum(d_lo, d_hi);
          if (e == 0 || (isnan(f) ? !isnan(best) : f < best)) {
            ax = e;
            best = f;
            low = d_lo <= d_hi;
          }
        }
        const T sign = low ? T(-1) : T(1);
        pen = inside ? best : T(0);
#pragma unroll
        for (int e = 0; e < DIM; ++e) dir[e] = mul(sign, e == ax ? T(1) : T(0));
      }
      const T ramp = clamp_hi(quot(pen, rd), T(1));
#pragma unroll
      for (int e = 0; e < DIM; ++e) {
        l1[e] = add(l1[e], mul(pen, dir[e]));
        l2[e] = add(l2[e], mul(ramp, sub(v[e], vob[e])));
      }
    }
#pragma unroll
    for (int e = 0; e < DIM; ++e) {
      s1[e] = j == 0 ? l1[e] : add(s1[e], l1[e]);
      s2[e] = j == 0 ? l2[e] : add(s2[e], l2[e]);
    }
  }
}

// obstacles.accel(x, v, t) of one slot.
template <typename T, int DIM>
__device__ __forceinline__ void obstacle(const Shapes<T>& o, const T (&x)[DIM],
                                         const T (&v)[DIM], T (&out)[DIM]) {
  const T t = o.t[0], k = o.stiffness[0], c = o.damping[0], rd = o.ramp_dist[0];
  T s1[DIM], s2[DIM];
#pragma unroll
  for (int e = 0; e < DIM; ++e) out[e] = T(0);
  if (o.ms > 0) {
    shape_sums<T, DIM, 0>(o, x, v, t, rd, s1, s2);
#pragma unroll
    for (int e = 0; e < DIM; ++e) out[e] = sub(mul(k, s1[e]), mul(c, s2[e]));
  }
  if (o.mb > 0) {
    shape_sums<T, DIM, 1>(o, x, v, t, rd, s1, s2);
#pragma unroll
    for (int e = 0; e < DIM; ++e) {
      const T spring = mul(k, s1[e]);
      out[e] = sub(o.ms > 0 ? add(out[e], spring) : spring, mul(c, s2[e]));
    }
  }
}

template <typename T>
struct Args {
  const T* pos;
  const T* vel;
  const T* acc;    // UPDATE: the pair acceleration; PREDICT: unused
  const T* xsph;   // UPDATE: the XSPH sum; PREDICT: unused
  const bool* valid;
  const int* owner;
  const T* dt;
  const T* xsph_eps;
  const T* max_speed;
  const T* h;
  const T* stiffness;
  const T* damping;
  const T* gravity;  // [DIM]
  const T* bmin;     // [DIM]
  const T* bmax;     // [DIM]
  T* pos_out;
  T* vel_out;        // UPDATE only
  const T* travel;
  T* travel_out;
  unsigned long long* scratch;  // [0] largest squared norm's bits, [1] blocks done
  long long S;
  long long frozen_from;
  int walls;  // bit k: spatial axis k has walls
  bool mask;  // some axis has none: torch's multiply by the axis mask
  Shapes<T> ob;  // OBS only
};

template <typename T, int DIM, int MODE, bool OBS>
__global__ void __launch_bounds__(sph::kThreads) integrate_slots(const Args<T> a) {
  const T dt = a.dt[0], ms = a.max_speed[0], k = a.stiffness[0], c = a.damping[0];
  const T xe = MODE == kUpdate ? a.xsph_eps[0] : T(0);
  const T cap2 = mul(ms, ms);
  const T ramp_len = mul(a.h[0], T(0.1));
  T g[DIM], lo_b[DIM], hi_b[DIM];
#pragma unroll
  for (int e = 0; e < DIM; ++e) {
    g[e] = a.gravity[e];
    lo_b[e] = a.bmin[e];
    hi_b[e] = a.bmax[e];
  }
  unsigned long long best = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < a.S;
       i += stride) {
    T x[DIM];
#pragma unroll
    for (int e = 0; e < DIM; ++e) x[e] = a.pos[i * DIM + e];
    bool move = a.valid[i];
    if (move && a.frozen_from >= 0) move = a.owner[i] < a.frozen_from;
    if (!move) {
#pragma unroll
      for (int e = 0; e < DIM; ++e) {
        a.pos_out[i * DIM + e] = x[e];
        if (MODE == kUpdate) a.vel_out[i * DIM + e] = T(0);
      }
      if (MODE == kPredict) {  // x* - x of a slot that stays: 0 unless x is not finite
        T d[DIM];
#pragma unroll
        for (int e = 0; e < DIM; ++e) d[e] = sub(x[e], x[e]);
        best = umax(best, bits(sumsq<T, DIM>(d)));
      }
      continue;
    }
    T v[DIM], lo[DIM], hi[DIM];
#pragma unroll
    for (int e = 0; e < DIM; ++e) {
      v[e] = a.vel[i * DIM + e];
      lo[e] = clamp_lo(sub(lo_b[e], x[e]), T(0));
      hi[e] = clamp_lo(sub(x[e], hi_b[e]), T(0));
      if (a.mask && !((a.walls >> e) & 1)) {
        lo[e] = mul(lo[e], T(0));
        hi[e] = mul(hi[e], T(0));
      }
    }
    T pen = add(lo[0], hi[0]);
#pragma unroll
    for (int e = 1; e < DIM; ++e) {
      const T p = add(lo[e], hi[e]);
      pen = (isnan(pen) || pen >= p) ? pen : p;
    }
    const T damp = mul(c, clamp_hi(quot(pen, ramp_len), T(1)));
    [[maybe_unused]] T ob[DIM];
    if constexpr (OBS) obstacle<T, DIM>(a.ob, x, v, ob);
#pragma unroll
    for (int e = 0; e < DIM; ++e) {
      const T pair = MODE == kUpdate ? a.acc[i * DIM + e] : T(0);
      T acc = add(add(pair, g[e]), sub(mul(k, sub(lo[e], hi[e])), mul(damp, v[e])));
      if constexpr (OBS) acc = add(acc, ob[e]);
      v[e] = add(v[e], mul(dt, acc));
    }
    const T s2 = sumsq<T, DIM>(v);
    if (s2 > cap2) {
      const T scale = mul(ms, sph::rsqrt_t(s2));
#pragma unroll
      for (int e = 0; e < DIM; ++e) v[e] = mul(v[e], scale);
    }
    T d[DIM];
#pragma unroll
    for (int e = 0; e < DIM; ++e) {
      if (MODE == kUpdate) {
        d[e] = add(v[e], mul(xe, a.xsph[i * DIM + e]));  // the advected velocity
        a.pos_out[i * DIM + e] = add(x[e], mul(dt, d[e]));
        a.vel_out[i * DIM + e] = v[e];
      } else {
        const T xs = add(x[e], mul(dt, v[e]));
        a.pos_out[i * DIM + e] = xs;
        d[e] = sub(xs, x[e]);
      }
    }
    best = umax(best, bits(sumsq<T, DIM>(d)));
  }

  T m;
  if (!grid_max(best, a.scratch, m)) return;
  const T norm = root(clamp_lo(m, T(0)));
  a.travel_out[0] = add(a.travel[0], MODE == kUpdate ? mul(dt, norm) : norm);
}

template <typename T>
struct PbfArgs {
  const T* pos;        // PROJECT: x; VELOCITY: x*
  const T* dx;         // PROJECT: dx_fold's sum, before sor
  const T* pos0;       // VELOCITY: the step-start positions
  const T* vel;        // MIX: the velocity the sum is added to
  const T* dv;         // MIX: the XSPH (or vorticity) sum
  const T* rho;        // VELOCITY: the previous step's density; MIX: the fold's, or null
  const T* mass;       // VELOCITY
  const bool* valid;
  const int* owner;
  const T* sor;        // PROJECT
  const T* proj_cap;   // PROJECT
  const T* bmin;       // PROJECT [DIM]
  const T* bmax;       // PROJECT [DIM]
  const T* dt;         // VELOCITY
  const T* max_speed;  // VELOCITY, MIX
  const T* rho0;       // VELOCITY
  const T* period;     // VELOCITY: [DIM] lengths, 0 on wall axes; null: no periodic axis
  const T* coef;       // MIX: the sum's coefficient
  const T* floor;      // MIX, with rho: the density floor
  T* pos_out;          // PROJECT
  T* vel_out;          // VELOCITY, MIX
  T* rho_out;          // VELOCITY: m / rho; MIX, with rho: the floored density
  const T* travel;     // PROJECT
  T* travel_out;       // PROJECT
  unsigned long long* scratch;  // PROJECT: as Args'
  long long S;
  long long frozen_from;
  int walls;  // bit k: spatial axis k has walls
};

// torch.maximum: the first NaN operand, else the larger.
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b);
}
__device__ __forceinline__ double maximum(double a, double b) {
  return isnan(a) ? a : isnan(b) ? b : fmax(a, b);
}

// torch.clamp(x, lo, hi) with tensor bounds: NaN passes through.
__device__ __forceinline__ float clamp_box(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ double clamp_box(double x, double lo, double hi) {
  return isnan(x) ? x : fmin(fmax(x, lo), hi);
}

// wcsph.clamp_speed of one row, as torch runs it: every row is multiplied
// by its scale, 1 where the speed is within the cap.
template <typename T, int DIM>
__device__ __forceinline__ void clamp_speed(T (&v)[DIM], T ms, T cap2) {
  const T s2 = sumsq<T, DIM>(v);
  const T scale = s2 > cap2 ? mul(ms, sph::rsqrt_t(s2)) : T(1);
#pragma unroll
  for (int e = 0; e < DIM; ++e) v[e] = mul(v[e], scale);
}

// PBF's PROJECT, VELOCITY and MIX (the header's), one slot a thread as
// above; only PROJECT reduces.
template <typename T, int DIM, int MODE>
__global__ void __launch_bounds__(sph::kThreads) integrate_slots(const PbfArgs<T> a) {
  T sor = T(0), cap = T(0), dt = T(0), rho0 = T(0), coef = T(0), least = T(0), ms = T(0);
  T lo_b[DIM], hi_b[DIM];
  if (MODE == kProject) {
    sor = a.sor[0];
    cap = a.proj_cap[0];
#pragma unroll
    for (int e = 0; e < DIM; ++e) {
      lo_b[e] = a.bmin[e];
      hi_b[e] = a.bmax[e];
    }
  } else {
    ms = a.max_speed[0];
  }
  if (MODE == kVelocity) {
    dt = a.dt[0];
    rho0 = a.rho0[0];
  }
  if (MODE == kMix) {
    coef = a.coef[0];
    if (a.rho_out != nullptr) least = a.floor[0];
  }
  const T cap2 = mul(ms, ms);
  unsigned long long best = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < a.S;
       i += stride) {
    const bool valid = a.valid[i];
    if (MODE == kVelocity) {
      const T r = a.rho[i];
      a.rho_out[i] = quot(a.mass[i], r > T(0) ? r : rho0);
    }
    if (MODE == kMix && a.rho_out != nullptr) {
      a.rho_out[i] = maximum(valid ? a.rho[i] : T(0), least);
    }
    bool move = valid;
    if (move && a.frozen_from >= 0) move = a.owner[i] < a.frozen_from;
    if (!move) {
#pragma unroll
      for (int e = 0; e < DIM; ++e) {
        if (MODE == kProject) a.pos_out[i * DIM + e] = a.pos[i * DIM + e];
        else a.vel_out[i * DIM + e] = T(0);
      }
      continue;
    }
    T v[DIM];
    if (MODE == kProject) {
#pragma unroll
      for (int e = 0; e < DIM; ++e) v[e] = mul(sor, a.dx[i * DIM + e]);
      const T n = root(clamp_lo(sumsq<T, DIM>(v), T(1e-30)));
      const T r = clamp_hi(quot(cap, n), T(1));
#pragma unroll
      for (int e = 0; e < DIM; ++e) {
        v[e] = mul(v[e], r);
        const T x = add(a.pos[i * DIM + e], v[e]);
        a.pos_out[i * DIM + e] = (a.walls >> e) & 1 ? clamp_box(x, lo_b[e], hi_b[e]) : x;
      }
      best = umax(best, bits(sumsq<T, DIM>(v)));
      continue;
    }
    if (MODE == kVelocity) {
#pragma unroll
      for (int e = 0; e < DIM; ++e) {
        T d = sub(a.pos[i * DIM + e], a.pos0[i * DIM + e]);
        if (a.period != nullptr) {
          const T L = a.period[e];
          if (L > T(0)) d = sub(d, mul(L, round_t(quot(d, L))));
        }
        v[e] = quot(d, dt);
      }
    } else {
#pragma unroll
      for (int e = 0; e < DIM; ++e) v[e] = add(a.vel[i * DIM + e], mul(coef, a.dv[i * DIM + e]));
    }
    clamp_speed<T, DIM>(v, ms, cap2);
#pragma unroll
    for (int e = 0; e < DIM; ++e) a.vel_out[i * DIM + e] = v[e];
  }
  if (MODE != kProject) return;
  T m;
  if (!grid_max(best, a.scratch, m)) return;
  a.travel_out[0] = add(a.travel[0], root(clamp_lo(m, T(0))));
}

// Launch ``kernel`` on as many blocks as fill the card (``per_sm`` a
// multiprocessor), at most one thread a slot.
template <typename A>
cudaError_t fill_card(void (*kernel)(A), int per_sm, const A& a, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const unsigned fill = static_cast<unsigned>(sms * per_sm);
  const unsigned need = sph::blocks_for(a.S);
  kernel<<<need < fill ? need : fill, sph::kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename A>
int blocks_per_sm(void (*kernel)(A)) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, sph::kThreads, 0);
  return n > 0 ? n : 1;
}

template <typename T, int DIM, int MODE, bool OBS>
cudaError_t run(const Args<T>& a, cudaStream_t st) {
  void (*kernel)(Args<T>) = integrate_slots<T, DIM, MODE, OBS>;
  static const int per_sm = blocks_per_sm(kernel);
  return fill_card(kernel, per_sm, a, st);
}

template <typename T, int DIM, int MODE>
cudaError_t run_pbf(const PbfArgs<T>& a, cudaStream_t st) {
  void (*kernel)(PbfArgs<T>) = integrate_slots<T, DIM, MODE>;
  static const int per_sm = blocks_per_sm(kernel);
  return fill_card(kernel, per_sm, a, st);
}

template <typename T, int DIM, int MODE>
cudaError_t dispatch(const Args<T>& a, bool obs, cudaStream_t st) {
  return obs ? run<T, DIM, MODE, true>(a, st) : run<T, DIM, MODE, false>(a, st);
}

template <typename T>
int launch(int mode, const void* pos, const void* vel, const void* acc, const void* xsph,
           const void* const* obs, int ms, int mb, const void* valid, const void* owner,
           const void* dt, const void* xsph_eps, const void* max_speed, const void* h,
           const void* stiffness, const void* damping, const void* gravity, const void* bmin,
           const void* bmax, void* pos_out, void* vel_out, const void* travel,
           void* travel_out, void* scratch, long long S, int dim, int walls,
           long long frozen_from, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if ((dim != 2 && dim != 3) || S <= 0) return cudaErrorInvalidValue;
  if (mode == kUpdate && (acc == nullptr || xsph == nullptr || vel_out == nullptr))
    return cudaErrorInvalidValue;
  if (mode != kUpdate && mode != kPredict) return cudaErrorInvalidValue;
  if (obs != nullptr && (ms < 0 || mb < 0)) return cudaErrorInvalidValue;
  const auto P = [](const void* p) { return static_cast<const T*>(p); };
  Shapes<T> ob{};
  if (obs != nullptr) {
    ob = {P(obs[0]), P(obs[1]), P(obs[2]), P(obs[3]), P(obs[4]), P(obs[5]), P(obs[6]),
          P(obs[7]), P(obs[8]), P(obs[9]), P(obs[10]), P(obs[11]), P(obs[12]), P(obs[13]),
          P(obs[14]), P(obs[15]), ms, mb};
  }
  const Args<T> a{
      P(pos), P(vel), P(acc), P(xsph),
      static_cast<const bool*>(valid), static_cast<const int*>(owner),
      P(dt), P(xsph_eps), P(max_speed), P(h), P(stiffness), P(damping),
      P(gravity), P(bmin), P(bmax),
      static_cast<T*>(pos_out), static_cast<T*>(vel_out), P(travel), static_cast<T*>(travel_out),
      static_cast<unsigned long long*>(scratch), S, frozen_from, walls,
      walls != (1 << dim) - 1, ob};
  const bool o = obs != nullptr;
  if (dim == 2)
    return mode == kUpdate ? dispatch<T, 2, kUpdate>(a, o, st)
                           : dispatch<T, 2, kPredict>(a, o, st);
  return mode == kUpdate ? dispatch<T, 3, kUpdate>(a, o, st) : dispatch<T, 3, kPredict>(a, o, st);
}

template <typename T, int MODE>
cudaError_t dispatch_pbf(const PbfArgs<T>& a, int dim, cudaStream_t st) {
  return dim == 2 ? run_pbf<T, 2, MODE>(a, st) : run_pbf<T, 3, MODE>(a, st);
}

template <typename T>
int launch_pbf(int mode, const void* const* in, const void* valid, const void* owner,
               void* pos_out, void* vel_out, void* rho_out, void* travel_out, void* scratch,
               long long S, int dim, int walls, long long frozen_from, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto P = [in](int k) { return static_cast<const T*>(in[k]); };
  const PbfArgs<T> a{
      P(0), P(1), P(2), P(3), P(4), P(5), P(6),
      static_cast<const bool*>(valid), static_cast<const int*>(owner),
      P(7), P(8), P(9), P(10), P(11), P(12), P(13), P(14), P(15), P(16),
      static_cast<T*>(pos_out), static_cast<T*>(vel_out), static_cast<T*>(rho_out),
      P(17), static_cast<T*>(travel_out), static_cast<unsigned long long*>(scratch),
      S, frozen_from, walls};
  if ((dim != 2 && dim != 3) || S <= 0 || a.pos == nullptr || a.valid == nullptr ||
      a.owner == nullptr)
    return cudaErrorInvalidValue;
  switch (mode) {
    case kProject:
      if (!a.dx || !a.sor || !a.proj_cap || !a.bmin || !a.bmax || !a.pos_out || !a.travel ||
          !a.travel_out || !a.scratch)
        return cudaErrorInvalidValue;
      return dispatch_pbf<T, kProject>(a, dim, st);
    case kVelocity:
      if (!a.pos0 || !a.rho || !a.mass || !a.dt || !a.max_speed || !a.rho0 || !a.vel_out ||
          !a.rho_out)
        return cudaErrorInvalidValue;
      return dispatch_pbf<T, kVelocity>(a, dim, st);
    case kMix:
      if (!a.vel || !a.dv || !a.coef || !a.max_speed || !a.vel_out ||
          (a.rho != nullptr) != (a.rho_out != nullptr) || (a.rho_out && !a.floor))
        return cudaErrorInvalidValue;
      return dispatch_pbf<T, kMix>(a, dim, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// mode 0: the WCSPH update (pos, vel out); 1: PBF's prediction (pos_out is
// x*; acc, xsph and vel_out unused). obs: null (no obstacle term), or the 15
// tensors of an Obstacles in its field order and then sim_time, with ms
// spheres and mb boxes. scratch: two zeroed 64-bit words. walls: bit k set
// where spatial axis k has walls.
extern "C" int sph_integrate_f32(int mode, const void* pos, const void* vel, const void* acc,
                                 const void* xsph, const void* const* obs, int ms, int mb,
                                 const void* valid, const void* owner, const void* dt,
                                 const void* xsph_eps, const void* max_speed, const void* h,
                                 const void* stiffness, const void* damping,
                                 const void* gravity, const void* bmin, const void* bmax,
                                 void* pos_out, void* vel_out, const void* travel,
                                 void* travel_out, void* scratch, long long S, int dim,
                                 int walls, long long frozen_from, void* stream) {
  return launch<float>(mode, pos, vel, acc, xsph, obs, ms, mb, valid, owner, dt, xsph_eps,
                       max_speed, h, stiffness, damping, gravity, bmin, bmax, pos_out, vel_out,
                       travel, travel_out, scratch, S, dim, walls, frozen_from, stream);
}

extern "C" int sph_integrate_f64(int mode, const void* pos, const void* vel, const void* acc,
                                 const void* xsph, const void* const* obs, int ms, int mb,
                                 const void* valid, const void* owner, const void* dt,
                                 const void* xsph_eps, const void* max_speed, const void* h,
                                 const void* stiffness, const void* damping,
                                 const void* gravity, const void* bmin, const void* bmax,
                                 void* pos_out, void* vel_out, const void* travel,
                                 void* travel_out, void* scratch, long long S, int dim,
                                 int walls, long long frozen_from, void* stream) {
  return launch<double>(mode, pos, vel, acc, xsph, obs, ms, mb, valid, owner, dt, xsph_eps,
                        max_speed, h, stiffness, damping, gravity, bmin, bmax, pos_out, vel_out,
                        travel, travel_out, scratch, S, dim, walls, frozen_from, stream);
}

// PBF's passes, mode 2 PROJECT, 3 VELOCITY, 4 MIX. in: the 18 inputs of
// PbfArgs in its order, pos to period, then coef, floor and travel (null
// where the mode reads none, and rho and floor in MIX without a density
// out); valid, owner and the outputs as there.
extern "C" int sph_integrate_pbf_f32(int mode, const void* const* in, const void* valid,
                                     const void* owner, void* pos_out, void* vel_out,
                                     void* rho_out, void* travel_out, void* scratch, long long S,
                                     int dim, int walls, long long frozen_from, void* stream) {
  return launch_pbf<float>(mode, in, valid, owner, pos_out, vel_out, rho_out, travel_out,
                           scratch, S, dim, walls, frozen_from, stream);
}

extern "C" int sph_integrate_pbf_f64(int mode, const void* const* in, const void* valid,
                                     const void* owner, void* pos_out, void* vel_out,
                                     void* rho_out, void* travel_out, void* scratch, long long S,
                                     int dim, int walls, long long frozen_from, void* stream) {
  return launch_pbf<double>(mode, in, valid, owner, pos_out, vel_out, rho_out, travel_out,
                            scratch, S, dim, walls, frozen_from, stream);
}
