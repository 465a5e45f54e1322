// The per-slot update of the binned solvers' step loop, in one pass.
//
// Replaces no TPU kernel: the JAX package leaves these elementwise passes
// to XLA, which fuses them. The port ran them as eager torch operations,
// each a pass over all S slots (about 40 a WCSPH step: the body forces, the
// move mask, Euler, the speed clamp, XSPH, the max reduction of travel),
// 1.8 ms of a 5.8 ms step of the 1M dam break (PERF.md). This kernel makes
// them one pass, in two instantiations chosen by the call site
// (solvers/integrate.py):
//
//   UPDATE (wcsph_binned.step, after forces), on the slots that move:
//     a  = ((acc + g) + wall(x, v)) [+ extra]
//     v' = clamp(v + dt a),  va = v' + xsph_eps xsph,  x' = x + dt va
//   other slots keep x and get v' = 0; travel' = travel + dt sqrt(max |va|^2).
//   PREDICT (pbf.step): a = ((0 + g) + wall(x, v)) [+ extra],
//     x* = x + dt clamp(v + dt a) on the slots that move, x elsewhere;
//   travel' = travel + sqrt(max |x* - x|^2).
//
// wall(x, v) = k (lo - hi) - (c min(max_k(lo_k + hi_k) / (0.1 h), 1)) v with
// lo = max(bmin - x, 0), hi = max(x - bmax, 0), zeroed on the axes without
// walls (periodic ones); clamp(v) = v max_speed rsqrt(|v|^2) where |v| passes
// max_speed. A slot moves when it is valid and its owner is below
// frozen_from (frozen boundary particles; -1: none is frozen).
//
// Arithmetic: the torch composition's (integrate.py update_plain,
// predict_plain), operation by operation and in its order: each product
// and sum rounded on its own (__fmul_rn / __fadd_rn: torch runs them as
// separate kernels, so nothing may be contracted into an FMA), rsqrt and
// sqrt as torch's CUDA kernels call them, clamps that pass NaN through,
// and the sum of squares in the order of torch's reduction over a row of
// 2 or 3: x^2 + y^2, and (x^2 + z^2) + y^2 (two lanes, the first holding
// elements 0 and 2).
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
// slots of the 1M dam break in float32, 0.28 GB (0.084 ms) for PREDICT.
// The design: a grid-stride loop, one slot a thread per pass, as many
// blocks as fill the card, scalar loads (a warp's 32 slots are contiguous,
// so its loads of one field cover whole lines), the gathers of the moving
// slots' inputs skipped for the 90% of slots that are empty.
#include "common.cuh"

namespace {

constexpr int kUpdate = 0;
constexpr int kPredict = 1;

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

// The sum of squares of a row, in the order of torch's CUDA sum over it.
template <typename T, int DIM> __device__ __forceinline__ T sumsq(const T (&v)[DIM]) {
  if (DIM == 2) return add(mul(v[0], v[0]), mul(v[1], v[1]));
  return add(add(mul(v[0], v[0]), mul(v[2], v[2])), mul(v[1], v[1]));
}

template <typename T>
struct Args {
  const T* pos;
  const T* vel;
  const T* acc;    // UPDATE: the pair acceleration; PREDICT: unused
  const T* xsph;   // UPDATE: the XSPH sum; PREDICT: unused
  const T* extra;  // an acceleration added last, or null
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
};

template <typename T, int DIM, int MODE>
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
#pragma unroll
    for (int e = 0; e < DIM; ++e) {
      const T pair = MODE == kUpdate ? a.acc[i * DIM + e] : T(0);
      T acc = add(add(pair, g[e]), sub(mul(k, sub(lo[e], hi[e])), mul(damp, v[e])));
      if (a.extra != nullptr) acc = add(acc, a.extra[i * DIM + e]);
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

  // The block's largest, then the grid's: the last block writes travel'.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) best = umax(best, __shfl_xor_sync(0xffffffffu, best, off));
  __shared__ unsigned long long warp_best[sph::kThreads / 32];
  if (threadIdx.x % 32 == 0) warp_best[threadIdx.x / 32] = best;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < sph::kThreads / 32; ++w) best = umax(best, warp_best[w]);
  atomicMax(&a.scratch[0], best);
  __threadfence();
  if (atomicAdd(&a.scratch[1], 1ull) != gridDim.x - 1) return;
  const T m = from_bits<T>(atomicMax(&a.scratch[0], 0ull));  // every block's, read at L2
  const T norm = root(clamp_lo(m, T(0)));
  a.travel_out[0] = add(a.travel[0], MODE == kUpdate ? mul(dt, norm) : norm);
}

template <typename T, int DIM, int MODE>
cudaError_t run(const Args<T>& a, cudaStream_t st) {
  const auto kernel = integrate_slots<T, DIM, MODE>;
  static int per_sm = [kernel] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, sph::kThreads, 0);
    return n > 0 ? n : 1;
  }();
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const unsigned fill = static_cast<unsigned>(sms * per_sm);
  const unsigned need = sph::blocks_for(a.S);
  kernel<<<need < fill ? need : fill, sph::kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch(int mode, const void* pos, const void* vel, const void* acc, const void* xsph,
           const void* extra, const void* valid, const void* owner, const void* dt,
           const void* xsph_eps, const void* max_speed, const void* h, const void* stiffness,
           const void* damping, const void* gravity, const void* bmin, const void* bmax,
           void* pos_out, void* vel_out, const void* travel, void* travel_out, void* scratch,
           long long S, int dim, int walls, long long frozen_from, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if ((dim != 2 && dim != 3) || S <= 0) return cudaErrorInvalidValue;
  if (mode == kUpdate && (acc == nullptr || xsph == nullptr || vel_out == nullptr))
    return cudaErrorInvalidValue;
  if (mode != kUpdate && mode != kPredict) return cudaErrorInvalidValue;
  const auto P = [](const void* p) { return static_cast<const T*>(p); };
  const Args<T> a{
      P(pos), P(vel), P(acc), P(xsph), P(extra),
      static_cast<const bool*>(valid), static_cast<const int*>(owner),
      P(dt), P(xsph_eps), P(max_speed), P(h), P(stiffness), P(damping),
      P(gravity), P(bmin), P(bmax),
      static_cast<T*>(pos_out), static_cast<T*>(vel_out), P(travel), static_cast<T*>(travel_out),
      static_cast<unsigned long long*>(scratch), S, frozen_from, walls,
      walls != (1 << dim) - 1};
  if (dim == 2)
    return mode == kUpdate ? run<T, 2, kUpdate>(a, st) : run<T, 2, kPredict>(a, st);
  return mode == kUpdate ? run<T, 3, kUpdate>(a, st) : run<T, 3, kPredict>(a, st);
}

}  // namespace

// mode 0: the WCSPH update (pos, vel out); 1: PBF's prediction (pos_out is
// x*; acc, xsph and vel_out unused). extra may be null. scratch: two
// zeroed 64-bit words. walls: bit k set where spatial axis k has walls.
extern "C" int sph_integrate_f32(int mode, const void* pos, const void* vel, const void* acc,
                                 const void* xsph, const void* extra, const void* valid,
                                 const void* owner, const void* dt, const void* xsph_eps,
                                 const void* max_speed, const void* h, const void* stiffness,
                                 const void* damping, const void* gravity, const void* bmin,
                                 const void* bmax, void* pos_out, void* vel_out,
                                 const void* travel, void* travel_out, void* scratch,
                                 long long S, int dim, int walls, long long frozen_from,
                                 void* stream) {
  return launch<float>(mode, pos, vel, acc, xsph, extra, valid, owner, dt, xsph_eps, max_speed,
                       h, stiffness, damping, gravity, bmin, bmax, pos_out, vel_out, travel,
                       travel_out, scratch, S, dim, walls, frozen_from, stream);
}

extern "C" int sph_integrate_f64(int mode, const void* pos, const void* vel, const void* acc,
                                 const void* xsph, const void* extra, const void* valid,
                                 const void* owner, const void* dt, const void* xsph_eps,
                                 const void* max_speed, const void* h, const void* stiffness,
                                 const void* damping, const void* gravity, const void* bmin,
                                 const void* bmax, void* pos_out, void* vel_out,
                                 const void* travel, void* travel_out, void* scratch,
                                 long long S, int dim, int walls, long long frozen_from,
                                 void* stream) {
  return launch<double>(mode, pos, vel, acc, xsph, extra, valid, owner, dt, xsph_eps, max_speed,
                        h, stiffness, damping, gravity, bmin, bmax, pos_out, vel_out, travel,
                        travel_out, scratch, S, dim, walls, frozen_from, stream);
}
