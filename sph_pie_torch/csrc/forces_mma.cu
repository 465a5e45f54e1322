// Pressure, viscosity and XSPH sums in moment form, contracted on the
// tensor cores (mma.sync): the matrix-unit forces kernel.
//
// Replaces the JAX package's scripts/micro_mxu_vmem.py forces_mxu
// (_build_forces_mxu): the forces of neighbors/pallas_pair.py
// forces_pallas without cohesion, cap 32 only, h = cell_size - skin. Per
// home cell and slab, with the window's 3*cap = 96 slots j:
//
//   weight planes (computed per pair in registers, r^2 = |x_i - x_j|^2):
//     press_ij = m_j (pr2_i + pr2_j) C_s q^2 / r   (0 where r^2 == 0)
//     visc_ij  = m_rho_j C_v q                      q  = max(h - r, 0)
//     xw_ij    = m_rho_j (C_6 qp) qp qp             qp = max(h^2 - r^2, 0)
//   window features F_j = [x_j - c, v_j - cv, 1, 0 pad] (8 columns), c and
//     cv the mass-weighted means of this window's pos and vel;
//   moments mom[t][i][:] = sum_j plane_t[i][j] F_j, an M x K x N product
//     with M = 3 planes x 32 homes = 96, K = 96, N = 8;
//   P_i += (x_i - c) mom_press[ones] - mom_press[pos]
//   V_i += mom_visc[vel] - (v_i - cv) mom_visc[ones]   (X_i likewise)
//
// and at the end acc_i = -P_i + mu / rho_i V_i, xsph_i = X_i. Home slots
// with mass 0 write 0 (their plane rows are zeroed before the product);
// the JAX function leaves garbage there.
//
// The f32 arm runs m16n8k8 TF32 products with the 3xTF32 split (a = a_hi +
// a_lo, D += a_lo b_hi + a_hi b_lo + a_hi b_hi), the counterpart of the TPU
// kernel's Precision.HIGHEST: plain TF32 keeps a 10-bit mantissa. The bf16
// arm rounds planes and features to bf16 and runs m16n8k16 with f32
// accumulation. The centering (the TPU kernel's fix for f32 cancellation
// in the moment form) is per home cell and slab over the 96-slot window;
// the TPU kernel centers over its 128-lane row of 4 cells, which changes
// the bf16 rounding only.
//
// Layout: one warp per home cell (lane = home rank), 4 warps per CTA, no
// cross-warp sharing. Per slab a warp stages the window's 9 fields in
// shared memory, reduces the centers with shuffles, writes the features,
// then walks 2 m-tiles of 16 homes x the K steps: each thread computes the
// pair weights for exactly its A-fragment positions, so every pair is
// computed once and never stored. The moments go through shared memory to
// the lane of their home for the centering epilogue. What bounds it: the
// pair math (about 40 flops per pair, on the CUDA cores) and the
// shared-memory window reads, not the tensor cores (216 TF32 mma per
// cell-slab in the f32 arm).
#include <cstdint>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kCap = 32;          // home slots per cell
constexpr int kWin = 3 * kCap;    // window slots per slab
constexpr int kNF = 8;            // feature columns (2*DIM + 1 used)
constexpr int kWarps = 4;         // home cells per CTA
constexpr float kTiny = 1e-12f;

template <int DIM>
struct WarpSmem {
  float win[2 * DIM + 3][kWin];   // pos, vel, mass, pr2, m_rho
  float feat[kWin][kNF];          // centered features, B operand
  float mom[3 * kCap][kNF];       // moments of the three planes
  float home[DIM + 2][kCap];      // home pos, pr2, live flag
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D += A B in 3xTF32: the a_lo b_lo term (2^-22 relative) is dropped.
__device__ __forceinline__ void mma_3xtf32(float* d, const float* a, const uint32_t* bh,
                                           const uint32_t* bl) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) split_tf32(a[r], ah[r], al[r]);
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

struct Consts {
  float h, h2, cs, cv, c6;
};

struct Home {
  float x[3];
  float pr2;
  bool live;
};

// The three plane weights of pair (home, window slot j).
template <int DIM>
__device__ __forceinline__ void planes(const WarpSmem<DIM>& w, const Home& hm, int j,
                                       const Consts& k, float& press, float& visc,
                                       float& xw) {
  // r^2 from separately rounded products and sums, as the plain version
  // builds it (no fused multiply-add), so the poly6 plane is bit-equal.
  float d = hm.x[0] - w.win[0][j];
  float r2 = __fmul_rn(d, d);
#pragma unroll
  for (int a = 1; a < DIM; ++a) {
    d = hm.x[a] - w.win[a][j];
    r2 = __fadd_rn(r2, __fmul_rn(d, d));
  }
  const float inv_r = rsqrtf(fmaxf(r2, kTiny));
  const float r = r2 * inv_r;
  const float qs = fmaxf(k.h - r, 0.f);
  const float gw = k.cs * qs * qs;
  const float mj = w.win[2 * DIM][j];
  const float mr = w.win[2 * DIM + 2][j];
  // Zero the self pair (and any coincident pair) before the product: the
  // moment form would otherwise telescope two 1/sqrt(tiny)-sized products.
  const float gwr = r2 > 0.f ? gw * inv_r : 0.f;
  const float qp = fmaxf(k.h2 - r2, 0.f);
  press = hm.live ? (mj * (hm.pr2 + w.win[2 * DIM + 1][j])) * gwr : 0.f;
  visc = hm.live ? mr * (k.cv * qs) : 0.f;
  xw = hm.live ? mr * ((k.c6 * qp) * qp * qp) : 0.f;
}

template <int DIM, bool BF16>
__global__ void __launch_bounds__(kWarps * 32)
forces_mma_kernel(const float* __restrict__ pos, const float* __restrict__ vel,
                  const float* __restrict__ mass, const float* __restrict__ pr2,
                  const float* __restrict__ m_rho, const float* __restrict__ inv_rho,
                  const float* __restrict__ prm, float* __restrict__ acc_out,
                  float* __restrict__ xsph_out, long long C, long long s0, long long s1) {
  __shared__ WarpSmem<DIM> smem_all[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long c = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (c >= C) return;  // warp-uniform; warps share nothing
  WarpSmem<DIM>& w = smem_all[warp];
  const long long S = C * kCap;
  const long long i = c * kCap + lane;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates

  const float mi = mass[i];
  const bool live = mi != 0.f;
  if (__ballot_sync(0xffffffffu, live) == 0u) {  // no particle in this cell
#pragma unroll
    for (int a = 0; a < DIM; ++a) acc_out[i * DIM + a] = xsph_out[i * DIM + a] = 0.f;
    return;
  }
  const Consts k{prm[0], prm[1], prm[2], prm[3], prm[4]};
  const float mu = prm[5];
  float xi[DIM], vi[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    xi[a] = pos[i * DIM + a];
    vi[a] = vel[i * DIM + a];
    w.home[a][lane] = xi[a];
  }
  w.home[DIM][lane] = pr2[i];
  w.home[DIM + 1][lane] = live ? 1.f : 0.f;
  __syncwarp();
  // The four homes of this thread's A-fragment rows: m-tile mt, rows g, g+8.
  Home hm[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = mt * 16 + hh * 8 + g;
#pragma unroll
      for (int a = 0; a < 3; ++a) hm[mt][hh].x[a] = a < DIM ? w.home[a][r] : 0.f;
      hm[mt][hh].pr2 = w.home[DIM][r];
      hm[mt][hh].live = w.home[DIM + 1][r] != 0.f;
    }

  float P[DIM], V[DIM], X[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) P[a] = V[a] = X[a] = 0.f;

  long long sh[9];
  const int ns = sph::slab_shifts<DIM>(s0, s1, sh);
  for (int s = 0; s < ns; ++s) {
    // ---- stage the window; partial sums for the mass-weighted centers.
    // Each lane sums its slots lane, lane+32, lane+64 in order, then an
    // xor butterfly over the 32 lanes, with rounded products (no fused
    // multiply-add): the plain version sums in this order too, so both
    // round bit-equal features to bf16 (a 1-ulp shift of the center moves
    // every small centered velocity and flips many bf16 roundings).
    const long long j0 = (c + sh[s] - 1) * kCap;
    float msum = 0.f, cx[DIM], cv[DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a) cx[a] = cv[a] = 0.f;
#pragma unroll
    for (int q = lane; q < kWin; q += 32) {
      const long long j = j0 + q;
      const bool in = j >= 0 && j < S;  // slots outside [0, S) are empty
      const float mj = in ? mass[j] : 0.f;
      w.win[2 * DIM][q] = mj;
      w.win[2 * DIM + 1][q] = in ? pr2[j] : 0.f;
      w.win[2 * DIM + 2][q] = in ? m_rho[j] : 0.f;
      msum = __fadd_rn(msum, mj);
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        const float x = in ? pos[j * DIM + a] : 0.f;
        const float v = in ? vel[j * DIM + a] : 0.f;
        w.win[a][q] = x;
        w.win[DIM + a][q] = v;
        cx[a] = __fadd_rn(cx[a], __fmul_rn(mj, x));
        cv[a] = __fadd_rn(cv[a], __fmul_rn(mj, v));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      msum += __shfl_xor_sync(0xffffffffu, msum, o);
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        cx[a] += __shfl_xor_sync(0xffffffffu, cx[a], o);
        cv[a] += __shfl_xor_sync(0xffffffffu, cv[a], o);
      }
    }
    const float wsum = fmaxf(msum, kTiny);
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      cx[a] = cx[a] / wsum;
      cv[a] = cv[a] / wsum;
    }
#pragma unroll
    for (int q = lane; q < kWin; q += 32) {
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        w.feat[q][a] = w.win[a][q] - cx[a];
        w.feat[q][DIM + a] = w.win[DIM + a][q] - cv[a];
      }
      w.feat[q][2 * DIM] = 1.f;
#pragma unroll
      for (int f = 2 * DIM + 1; f < kNF; ++f) w.feat[q][f] = 0.f;
    }
    __syncwarp();

    // ---- moments on the tensor cores: d[plane][m-tile] is 16 homes x 8
    float d[3][2][4];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) d[p][mt][r] = 0.f;

    if (BF16) {
      // m16n8k16: A regs (row g | g+8) x (cols 2t,2t+1 | 2t+8,2t+9)
      for (int kt = 0; kt < kWin / 16; ++kt) {
        const int jb = kt * 16 + 2 * t;
        const uint32_t b[2] = {pack_bf16(w.feat[jb][g], w.feat[jb + 1][g]),
                               pack_bf16(w.feat[jb + 8][g], w.feat[jb + 9][g])};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float pp[8], pv[8], px[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            // element e of the fragment: reg e/2, half e%2
            const int hh = (e >> 1) & 1;
            const int j = jb + (e & 1) + ((e >> 2) << 3);
            planes<DIM>(w, hm[mt][hh], j, k, pp[e], pv[e], px[e]);
          }
          uint32_t ap[4], av[4], ax[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            ap[r] = pack_bf16(pp[2 * r], pp[2 * r + 1]);
            av[r] = pack_bf16(pv[2 * r], pv[2 * r + 1]);
            ax[r] = pack_bf16(px[2 * r], px[2 * r + 1]);
          }
          mma_bf16(d[0][mt], ap, b);
          mma_bf16(d[1][mt], av, b);
          mma_bf16(d[2][mt], ax, b);
        }
      }
    } else {
      // m16n8k8: A regs (row g, col t), (g+8, t), (g, t+4), (g+8, t+4)
      for (int kt = 0; kt < kWin / 8; ++kt) {
        const int ja = kt * 8 + t;
        uint32_t bh[2], bl[2];
        split_tf32(w.feat[ja][g], bh[0], bl[0]);
        split_tf32(w.feat[ja + 4][g], bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float pp[4], pv[4], px[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            planes<DIM>(w, hm[mt][e & 1], ja + (e >> 1) * 4, k, pp[e], pv[e], px[e]);
          mma_3xtf32(d[0][mt], pp, bh, bl);
          mma_3xtf32(d[1][mt], pv, bh, bl);
          mma_3xtf32(d[2][mt], px, bh, bl);
        }
      }
    }

    // ---- moments to their home's lane, then the centering epilogue
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = p * kCap + mt * 16 + g;
        w.mom[r][2 * t] = d[p][mt][0];
        w.mom[r][2 * t + 1] = d[p][mt][1];
        w.mom[r + 8][2 * t] = d[p][mt][2];
        w.mom[r + 8][2 * t + 1] = d[p][mt][3];
      }
    __syncwarp();
    const float* mp = w.mom[lane];
    const float* mv = w.mom[kCap + lane];
    const float* mx = w.mom[2 * kCap + lane];
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      P[a] += (xi[a] - cx[a]) * mp[2 * DIM] - mp[a];
      V[a] += mv[DIM + a] - (vi[a] - cv[a]) * mv[2 * DIM];
      X[a] += mx[DIM + a] - (vi[a] - cv[a]) * mx[2 * DIM];
    }
    __syncwarp();  // the next slab overwrites win, feat and mom
  }

  const float mu_i = mu * inv_rho[i];
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    acc_out[i * DIM + a] = live ? -P[a] + mu_i * V[a] : 0.f;
    xsph_out[i * DIM + a] = live ? X[a] : 0.f;
  }
}

template <int DIM, bool BF16>
void go(const float* p, const float* v, const float* m, const float* q, const float* mr,
        const float* ir, const float* prm, float* a, float* x, long long C, long long s0,
        long long s1, cudaStream_t st) {
  const unsigned int blocks = static_cast<unsigned int>((C + kWarps - 1) / kWarps);
  forces_mma_kernel<DIM, BF16><<<blocks, kWarps * 32, 0, st>>>(p, v, m, q, mr, ir, prm, a, x,
                                                                C, s0, s1);
}

}  // namespace

extern "C" int sph_forces_mma_f32(const void* pos, const void* vel, const void* mass,
                                  const void* pr2, const void* m_rho, const void* inv_rho,
                                  const void* prm, void* acc, void* xsph, long long S,
                                  int dim, long long s0, long long s1, int bf16,
                                  void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  const auto a = static_cast<float*>(acc);
  const auto x = static_cast<float*>(xsph);
  if (S == 0) return cudaGetLastError();
  if (S % kCap != 0 || (dim != 2 && dim != 3)) return cudaErrorInvalidValue;
  const long long C = S / kCap;
  if (dim == 2) {
    if (bf16) go<2, true>(f(pos), f(vel), f(mass), f(pr2), f(m_rho), f(inv_rho), f(prm), a, x, C, s0, s1, st);
    else go<2, false>(f(pos), f(vel), f(mass), f(pr2), f(m_rho), f(inv_rho), f(prm), a, x, C, s0, s1, st);
  } else {
    if (bf16) go<3, true>(f(pos), f(vel), f(mass), f(pr2), f(m_rho), f(inv_rho), f(prm), a, x, C, s0, s1, st);
    else go<3, false>(f(pos), f(vel), f(mass), f(pr2), f(m_rho), f(inv_rho), f(prm), a, x, C, s0, s1, st);
  }
  return cudaGetLastError();
}
