// Shared helpers of the binned-slot kernels.
//
// Layout (sph_pie_torch/neighbors/binned.py): slot i belongs to cell
// c = i / cap of a padded grid raveled row-major; the neighbour cells of c
// are, for each of the 3^(DIM-1) leading-axis offsets ("slabs"), the three
// contiguous cells c + shift - 1 .. c + shift + 1, i.e. 3*cap contiguous
// slots. Slots outside [0, S) count as empty.
//
// The staged pair kernels (density.cu, forces.cu) work on runs of R
// consecutive cells: for each slab the run's window is the (R+2)*cap
// contiguous slots c0 + shift - 1 .. c0 + shift + R, so each field of a
// slab window is one linear span, copied into shared memory by the bulk
// copy engine (cp.async.bulk, completion on an mbarrier) and then packed
// by warp ballot into the records of its occupied slots, in slot order,
// with the start of each window cell's records.
#pragma once

#include <cstdint>
#include <cstring>

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

// The flat cell shift of slab s, in the same order, without an array.
template <int DIM>
__device__ __forceinline__ long long slab_shift(int s, long long s0, long long s1) {
  if (DIM == 2) return (s - 1) * s0;
  return (s / 3 - 1) * s0 + (s % 3 - 1) * s1;
}

inline unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// ---- runs of cells staged in shared memory --------------------------------

// Launch shape: runs of kRunCells cells (fewer where their home slots would
// pass kHomeSlots), kRunThreads threads per CTA -- the fastest shape of both
// kernels measured on the 1M dam break (PERF.md). The cap is a multiple of
// 4 (16-byte spans) and at most kHomeSlots; every layout that admits fits
// in the 227 KB of shared memory of one CTA, the largest being float64 3D
// forces at cap 384 (one-cell runs, ~203 KB).
constexpr int kRunCells = 5;
constexpr int kRunThreads = 128;
constexpr int kHomeSlots = 384;
constexpr int kMaxChunks = 64;  // 32-slot chunks a window may have
static_assert(3 * kHomeSlots <= 32 * kMaxChunks, "a window passes the chunk scan");

inline int run_cells(int cap) {
  return kHomeSlots / cap < kRunCells ? kHomeSlots / cap : kRunCells;
}

// True when the staged kernels take this cap.
inline bool run_cap_ok(int cap) { return cap > 0 && cap % 4 == 0 && cap <= kHomeSlots; }

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Rebin placement (expand.cu): one CTA of kExpandThreads threads takes a run
// of cells holding at most kExpandSlots slots, fewer where the run's output
// span (rows and owners, assembled in shared memory) would pass kExpandBytes.
constexpr int kExpandThreads = 128;
constexpr int kExpandSlots = 640;
constexpr int kExpandBytes = 49152;  // the 48 KB a launch gets unasked

// Cells per run of the placement's 16-byte arm, 0 where it cannot take the
// layout: the cap is not a multiple of 4 (a cell's rows and its int32
// owners then do not both end on 16-byte boundaries), an output does not
// start on one, or one cell's span does not fit in kExpandBytes.
inline int expand_run_cells(const void* out, const void* out_owner, int cap, int ncol,
                            int itemsize) {
  if (cap <= 0 || cap % 4 || ncol <= 0 || !aligned16(out) || !aligned16(out_owner)) return 0;
  // rows, owners, first and kept rows of a cell; 64 bytes of alignment slack
  const long long per_cell = static_cast<long long>(cap) * (ncol * itemsize + 4) + 8;
  const long long fit = (kExpandBytes - 64) / per_cell;
  const long long want = kExpandSlots / cap > 0 ? kExpandSlots / cap : 1;
  return static_cast<int>(fit < want ? fit : want);
}

// Four values of one packed slot: coordinates (the unused z of 2D is 0)
// and one more per-slot value; one 16-byte shared-memory load in f32, two
// in f64.
template <typename T>
struct alignas(16) Rec {
  T v[4];
};

// Carves 16-byte aligned arrays out of dynamic shared memory. On the host,
// over a null base, it only counts the bytes (``off`` after the takes).
struct Carve {
  unsigned char* base;
  size_t off = 0;
  __host__ __device__ explicit Carve(void* b) : base(static_cast<unsigned char*>(b)) {}
  template <typename U>
  __host__ __device__ U* take(long long n) {
    off = (off + 15) & ~static_cast<size_t>(15);
    U* p = reinterpret_cast<U*>(base + off);
    off += static_cast<size_t>(n) * sizeof(U);
    return p;
  }
};

// The run's window of slab s: local slots [lo, hi) of its W lie in [0, S).
struct Span {
  long long j0;  // global slot of local slot 0
  int lo, hi;
};

__device__ __forceinline__ Span window(long long c0, long long shift, int cap, int W,
                                       long long S) {
  Span w;
  w.j0 = (c0 + shift - 1) * cap;
  w.lo = static_cast<int>(w.j0 < 0 ? -w.j0 : 0);
  w.hi = static_cast<int>(S - w.j0 < W ? S - w.j0 : W);
  if (w.hi < w.lo) w.hi = w.lo;
  return w;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival of a phase, expecting ``bytes`` from bulk copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits for the phase of ``bar`` with this parity to complete. A copy that
// never lands is a fault: after ~10 s of clock the kernel traps (the launch
// then fails with an error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// Orders this thread's earlier generic-proxy shared-memory accesses (after a
// barrier: the whole block's) before later bulk copies into the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Bulk copy of ``bytes`` (a multiple of 16, both addresses 16-byte aligned)
// from global to shared memory, completing on ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Copies slots [lo, hi) of ``n_fields`` arrays of ``width`` values per slot
// (global slot j0 + lo ...) to the same local slots of their stages, and
// arms ``bar`` with the bytes. One thread calls it.
template <typename T, int N>
__device__ __forceinline__ void stage_span(const Span& w, const T* const (&src)[N],
                                           T* const (&dst)[N], const int (&width)[N],
                                           uint64_t* bar) {
  const unsigned n = static_cast<unsigned>(w.hi - w.lo);
  unsigned bytes = 0;
#pragma unroll
  for (int f = 0; f < N; ++f) bytes += n * width[f] * sizeof(T);
  mbar_expect(bar, bytes);
  if (n == 0) return;
#pragma unroll
  for (int f = 0; f < N; ++f)
    bulk_load(dst[f] + static_cast<long long>(w.lo) * width[f],
              src[f] + (w.j0 + w.lo) * width[f], n * width[f] * sizeof(T), bar);
}

// True when all n values are 0 (m 16-byte aligned, n * sizeof(T) a multiple
// of 16). Each warp reads them itself, with independent 16-byte loads, so
// every warp of the block gets the same answer without a barrier.
template <typename T>
__device__ __forceinline__ bool warp_all_zero(const T* __restrict__ m, int n) {
  constexpr int kPer = 16 / sizeof(T);
  const uint4* __restrict__ v = reinterpret_cast<const uint4*>(m);
  bool any = false;
#pragma unroll 4
  for (int i = threadIdx.x & 31; i < n / kPer; i += 32) {
    const uint4 u = __ldg(v + i);
    T x[kPer];
    memcpy(x, &u, sizeof(u));
#pragma unroll
    for (int e = 0; e < kPer; ++e) any = any || x[e] != T(0);
  }
  return !__any_sync(~0u, any);
}

// Exclusive prefix of the popcounts of up to 64 masks, computed by a whole
// warp (every lane must call): lane l holds the offsets of masks l and l+32.
struct ChunkScan {
  int lo, hi, total;
  // Records before chunk k (k warp-uniform or not; every lane must call).
  __device__ __forceinline__ int offset(int k) const {
    const int a = __shfl_sync(~0u, lo, k & 31);
    const int b = __shfl_sync(~0u, hi, k & 31);
    return k < 32 ? a : b;
  }
  // Records before slot p, 0 <= p <= 32 * n (every lane must call).
  __device__ __forceinline__ int before(const unsigned* masks, int n, int p) const {
    const int k = p >> 5;
    const int o = offset(k < n ? k : n - 1);
    if (k >= n) return total;
    return o + __popc(masks[k] & ((1u << (p & 31)) - 1u));
  }
};

__device__ __forceinline__ ChunkScan scan_chunks(const unsigned* masks, int n) {
  const int lane = threadIdx.x & 31;
  const int a = lane < n ? __popc(masks[lane]) : 0;
  const int b = lane + 32 < n ? __popc(masks[lane + 32]) : 0;
  int sa = a, sb = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ta = __shfl_up_sync(~0u, sa, o);
    const int tb = __shfl_up_sync(~0u, sb, o);
    if (lane >= o) {
      sa += ta;
      sb += tb;
    }
  }
  const int ta = __shfl_sync(~0u, sa, 31);
  const int tb = __shfl_sync(~0u, sb, 31);
  return {sa - a, ta + sb - b, ta + tb};
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Ballot masks of the occupied slots (mass != 0, local slot in [lo, hi)) of
// an n-slot stage, one mask per 32 slots, warp-strided over the chunks.
template <typename T>
__device__ __forceinline__ void occupancy(const T* mass, int n, int lo, int hi,
                                          unsigned* masks) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int k = warp; k < (n + 31) / 32; k += nw) {
    const int j = k * 32 + lane;
    const unsigned bits = __ballot_sync(~0u, j >= lo && j < hi && mass[j] != T(0));
    if (lane == 0) masks[k] = bits;
  }
}

// Calls pack(slot, record) for each occupied slot of ``masks``: records in
// slot order, warp-strided over the chunks (every lane must call).
template <typename F>
__device__ __forceinline__ void pack_occupied(const unsigned* masks, int nch,
                                              const ChunkScan& sc, F&& pack) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int k = warp; k < nch; k += nw) {
    const unsigned bits = masks[k];
    const int off = sc.offset(k);
    if ((bits >> lane) & 1u) pack(k * 32 + lane, off + __popc(bits & lanes_below()));
  }
}

// start[w] = records before window cell w, for w = 0 .. ncell (warp-wide).
__device__ __forceinline__ void cell_starts(const ChunkScan& sc, const unsigned* masks,
                                            int nch, int ncell, int cap, int* start) {
  const int lane = threadIdx.x & 31;
  for (int w0 = 0; w0 <= ncell; w0 += 32) {
    const int w = w0 + lane;
    const int v = sc.before(masks, nch, (w < ncell ? w : ncell) * cap);
    if (w <= ncell) start[w] = v;
  }
}

// Shared-memory limit of a launch, raised above the 48 KB default (float64
// 3D forces at cap 40 takes ~62 KB).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > 232448) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace sph
