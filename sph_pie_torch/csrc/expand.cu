// Rebin placement: K cell-sorted rows -> num_cells*cap dense slots.
//
// Replaces the JAX package's neighbors/pallas_rebin.py expand (_kernel).
// Slot (cell c, rank r) takes row first[c] + r (ncol values) and its owner
// when r < min(count[c], cap) and the row exists (first[c] + r < K),
// otherwise zeros and owner -1. These are the scatter path's exact
// semantics: a cell with more than cap rows keeps its first cap, however
// many cells overflow (the Pallas kernel's per-block SLACK window has no
// counterpart here).
//
// What bounds it on the H100: DRAM bytes. It writes every slot once
// (ncol*4 + 4 bytes in f32: 32 bytes at ncol 7, 343 MB for the 10.7M slots
// of the 1M dam break) and reads each kept row once (32 MB there): a fill
// with a sparse copy inside it, which should run near the copy rate. The
// first design (one thread per slot, a 64-bit division per thread, ncol
// 4-byte stores per thread whose lanes lie ncol*4 bytes apart) ran at a
// quarter of that rate.
//
// This design (expand_runs) deals the work by runs of R consecutive cells
// (sph::expand_run_cells: at most kExpandSlots slots), one CTA per run. A
// run's dense rows are one contiguous span of the output and its owners
// another, both starting and ending on 16-byte boundaries when cap % 4 == 0
// and the outputs start on one, so both are written with 16-byte stores
// only, indexed from the run's start in 32-bit arithmetic: the one 64-bit
// product per thread is the run's offset. Each warp reads the run's R
// (first, count) pairs itself. A run that keeps no row (80% of them at 1M)
// writes its zeros and -1 straight away and exits before any barrier, and
// reads no row. Otherwise the run's kept rows are consecutive in the sorted
// input but for the dropped rows of an overfull cell: a warp per cell copies
// the cell's kept rows, a contiguous range that starts on a 4- or 8-byte
// boundary only, with coalesced element loads into the cell's place in a
// shared-memory image of the output span, and zeros behind them; owners
// likewise; then the image goes out with 16-byte stores.
//
// expand_slots is the arm for what that one cannot take (a cap that is not a
// multiple of 4, an output that does not start on a 16-byte boundary, a cell
// whose span passes the shared memory set aside): one thread per slot of a
// run of cells, 32-bit arithmetic within the run, element stores.
#include "common.cuh"

namespace {

// Rows that cell (first, count) keeps: at most cap, and none past row K.
__device__ __forceinline__ int kept_rows(int first, int count, int cap, long long K) {
  long long n = count < cap ? count : cap;
  if (K - first < n) n = K - first;
  return n > 0 ? static_cast<int>(n) : 0;
}

__device__ __forceinline__ void fill16(uint4* dst, int n, uint4 v) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = v;
}

template <typename T>
__global__ void __launch_bounds__(sph::kExpandThreads)
expand_runs(const int* __restrict__ first, const int* __restrict__ count,
            const T* __restrict__ rows, const int* __restrict__ owner,
            T* __restrict__ out, int* __restrict__ out_owner, long long num_cells, int cap,
            int ncol, long long K, int R) {
  constexpr int kPer = 16 / sizeof(T);
  const long long c0 = static_cast<long long>(blockIdx.x) * R;
  const int nc = static_cast<int>(num_cells - c0 < R ? num_cells - c0 : R);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int width = cap * ncol;  // values of one cell
  extern __shared__ __align__(16) unsigned char smem_raw[];
  sph::Carve carve(smem_raw);
  T* srow = carve.take<T>(static_cast<long long>(R) * width);
  int* sown = carve.take<int>(static_cast<long long>(R) * cap);
  int* sfirst = carve.take<int>(R);
  int* skeep = carve.take<int>(R);

  // Every warp reads the run's cells itself, so all agree without a barrier.
  bool any = false;
  for (int i = lane; i < nc; i += 32) {
    const int f = first[c0 + i];
    const int n = kept_rows(f, count[c0 + i], cap, K);
    any = any || n > 0;
    if (warp == 0) {
      sfirst[i] = f;
      skeep[i] = n;
    }
  }
  any = __any_sync(~0u, any);
  uint4* out16 = reinterpret_cast<uint4*>(out + c0 * width);
  uint4* own16 = reinterpret_cast<uint4*>(out_owner + c0 * cap);
  const int nrow16 = nc * width / kPer, nown16 = nc * cap / 4;
  if (!any) {  // the run keeps no row: zeros and -1
    fill16(out16, nrow16, make_uint4(0u, 0u, 0u, 0u));
    fill16(own16, nown16, make_uint4(~0u, ~0u, ~0u, ~0u));
    return;
  }
  __syncthreads();
  for (int i = warp; i < nc; i += nw) {
    const int f = sfirst[i], n = skeep[i];
    const T* __restrict__ src = rows + static_cast<long long>(f) * ncol;
    T* dst = srow + i * width;
    for (int t = lane; t < width; t += 32) dst[t] = t < n * ncol ? src[t] : T(0);
    for (int t = lane; t < cap; t += 32) sown[i * cap + t] = t < n ? owner[f + t] : -1;
  }
  __syncthreads();
  const uint4* srow16 = reinterpret_cast<const uint4*>(srow);
  const uint4* sown16 = reinterpret_cast<const uint4*>(sown);
  for (int i = threadIdx.x; i < nrow16; i += blockDim.x) out16[i] = srow16[i];
  for (int i = threadIdx.x; i < nown16; i += blockDim.x) own16[i] = sown16[i];
}

template <typename T>
__global__ void __launch_bounds__(sph::kThreads)
expand_slots(const int* __restrict__ first, const int* __restrict__ count,
             const T* __restrict__ rows, const int* __restrict__ owner,
             T* __restrict__ out, int* __restrict__ out_owner, long long num_cells, int cap,
             int ncol, long long K, int R) {
  const long long c0 = static_cast<long long>(blockIdx.x) * R;
  const int nc = static_cast<int>(num_cells - c0 < R ? num_cells - c0 : R);
  for (int i = threadIdx.x; i < nc * cap; i += blockDim.x) {
    const int ci = i / cap, r = i - ci * cap;
    const int f = first[c0 + ci];
    const bool keep = r < kept_rows(f, count[c0 + ci], cap, K);
    const long long slot = (c0 + ci) * cap + r;
    const T* __restrict__ src = rows + (static_cast<long long>(f) + r) * ncol;
    T* dst = out + slot * ncol;
    for (int k = 0; k < ncol; ++k) dst[k] = keep ? src[k] : T(0);
    out_owner[slot] = keep ? owner[f + r] : -1;
  }
}

template <typename T>
int launch(const void* first, const void* count, const void* rows, const void* owner,
           void* out, void* out_owner, long long num_cells, int cap, int ncol,
           long long K, void* stream) {
  if (num_cells * cap == 0) return cudaGetLastError();
  if (cap < 0 || ncol < 1) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto f = static_cast<const int*>(first), c = static_cast<const int*>(count);
  const auto r = static_cast<const T*>(rows);
  const auto o = static_cast<const int*>(owner);
  const auto d = static_cast<T*>(out);
  const auto od = static_cast<int*>(out_owner);
  const int R = sph::expand_run_cells(out, out_owner, cap, ncol, sizeof(T));
  if (R > 0) {
    sph::Carve carve(nullptr);  // counts the bytes of the layout
    carve.take<T>(static_cast<long long>(R) * cap * ncol);
    carve.take<int>(static_cast<long long>(R) * cap);
    carve.take<int>(R);
    carve.take<int>(R);
    const long long runs = (num_cells + R - 1) / R;
    expand_runs<T><<<static_cast<unsigned>(runs), sph::kExpandThreads, carve.off, st>>>(
        f, c, r, o, d, od, num_cells, cap, ncol, K, R);
  } else {
    const int Rs = sph::kThreads / cap > 0 ? sph::kThreads / cap : 1;
    const long long runs = (num_cells + Rs - 1) / Rs;
    expand_slots<T><<<static_cast<unsigned>(runs), sph::kThreads, 0, st>>>(
        f, c, r, o, d, od, num_cells, cap, ncol, K, Rs);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int sph_expand_f32(const void* first, const void* count, const void* rows,
                              const void* owner, void* out, void* out_owner,
                              long long num_cells, int cap, int ncol, long long K,
                              void* stream) {
  return launch<float>(first, count, rows, owner, out, out_owner, num_cells, cap, ncol, K, stream);
}

extern "C" int sph_expand_f64(const void* first, const void* count, const void* rows,
                              const void* owner, void* out, void* out_owner,
                              long long num_cells, int cap, int ncol, long long K,
                              void* stream) {
  return launch<double>(first, count, rows, owner, out, out_owner, num_cells, cap, ncol, K, stream);
}

// Cells per run of the 16-byte arm for these outputs, 0 where the launcher
// takes the per-slot arm: the launcher's own rule, for callers that report it.
extern "C" int sph_expand_run_cells(const void* out, const void* out_owner, int cap, int ncol,
                                    int itemsize) {
  return sph::expand_run_cells(out, out_owner, cap, ncol, itemsize);
}
