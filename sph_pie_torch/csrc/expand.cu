// Rebin placement: K cell-sorted rows -> num_cells*cap dense slots.
//
// Replaces the JAX package's neighbors/pallas_rebin.py expand (_kernel). One
// thread per slot (cell c, rank r): if r < min(count[c], cap) it copies row
// first[c] + r (ncol values) and its owner, otherwise it writes zeros and
// owner -1. These are the scatter path's exact semantics: a cell with more
// than cap rows keeps its first cap, however many cells overflow (the
// Pallas kernel's per-block SLACK window has no counterpart here).
//
// What bounds it on the H100: DRAM bytes -- it writes every slot once
// (ncol*4 + 4 bytes in f32: 36 bytes at ncol 8, 386 MB for the 10.7M slots
// of the 1M dam break) and reads each kept row once, so it should run near
// the copy bandwidth. Neighbouring threads take neighbouring slots, so
// the reads of first/count broadcast within a cell and the row reads and
// slot writes of a warp are contiguous runs.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(sph::kThreads)
expand_kernel(const int* __restrict__ first, const int* __restrict__ count,
              const T* __restrict__ rows, const int* __restrict__ owner,
              T* __restrict__ out, int* __restrict__ out_owner,
              long long num_cells, int cap, int ncol, long long K) {
  const long long slot = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (slot >= num_cells * cap) return;
  const long long c = slot / cap;
  const int r = static_cast<int>(slot - c * cap);
  const long long src = static_cast<long long>(first[c]) + r;
  const bool keep = r < count[c] && src < K;
  for (int k = 0; k < ncol; ++k) out[slot * ncol + k] = keep ? rows[src * ncol + k] : T(0);
  out_owner[slot] = keep ? owner[src] : -1;
}

template <typename T>
int launch(const void* first, const void* count, const void* rows, const void* owner,
           void* out, void* out_owner, long long num_cells, int cap, int ncol,
           long long K, void* stream) {
  const long long n = num_cells * cap;
  if (n == 0) return cudaGetLastError();
  expand_kernel<T><<<sph::blocks_for(n), sph::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(first), static_cast<const int*>(count),
      static_cast<const T*>(rows), static_cast<const int*>(owner),
      static_cast<T*>(out), static_cast<int*>(out_owner), num_cells, cap, ncol, K);
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
