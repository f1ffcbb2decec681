// Banded (DIA) SpMV and multi-RHS SpMM for Hopper (sm_90a).
//
// Replaces the TPU kernels (tpukk/sparse/spmv_pallas.py):
//   K1 dia_spmv<T>  <- _dia_call    (:41, Pallas "tpukk_spmv_dia"), T = float
//                   <- _dia_ds_call (:330, "tpukk_spmv_dia_ds"), T = double:
//                      the TPU carried f64 as (hi, lo) f32 pairs; Hopper has
//                      native f64, so the same kernel in double replaces it.
//   K2 dia_spmm<T>  <- _dia_mv_call (:180, "tpukk_spmv_dia_mv")
//
// What it computes: y[i] = sum_j diags[j][i] * x[i + off_j], 0 <= i < nrows,
// a term whose column falls outside [0, ncols) being zero; K2 does the same
// for every column of a row-major X (ncols, k) into Y (nrows, k).
//
// Bound on the H100: bytes.  Each diagonal value is used once (2 flops per
// 4 or 8 bytes), far below the card's ~20 flops/byte balance point.  The
// least traffic is the diagonal planes, x and y once each.
//
// Design against that bound:
//  * one thread per row: reads of diags[j][i] and y[i] are unit-stride across
//    a warp and fully coalesced; x[i + off_j] is unit-stride too, and the
//    ndiags shifted reads of x by one block overlap, so after the first they
//    hit L1/L2 (the read-only path, __ldg) instead of device memory;
//  * the kernel does its own bounds checks on the column, so it needs neither
//    the TPU's padded x window nor its 1024-aligned chunks;
//  * offsets (at most 256) are staged once per block in shared memory;
//  * K2 gives each thread one row and a panel of up to 8 columns, held in
//    registers; the panels of one row sit side by side in a warp, so a
//    diagonal value is fetched from memory once for all k columns — the point
//    of _dia_mv_call, without its 64-column VMEM limit.
//
// C interface (bound with ctypes): every function returns the cudaError_t of
// its launch (0 when nothing needed launching); dtype 0 = float, 1 = double.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDiags = 256;
constexpr int kThreads = 256;
constexpr int kPanel = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const T* __restrict__ diags, const int* __restrict__ offsets, int ndiags,
                const T* __restrict__ x, T* __restrict__ y, int64_t nrows, int64_t ncols) {
  __shared__ int s_off[kMaxDiags];
  for (int j = threadIdx.x; j < ndiags; j += blockDim.x) s_off[j] = offsets[j];
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nrows) return;
  T acc = T(0);
  for (int j = 0; j < ndiags; ++j) {
    const int64_t c = i + s_off[j];
    if (c >= 0 && c < ncols) acc += diags[j * nrows + i] * __ldg(x + c);
  }
  y[i] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmm_kernel(const T* __restrict__ diags, const int* __restrict__ offsets, int ndiags,
                const T* __restrict__ X, T* __restrict__ Y, int64_t nrows, int64_t ncols,
                int k, int npanels) {
  __shared__ int s_off[kMaxDiags];
  for (int j = threadIdx.x; j < ndiags; j += blockDim.x) s_off[j] = offsets[j];
  __syncthreads();
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t i = t / npanels;
  if (i >= nrows) return;
  const int c0 = static_cast<int>(t - i * npanels) * kPanel;
  const int w = min(kPanel, k - c0);
  T acc[kPanel];
#pragma unroll
  for (int q = 0; q < kPanel; ++q) acc[q] = T(0);
  for (int j = 0; j < ndiags; ++j) {
    const int64_t c = i + s_off[j];
    if (c < 0 || c >= ncols) continue;
    const T d = diags[j * nrows + i];
    const T* xr = X + c * k + c0;
#pragma unroll
    for (int q = 0; q < kPanel; ++q)
      if (q < w) acc[q] += d * __ldg(xr + q);
  }
  T* yr = Y + i * k + c0;
#pragma unroll
  for (int q = 0; q < kPanel; ++q)
    if (q < w) yr[q] = acc[q];
}

template <typename T>
int launch_spmv(const void* diags, const int* offsets, int ndiags, const void* x, void* y,
                int64_t nrows, int64_t ncols, cudaStream_t stream) {
  if (nrows == 0) return 0;
  if (ndiags < 0 || ndiags > kMaxDiags) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (nrows + kThreads - 1) / kThreads;
  dia_spmv_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(diags), offsets, ndiags, static_cast<const T*>(x),
      static_cast<T*>(y), nrows, ncols);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_spmm(const void* diags, const int* offsets, int ndiags, const void* X, void* Y,
                int64_t nrows, int64_t ncols, int k, cudaStream_t stream) {
  if (nrows == 0 || k == 0) return 0;
  if (ndiags < 0 || ndiags > kMaxDiags || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int npanels = (k + kPanel - 1) / kPanel;
  const int64_t blocks = (nrows * npanels + kThreads - 1) / kThreads;
  dia_spmm_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(diags), offsets, ndiags, static_cast<const T*>(X),
      static_cast<T*>(Y), nrows, ncols, k, npanels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tpukk_dia_spmv(int dtype, const void* diags, const int* offsets, int ndiags,
                              const void* x, void* y, int64_t nrows, int64_t ncols,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_spmv<float>(diags, offsets, ndiags, x, y, nrows, ncols, s);
  if (dtype == 1) return launch_spmv<double>(diags, offsets, ndiags, x, y, nrows, ncols, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int tpukk_dia_spmm(int dtype, const void* diags, const int* offsets, int ndiags,
                              const void* X, void* Y, int64_t nrows, int64_t ncols, int k,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_spmm<float>(diags, offsets, ndiags, X, Y, nrows, ncols, k, s);
  if (dtype == 1) return launch_spmm<double>(diags, offsets, ndiags, X, Y, nrows, ncols, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
