// Banded (DIA) SpMV and multi-RHS SpMM for Hopper (sm_90a).
//
// Replaces the TPU kernels (tpukk/sparse/spmv_pallas.py):
//   K1 dia_spmv<T>  <- _dia_call    (:41, Pallas "tpukk_spmv_dia"), T = float
//                   <- _dia_ds_call (:330, "tpukk_spmv_dia_ds"), T = double:
//                      the TPU carried f64 as (hi, lo) f32 pairs; Hopper has
//                      native f64, so the same kernel in double replaces it.
//   K2 dia_spmm<T>  <- _dia_mv_call (:180, "tpukk_spmv_dia_mv")
// K1 and K2 also run complex64 and complex128 (T = cplx<float>,
// cplx<double>, cplx.cuh): the same kernels, each value one 8- or 16-byte
// access.  tpukk's complex64 reaches _dia_call as four real products of the
// (re, im) planes (tpukk/sparse/spmv.py:189-233), a TPU workaround; here the
// product is one complex multiply-add a term (K2: cplx.cuh's madd, the
// product from its parts, each operation rounded on its own).  K2's vector
// stays 16 bytes: V = 2 in complex64 (1 at odd k) and 1 in complex128, and
// the 32-byte panel at V = 1 is 4 complex64 or 2 complex128 values.
//
// What it computes: y[i] = sum_j diags[j][i] * x[i + off_j], 0 <= i < nrows,
// a term whose column falls outside [0, ncols) being zero; K2 does the same
// for every column of a row-major X (ncols, k) into Y (nrows, k).
//
// Bound on the H100: bytes.  Each diagonal value is used once (2 flops per
// 4 or 8 bytes, 2k for K2), far below the card's ~20 flops/byte balance
// point.  The least traffic is the diagonal planes, x and y once each.
//
// K1, against that bound: one thread per row, so reads of diags[j][i] and
// y[i] are unit-stride across a warp and fully coalesced; x[i + off_j] is
// unit-stride too, and the ndiags shifted reads of x by one block overlap, so
// after the first they hit L1/L2 (the read-only path, __ldg) instead of
// device memory.  The kernel does its own bounds checks on the column, so it
// needs neither the TPU's padded x window nor its 1024-aligned chunks.
// Offsets (at most 256) are staged once per block in shared memory.
//
// K2, against that bound: the TPU kernel copies one window of X an output
// chunk into VMEM and reads each diagonal as a shifted slice of it.  Here a
// group of column lanes owns a row, each lane W vectors of V consecutive
// columns.  V is 4 in f32 and 2 in f64 (16 bytes), or 2 or 1 where k or X's
// alignment does not allow it; W is 1 where V > 1 (k / V lanes a row), and
// where V = 1 (odd k) a lane covers a panel of 32 bytes (W = 8 in f32, 4 in
// f64) and the row's last lane the rest: lanes of one column each would
// repeat the row's column check and diagonal load k times.  The 32-byte panel
// was the fastest of 1, 4, 8 and 16 columns on lap1000 at k = 3, 11 and 33 in
// f32 and f64, but for f32 k = 3, where 4 columns won (PERF.md, K2).
// For each diagonal a lane reads its part of X's row with W vector loads and
// writes Y's row with W vector stores (vec.cuh), so at W = 1 a warp reads
// 32·V·4 or 32·V·8 contiguous bytes of X a diagonal, where one thread a row
// with k scalar loads touched a 32-byte sector per row for each of its k
// loads.  The row's diagonal value is loaded by each of its lanes (one
// request: the lanes share its address; a shuffle from the row's first lane
// was slower), and the diagonals are added in order with one fma each
// (loading eight diagonals before adding any was slower too: PERF.md, K2).
//
// C interface (bound with ctypes): every function returns the cudaError_t of
// its launch (0 when nothing needed launching); dtype 0 = float, 1 = double,
// 2 = complex64, 3 = complex128.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cplx.cuh"
#include "vec.cuh"

namespace {

constexpr int kMaxDiags = 256;
constexpr int kThreads = 256;

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
    if (c >= 0 && c < ncols) acc += diags[j * nrows + i] * ldg(x + c);
  }
  y[i] = acc;
}

// Thread t is column lane t % lanes of row t / lanes; the lane owns columns
// c0 .. c0 + W·V - 1 (c0 = its lane index · W·V) that lie below k.
template <typename T, int V, int W>
__global__ void __launch_bounds__(kThreads)
dia_spmm_kernel(const T* __restrict__ diags, const int* __restrict__ offsets, int ndiags,
                const T* __restrict__ X, T* __restrict__ Y, int64_t nrows, int64_t ncols,
                int k, int lanes) {
  __shared__ int s_off[kMaxDiags];
  for (int j = threadIdx.x; j < ndiags; j += blockDim.x) s_off[j] = offsets[j];
  __syncthreads();
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  // a 32-bit division wherever the threads' count allows it
  const int64_t i = nrows * lanes < (int64_t{1} << 31)
                        ? static_cast<uint32_t>(t) / static_cast<uint32_t>(lanes)
                        : t / lanes;
  if (i >= nrows) return;
  const int c0 = static_cast<int>(t - i * lanes) * (W * V);
  T acc[W][V];
#pragma unroll
  for (int w = 0; w < W; ++w)
#pragma unroll
    for (int q = 0; q < V; ++q) acc[w][q] = T(0);
  for (int j = 0; j < ndiags; ++j) {
    const int64_t c = i + s_off[j];
    if (c < 0 || c >= ncols) continue;
    const T d = ldg(diags + j * nrows + i);
    const T* xr = X + c * k + c0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (W == 1 || c0 + w * V < k) {
        T xv[V];
        load_vec(xr + w * V, xv);
#pragma unroll
        for (int q = 0; q < V; ++q) acc[w][q] = madd(d, xv[q], acc[w][q]);
      }
    }
  }
  T* yr = Y + i * k + c0;
#pragma unroll
  for (int w = 0; w < W; ++w)
    if (W == 1 || c0 + w * V < k) store_vec(yr + w * V, acc[w]);
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

// The instance of V (W follows it: 32 bytes at V = 1, else 1): k a multiple of V and
// X and Y on a V-value boundary (the wrapper's vector_width picks V so);
// anything else is cudaErrorInvalidValue.
template <typename T, int V>
int launch_spmm_vec(const T* diags, const int* offsets, int ndiags, const T* X, T* Y,
                    int64_t nrows, int64_t ncols, int k, cudaStream_t stream) {
  constexpr int W = V == 1 ? 32 / static_cast<int>(sizeof(T)) : 1;
  if (k % V != 0 || reinterpret_cast<uintptr_t>(X) % (V * sizeof(T)) != 0 ||
      reinterpret_cast<uintptr_t>(Y) % (V * sizeof(T)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lanes = (k + W * V - 1) / (W * V);
  const int64_t blocks = (nrows * lanes + kThreads - 1) / kThreads;
  dia_spmm_kernel<T, V, W><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      diags, offsets, ndiags, X, Y, nrows, ncols, k, lanes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_spmm(int vec, const void* diags, const int* offsets, int ndiags, const void* X,
                void* Y, int64_t nrows, int64_t ncols, int k, cudaStream_t s) {
  if (nrows == 0 || k == 0) return 0;
  if (ndiags < 0 || ndiags > kMaxDiags || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const T* d = static_cast<const T*>(diags);
  const T* xx = static_cast<const T*>(X);
  T* yy = static_cast<T*>(Y);
  // V values of at most 16 bytes
  if (vec == 1) return launch_spmm_vec<T, 1>(d, offsets, ndiags, xx, yy, nrows, ncols, k, s);
  if constexpr (sizeof(T) <= 8)
    if (vec == 2) return launch_spmm_vec<T, 2>(d, offsets, ndiags, xx, yy, nrows, ncols, k, s);
  if constexpr (sizeof(T) == 4)
    if (vec == 4) return launch_spmm_vec<T, 4>(d, offsets, ndiags, xx, yy, nrows, ncols, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int tpukk_dia_spmv(int dtype, const void* diags, const int* offsets, int ndiags,
                              const void* x, void* y, int64_t nrows, int64_t ncols,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_spmv<float>(diags, offsets, ndiags, x, y, nrows, ncols, s);
  if (dtype == 1) return launch_spmv<double>(diags, offsets, ndiags, x, y, nrows, ncols, s);
  if (dtype == 2)
    return launch_spmv<cplx<float>>(diags, offsets, ndiags, x, y, nrows, ncols, s);
  if (dtype == 3)
    return launch_spmv<cplx<double>>(diags, offsets, ndiags, x, y, nrows, ncols, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// vec: V, the values of X's row a column lane loads at once (4, 2 or 1 in
// f32; 2 or 1 in f64 and complex64; 1 in complex128)
extern "C" int tpukk_dia_spmm(int dtype, int vec, const void* diags, const int* offsets,
                              int ndiags, const void* X, void* Y, int64_t nrows, int64_t ncols,
                              int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_spmm<float>(vec, diags, offsets, ndiags, X, Y, nrows, ncols, k, s);
  if (dtype == 1)
    return launch_spmm<double>(vec, diags, offsets, ndiags, X, Y, nrows, ncols, k, s);
  if (dtype == 2)
    return launch_spmm<cplx<float>>(vec, diags, offsets, ndiags, X, Y, nrows, ncols, k, s);
  if (dtype == 3)
    return launch_spmm<cplx<double>>(vec, diags, offsets, ndiags, X, Y, nrows, ncols, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
