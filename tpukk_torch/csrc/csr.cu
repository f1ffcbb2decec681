// Unstructured CSR SpMV and SpMM for Hopper (sm_90a): K3 csr_spmv<T, Reduce>
// and K7 csr_spmm<T>.
//
// ---- K3 ----
// Replaces the TPU kernels (tpukk/sparse/spmv_pallas.py), seven layouts of one
// product that exist because of Mosaic limits (no fast dynamic gather, no
// native f64), all reached through onehot_spmv (:1193):
//   _onehot_call (:891), _dl_call (:959), _dl_call_batched (:1013),
//   _gi4_call_batched (:2053, sum and max), _dlp_call_batched (:2216, sum and
//   max), _gt_call_batched (:2325), _gi_call_batched (:2390)    -> T = float
//   _gi4_ds_call_batched (:2691), f64 as (hi, lo) f32 pairs       -> T = double
//
// What it computes: y[r] = reduce_{p in row r} vals[p] * x[colidx[p]], with
// reduce = sum, or max with the neutral value 0 that the TPU kernels' padding
// slots give (max mode is for non-negative values and x, as in onehot_spmv).
// Empty rows give 0 in both modes.
//
// Bound on the H100: bytes.  Per stored entry it moves a value and a column
// id (8 or 12 bytes) for 2 flops; the least traffic is rowmap, colidx, vals,
// x and y once each.  x is gathered, so its reads are only as cheap as the
// pattern's locality lets L1/L2 make them.
//
// Design against that bound: vector CSR, the reference's team/thread/vector
// SpMV (SURVEY.md §2.10, KokkosSparse_spmv_impl.hpp:135-154,361-377).  A group
// of G lanes (1, 2, 4, 8, 16 or 32, chosen on the host from the mean entries
// per row) owns one row: its lanes read the row's colidx and vals at
// consecutive addresses, so a warp's loads are coalesced even for short
// rows, and combine their partial results with a warp-shuffle reduction.  No
// padding, no atomics, no plan beyond the CSR arrays themselves.
//
// ---- K7 ----
// Replaces the five multi-RHS layouts behind onehot_spmm
// (tpukk/sparse/spmv_pallas.py:1326): _dl_mm_call (:1074),
// _dl_mm_call_batched (:1132), _onehot_spmm_call (:1254), _gt_mm_call_batched
// (:2449) and _pk_mm_call_batched (:2521), which the ONEHOT route runs for a
// row-major X of shape (ncols, k), 1 < k <= 16 (tpukk/sparse/spmv.py:249).
//
// What it computes: Y[r, j] = sum_{p in row r} vals[p] * X[colidx[p], j] for
// j < k, Y row-major (nrows, k).
//
// Bound on the H100: bytes.  The least traffic is rowmap, colidx and vals
// once (as for one SpMV), X once and Y once; k columns per entry share one
// read of its value and column id, which is the whole gain over k SpMVs.
//
// Design against that bound: K3's vector CSR with k accumulators per lane (K2's
// idea for CSR), the row panel of csr_panel.cuh, which K6 shares; lane j % G
// writes column j.
//
// C interface (bound with ctypes): returns the cudaError_t of the launch
// (0 when nothing needed launching); dtype 0 = float, 1 = double; reduce
// 0 = sum, 1 = max.

#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_panel.cuh"

namespace {

template <typename T, int G, bool kMax>
__global__ void __launch_bounds__(kThreads)
csr_spmv_kernel(const int* __restrict__ rowmap, const int* __restrict__ colidx,
                const T* __restrict__ vals, const T* __restrict__ x, T* __restrict__ y,
                int nrows) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t row = t / G;
  const int lane = static_cast<int>(threadIdx.x) % G;
  const bool valid = row < nrows;
  T acc = T(0);
  if (valid) {
    const int end = rowmap[row + 1];
    for (int p = rowmap[row] + lane; p < end; p += G) {
      const T v = vals[p] * __ldg(x + colidx[p]);
      acc = kMax ? max(acc, v) : acc + v;
    }
  }
  // every lane of the warp reaches the shuffles (no early return above);
  // width G keeps each group's reduction inside the group
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const T o = __shfl_xor_sync(0xffffffffu, acc, off, G);
    acc = kMax ? max(acc, o) : acc + o;
  }
  if (valid && lane == 0) y[row] = acc;
}

template <typename T, bool kMax>
int launch(int group, const int* rowmap, const int* colidx, const void* vals, const void* x,
           void* y, int nrows, cudaStream_t stream) {
  if (nrows == 0) return 0;
  const int64_t blocks = (static_cast<int64_t>(nrows) * group + kThreads - 1) / kThreads;
  const T* v = static_cast<const T*>(vals);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  const unsigned b = static_cast<unsigned>(blocks);
  switch (group) {
    case 1: csr_spmv_kernel<T, 1, kMax><<<b, kThreads, 0, stream>>>(rowmap, colidx, v, xx, yy, nrows); break;
    case 2: csr_spmv_kernel<T, 2, kMax><<<b, kThreads, 0, stream>>>(rowmap, colidx, v, xx, yy, nrows); break;
    case 4: csr_spmv_kernel<T, 4, kMax><<<b, kThreads, 0, stream>>>(rowmap, colidx, v, xx, yy, nrows); break;
    case 8: csr_spmv_kernel<T, 8, kMax><<<b, kThreads, 0, stream>>>(rowmap, colidx, v, xx, yy, nrows); break;
    case 16: csr_spmv_kernel<T, 16, kMax><<<b, kThreads, 0, stream>>>(rowmap, colidx, v, xx, yy, nrows); break;
    case 32: csr_spmv_kernel<T, 32, kMax><<<b, kThreads, 0, stream>>>(rowmap, colidx, v, xx, yy, nrows); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G, int KMAX>
__global__ void __launch_bounds__(kThreads)
csr_spmm_kernel(const int* __restrict__ rowmap, const int* __restrict__ colidx,
                const T* __restrict__ vals, const T* __restrict__ x, T* __restrict__ y,
                int nrows, int k) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const int lane = static_cast<int>(threadIdx.x) % G;
  const bool valid = row < nrows;
  T acc[KMAX];
  csr_row_panel<T, G, KMAX, true>(rowmap, colidx, vals, x, row, lane, valid, k, acc);
  if (valid) {
    T* yr = y + row * k;
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < k && j % G == lane) yr[j] = acc[j];
  }
}

template <typename T>
int launch_spmm(int group, const int* rowmap, const int* colidx, const void* vals,
                const void* x, void* y, int nrows, int k, cudaStream_t stream) {
  if (nrows == 0 || k == 0) return 0;
  const T* v = static_cast<const T*>(vals);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  return dispatch_panel(group, k, [&](auto g, auto kmax) {
    constexpr int G = decltype(g)::value, KMAX = decltype(kmax)::value;
    csr_spmm_kernel<T, G, KMAX><<<panel_grid(nrows, G), kThreads, 0, stream>>>(
        rowmap, colidx, v, xx, yy, nrows, k);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

extern "C" int tpukk_csr_spmm(int dtype, int group, const int* rowmap, const int* colidx,
                              const void* vals, const void* x, void* y, int nrows, int k,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_spmm<float>(group, rowmap, colidx, vals, x, y, nrows, k, s);
  if (dtype == 1) return launch_spmm<double>(group, rowmap, colidx, vals, x, y, nrows, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int tpukk_csr_spmv(int dtype, int reduce, int group, const int* rowmap,
                              const int* colidx, const void* vals, const void* x, void* y,
                              int nrows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && reduce == 0) return launch<float, false>(group, rowmap, colidx, vals, x, y, nrows, s);
  if (dtype == 0 && reduce == 1) return launch<float, true>(group, rowmap, colidx, vals, x, y, nrows, s);
  if (dtype == 1 && reduce == 0) return launch<double, false>(group, rowmap, colidx, vals, x, y, nrows, s);
  if (dtype == 1 && reduce == 1) return launch<double, true>(group, rowmap, colidx, vals, x, y, nrows, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
