// Colored Gauss-Seidel color step for Hopper (sm_90a): K6 gs_color_step<T>.
//
// Replaces the TPU kernel _gi4_gs_fused_batched (tpukk/sparse/spmv_pallas.py
// :2125, name "tpukk_gs_gi4_fused"), the color step that tpukk's distributed
// sweep runs (tpukk/dist/gauss_seidel.py:464); the single-chip sweep
// (tpukk/sparse/gauss_seidel.py:266-287) computes the same step.
//
// What it computes, for the rows r < nrows of one color block that sits at
// rows [start, start + nrows) of the color-permuted x and b (row-major
// (n, k), k = 1 for a vector), and each column j < k:
//   ax          = sum_{p in row r} vals[p] * x[colidx[p], j]
//   out[r, j]   = (1 - omega) * x[start + r, j]
//                 + omega * invd[r] * (b[start + r, j] - ax)
// The block's CSR holds only off-diagonal entries, with columns in the
// permuted space; invd is 1/diag, 0 where the diagonal is 0.
//
// Two modes, chosen by the caller through `out`:
//   in place      out = x + start * k.  Exact only when no row of the block
//                 refers to a row of the same block (a distance-1 coloring:
//                 POINT), since then no lane reads what another lane writes;
//                 a row's own x is read by the lane that then writes it.
//   out of place  out is a block-sized buffer that the caller copies into x
//                 afterwards.  Needed where rows of one block are coupled
//                 (CLUSTER: a cluster's vertices share a color), and gives
//                 the reference's semantics there: the block's products from
//                 the old x, then the update (Jacobi within the block).
// x is therefore neither __restrict__ nor read through the read-only path.
//
// Bound on the H100: bytes.  The least traffic is the block's rowmap,
// colidx, vals and invd once, its rows of b and x read once and written once,
// and the neighbours' x values it gathers (counted once per distinct value).
//
// Design against that bound: the row panel of csr_panel.cuh, which K7 shares
// (K3's vector CSR, a group of G lanes per row, with a register panel of k
// accumulators, so one pass over the block's entries serves all k columns);
// lane j % G finishes column j with the fused update.  One launch per color
// block; no padding.
//
// C interface (bound with ctypes): returns the cudaError_t of the launch
// (0 when nothing needed launching); dtype 0 = float, 1 = double; 1 <= k <= 16.

#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_panel.cuh"

namespace {

template <typename T, int G, int KMAX>
__global__ void __launch_bounds__(kThreads)
gs_color_step_kernel(const int* __restrict__ rowmap, const int* __restrict__ colidx,
                     const T* __restrict__ vals, const T* __restrict__ invd,
                     const T* __restrict__ b, const T* x, T* out, int64_t start,
                     int nrows, int k, T omega) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const int lane = static_cast<int>(threadIdx.x) % G;
  const bool valid = row < nrows;
  T acc[KMAX];
  csr_row_panel<T, G, KMAX, false>(rowmap, colidx, vals, x, row, lane, valid, k, acc);
  if (valid) {
    const T wd = omega * invd[row];
    const int64_t g = (start + row) * k;
    T* o = out + row * k;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k && j % G == lane) {
        const T xb = x[g + j];
        o[j] = (T(1) - omega) * xb + wd * (b[g + j] - acc[j]);
      }
    }
  }
}

template <typename T>
int launch(int group, const int* rowmap, const int* colidx, const void* vals,
           const void* invd, const void* b, void* x, void* out, int64_t start, int nrows,
           int k, double omega, cudaStream_t stream) {
  if (nrows == 0) return 0;
  const T* v = static_cast<const T*>(vals);
  const T* d = static_cast<const T*>(invd);
  const T* bb = static_cast<const T*>(b);
  const T* xx = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  const T w = static_cast<T>(omega);
  return dispatch_panel(group, k, [&](auto g, auto kmax) {
    constexpr int G = decltype(g)::value, KMAX = decltype(kmax)::value;
    gs_color_step_kernel<T, G, KMAX><<<panel_grid(nrows, G), kThreads, 0, stream>>>(
        rowmap, colidx, v, d, bb, xx, o, start, nrows, k, w);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

extern "C" int tpukk_gs_color_step(int dtype, int group, const int* rowmap, const int* colidx,
                                   const void* vals, const void* invd, const void* b, void* x,
                                   void* out, int64_t start, int nrows, int k, double omega,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(group, rowmap, colidx, vals, invd, b, x, out, start, nrows, k, omega, s);
  if (dtype == 1)
    return launch<double>(group, rowmap, colidx, vals, invd, b, x, out, start, nrows, k, omega, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
