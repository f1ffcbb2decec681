// The CSR row panel shared by K7 csr_spmm (csr.cu) and K6 gs_color_step
// (gs.cu): K3's vector CSR with a register panel of k accumulators.
//
// A group of G lanes (1, 2, 4, 8, 16 or 32, chosen on the host from the mean
// entries per row) owns one row.  Each lane walks the row's entries at stride
// G and, for each, reads the k contiguous values of x's row colidx[p] (x
// row-major (ncols, k)) into k register accumulators, so one pass over the
// row's entries serves all k columns.  The group then reduces each column
// with K3's shuffle tree, so a column's sum is taken in K3's order, and every
// lane of the group holds every column's sum.  k is bucketed into a
// compile-time panel of 4, 8 or 16 columns; the caller stores the sums (K7)
// or applies its update to them (K6), lane j % G taking column j.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

// acc[j] = sum_{p in row} vals[p] * x[colidx[p], j] for j < k, on every lane
// of the row's group; 0 for an invalid row.  Every lane of the warp must call
// it (the shuffles span the warp).  kReadOnlyX reads x through the read-only
// path, which is only right where nothing writes x during the kernel.
template <typename T, int G, int KMAX, bool kReadOnlyX>
__device__ __forceinline__ void csr_row_panel(const int* __restrict__ rowmap,
                                              const int* __restrict__ colidx,
                                              const T* __restrict__ vals, const T* x,
                                              int64_t row, int lane, bool valid, int k,
                                              T (&acc)[KMAX]) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) acc[j] = T(0);
  if (valid) {
    const int end = rowmap[row + 1];
    for (int p = rowmap[row] + lane; p < end; p += G) {
      const T v = vals[p];
      const T* xr = x + static_cast<int64_t>(colidx[p]) * k;
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < k) acc[j] += v * (kReadOnlyX ? __ldg(xr + j) : xr[j]);
    }
  }
  // k is the same for every lane, so each shuffle is reached by the whole warp;
  // width G keeps each group's reduction inside the group
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off, G);
    }
  }
}

inline unsigned panel_grid(int nrows, int group) {
  return static_cast<unsigned>((static_cast<int64_t>(nrows) * group + kThreads - 1) / kThreads);
}

template <int G, typename Launch>
int dispatch_kmax(int k, const Launch& launch) {
  using g = std::integral_constant<int, G>;
  if (k <= 4) return launch(g{}, std::integral_constant<int, 4>{});
  if (k <= 8) return launch(g{}, std::integral_constant<int, 8>{});
  return launch(g{}, std::integral_constant<int, 16>{});
}

// Calls launch(integral_constant<G>, integral_constant<KMAX>) for the group
// size and the panel that holds k columns; cudaErrorInvalidValue for a group
// size outside {1, 2, 4, 8, 16, 32} or k outside [1, 16].
template <typename Launch>
int dispatch_panel(int group, int k, const Launch& launch) {
  if (k < 1 || k > 16) return static_cast<int>(cudaErrorInvalidValue);
  switch (group) {
    case 1: return dispatch_kmax<1>(k, launch);
    case 2: return dispatch_kmax<2>(k, launch);
    case 4: return dispatch_kmax<4>(k, launch);
    case 8: return dispatch_kmax<8>(k, launch);
    case 16: return dispatch_kmax<16>(k, launch);
    case 32: return dispatch_kmax<32>(k, launch);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
