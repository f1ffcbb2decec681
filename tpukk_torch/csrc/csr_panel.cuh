// The CSR row panel of K6's two entries, gs_color_step and gs_sweep (gs.cu):
// a vector CSR, the design K3 had before its tiles, with a register panel of
// k accumulators.
//
// A group of G lanes (1, 2, 4, 8, 16 or 32, chosen on the host from the mean
// entries per row) owns one row.  Each lane walks the row's entries at stride
// G and, for each, reads the k contiguous values of x's row colidx[p] (x
// row-major (ncols, k)) into k register accumulators, so one pass over the
// row's entries serves all k columns.  The group then reduces each column
// with a shuffle tree, so a column's sum is taken in one fixed order, and every
// lane of the group holds every column's sum.  k is bucketed into a
// compile-time panel of 1 (a vector), 4, 8 or 16 columns; the caller applies
// its update to the sums, lane j % G taking column j.  Each product is added
// with one fma, so both entries sum a row in the same order and to the same
// bits for the same G.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

// acc[j] += v * x[c, j] for j < k, one fma each; x[c, j] reads 0 without a
// load where `zero` (the fused sweep's rows not yet written).
template <typename T, int KMAX>
__device__ __forceinline__ void panel_add(const T* x, int c, T v, int k, bool zero,
                                          T (&acc)[KMAX]) {
  const T* xr = x + static_cast<int64_t>(c) * k;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      T xv = T(0);
      if (!zero) xv = xr[j];
      acc[j] = fma(v, xv, acc[j]);
    }
  }
}

// The group's reduction of each column with its shuffle tree, after which
// every lane of the group holds every column's sum.  Every lane of the warp
// must call it (the shuffles span the warp); k is the same for every lane, so
// each shuffle is reached by the whole warp, and width G keeps each group's
// reduction inside the group.
template <typename T, int G, int KMAX>
__device__ __forceinline__ void panel_reduce(int k, T (&acc)[KMAX]) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off, G);
    }
  }
}

// acc[j] = sum_{p in row} vals[p] * x[colidx[p], j] for j < k, on every lane
// of the row's group; 0 for an invalid row.  Every lane of the warp must call
// it.  Lane `lane` adds the row's entries lane, lane + G, ... in order.
template <typename T, int G, int KMAX>
__device__ __forceinline__ void csr_row_panel(const int* __restrict__ rowmap,
                                              const int* __restrict__ colidx,
                                              const T* __restrict__ vals, const T* x,
                                              int64_t row, int lane, bool valid, int k,
                                              T (&acc)[KMAX]) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) acc[j] = T(0);
  if (valid) {
    const int end = rowmap[row + 1];
    for (int p = rowmap[row] + lane; p < end; p += G)
      panel_add<T, KMAX>(x, colidx[p], vals[p], k, false, acc);
  }
  panel_reduce<T, G, KMAX>(k, acc);
}

inline unsigned panel_grid(int nrows, int group) {
  return static_cast<unsigned>((static_cast<int64_t>(nrows) * group + kThreads - 1) / kThreads);
}

template <int G, typename Launch>
int dispatch_kmax(int k, const Launch& launch) {
  using g = std::integral_constant<int, G>;
  if (k == 1) return launch(g{}, std::integral_constant<int, 1>{});
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
