// Gather-table probe kernel for Hopper (sm_90a): K9 probe_gather_acc.
//
// Replaces the three TPU kernels of scripts/probe_ss_cost.py, which probe
// the per-super-step cost of the gather-table SpMV layout:
//   make_base       (:40)   gt, lo and v streams, one (8, 128) output tile
//   make_packed_opt (:76)   gt and lo packed into one stream pk = gt<<13 | lo
//   make_mt4        (:121)  packed, a (32, 128) output block of 4 tiles
//
// What it computes, per super-step g in order: acc = sum over its B chunks j
// (in order) of v_j * xg_j, with xg_j[r, c] = X[gt_j[r, l], l], l = lo_j[r, c],
// X = x[32*s_j : 32*s_j + 32, :] and s_j the chunk's source block; then the
// step's output block d = dst[g] becomes acc (first[g] = 1) or y[d] + acc.
// Packed: gt = 8*(pk >> 16) + ((pk >> 13) & 7), lo = pk & 1023.  mt4: the
// chunk's word is srcsub = s << 2 | q and its product lands in sub-tile q of
// the 4-tile block; a first step overwrites all 4 sub-tiles (an unhit one
// becomes 0).  Products and sums are rounded separately (no FMA), in the
// Pallas kernels' order, so the result is deterministic.
//
// Bound on the H100: bytes.  Every chunk streams its index and value rows
// once (12 KB a chunk for base, 8 KB packed); x and y (256 KB each) stay in
// the L2.  The nested index gt[r, lo[r, c]] is a gather within one 128-int
// row.
//
// Design: the host sorts the super-steps by output block (a CSR of steps per
// block, g order kept).  One CTA owns one output row of one block with one
// thread per column (512 CTAs of 128 threads at the probe's shapes), walks its
// block's steps in order and keeps y and the step's sum in registers.  For each
// chunk it stages its row of gt (or pk) in shared memory for the nested index,
// then gathers x through the read-only path.  No atomics; every output row is
// written once, by its CTA (a block with no step is written 0).
//
// C interface (bound with ctypes): returns the cudaError_t of the launch (0
// when nothing needed launching).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;  // tile width
constexpr int kRows = 8;    // tile height
constexpr int kSrcRows = 32;  // rows of one source block of x

template <bool kPacked>
__global__ void __launch_bounds__(kCols)
probe_gather_acc_kernel(const float* __restrict__ x, const int* __restrict__ src,
                        const int* __restrict__ first, const int* __restrict__ gt_or_pk,
                        const int* __restrict__ lo, const float* __restrict__ v,
                        const int* __restrict__ step_ptr, const int* __restrict__ step_ids,
                        float* __restrict__ y, int tiles, int B) {
  __shared__ int row_idx[kCols];
  const int c = threadIdx.x;
  const int rows_per_block = kRows * tiles;
  const int blk = blockIdx.x / rows_per_block;
  const int R = blockIdx.x - blk * rows_per_block;  // row within the output block
  const int q = R / kRows;                          // its sub-tile (mt4)
  const int r = R - q * kRows;                      // its row within the tile
  float yv = 0.0f;
  for (int p = __ldg(step_ptr + blk); p < __ldg(step_ptr + blk + 1); ++p) {
    const int g = __ldg(step_ids + p);
    float acc = 0.0f;
    for (int j = 0; j < B; ++j) {
      const int64_t chunk = static_cast<int64_t>(g) * B + j;
      int s = __ldg(src + chunk);
      if (tiles == 4) {  // uniform across the CTA: the chunk decides
        if ((s & 3) != q) continue;
        s >>= 2;
      }
      const int64_t e = (chunk * kRows + r) * kCols + c;
      __syncthreads();  // the previous chunk's row is no longer read
      const int own = __ldg(gt_or_pk + e);
      row_idx[c] = own;
      __syncthreads();
      int l, gi;
      if (kPacked) {
        l = own & 1023;
        const int w = row_idx[l];
        gi = 8 * (w >> 16) + ((w >> 13) & 7);
      } else {
        l = __ldg(lo + e);
        gi = row_idx[l];
      }
      const float xv = __ldg(x + (static_cast<int64_t>(s) * kSrcRows + gi) * kCols + l);
      acc = __fadd_rn(acc, __fmul_rn(__ldg(v + e), xv));
    }
    yv = __ldg(first + g) ? acc : __fadd_rn(yv, acc);
  }
  y[(static_cast<int64_t>(blk) * rows_per_block + R) * kCols + c] = yv;
}

}  // namespace

extern "C" int tpukk_probe_gather_acc(int packed, int tiles, const float* x, const int* src,
                                      const int* first, const int* gt_or_pk, const int* lo,
                                      const float* v, const int* step_ptr, const int* step_ids,
                                      float* y, int n_blocks, int B, void* stream) {
  if (n_blocks == 0) return 0;
  if ((tiles != 1 && tiles != 4) || B <= 0 || (!packed && lo == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(n_blocks) * kRows * tiles;
  if (packed)
    probe_gather_acc_kernel<true><<<grid, kCols, 0, s>>>(x, src, first, gt_or_pk, lo, v,
                                                         step_ptr, step_ids, y, tiles, B);
  else
    probe_gather_acc_kernel<false><<<grid, kCols, 0, s>>>(x, src, first, gt_or_pk, lo, v,
                                                          step_ptr, step_ids, y, tiles, B);
  return static_cast<int>(cudaGetLastError());
}
