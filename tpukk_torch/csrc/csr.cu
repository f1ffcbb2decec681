// Unstructured CSR SpMV and SpMM for Hopper (sm_90a): K3 csr_spmv<T, E, Reduce,
// Stream, Long> and K7 csr_spmm<T, V, C>.
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
// x and y once each.  x is gathered, so each 4- or 8-byte read costs a 32-byte
// L2 sector unless the pattern's locality shares it.  On a small matrix the
// bound is the launch's fixed cost: a tile record's load, one trip for the
// tile's entries, values and row starts, one for the gathers, a block sync and
// a store (chip_smoke.py times it on 256 rows of one entry).
//
// Design against that bound: entry-balanced tiles of whole rows (CSR-stream,
// Greathouse and Daga, SC14).  The plan (spmv_cuda.build_csr_plan) cuts the
// rows into tiles of at most 256 rows and 256·E entries, except a row longer
// than an eighth of that, which is a tile of its own; a tile is one int4
// record (first row, rows, first entry, entries).  Against what held a vector
// CSR (one row per group of G lanes, G from the mean row length) back:
//  - lanes idle on short rows: here entry j of a tile goes to thread j % 256,
//    whatever the rows' lengths;
//  - one load in flight per lane and a dependent chain per pass: here a
//    thread loads its E entries, their values and one row start of the tile
//    in one trip, and issues its E gathers before it uses any;
//  - a warp waiting on its longest row: the products go to shared memory and
//    each row of the tile is summed by V = 256 / rows lanes (a power of two,
//    1 to 32) in a fixed order, all of the tile's rows in one pass.
// No atomics: the same bits from run to run.  A block a tile.  A matrix whose
// colidx and vals stream from device memory (beyond spmv_cuda.STREAM_BYTES)
// is read in tiles of 1024 entries (E = 4) with loads that do not allocate in
// L1, where they would only evict the x being gathered ("stream"); any other
// in tiles of 512 (E = 2) through L1 ("direct").  A row longer than a tile
// holds is read in pieces by long_row, a block reduction carried across
// pieces.  A ring of bulk asynchronous copies into shared memory was slower
// on every shape measured (PERF.md; scripts/k3_sweep_torch.py builds it as a
// variant, scripts/k3_variants.cu).

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
// read of its value and column id, which is the whole gain over k SpMVs.  X
// is gathered by rows: a row of X is k·4 or k·8 contiguous bytes (one 32-byte
// sector in f32 at k = 8), and X stays in the 50 MB L2 on the paths' shapes,
// so what limits a gather is how many L1 requests it takes, not DRAM.
//
// Design against that bound: a group of S·C lanes a row (a power of two that
// divides 32, so a warp holds 32 / (S·C) rows).  Inside the group, C column
// lanes cover the k columns, each reading V consecutive values of X's row with
// one vector load through the read-only path (V = 4 in f32, 2 in f64, smaller
// where k or X's alignment does not allow it: the same template at another
// V), so a row of X is one request of the C lanes, not k scalar loads.  The
// group's S entry slots take different entries of the row in the same step:
// the group loads a step's U·S·C entries (colidx and vals) once, coalesced,
// lane g taking entries g, g + S·C, ..., and each slot gets its U·C entries
// from them by shuffle, slot s the step's entries s, s + S, s + 2S, ... in
// order, so each lane has U·C >= 4 rows of X in flight before it adds any.
// The slots' partial sums meet in a shuffle tree over the slots (log2 S
// shuffles of V values), and slot 0's column lanes store Y's row with vector
// stores.  Each lane loops the warp's most steps, with full-warp shuffles, so
// rows of any length share a warp.  S comes from the mean entries a row, the
// rows and k on the host (spmv_cuda.spmm_geometry).  A sum is taken in a fixed
// order: slot by slot in entry order, then the tree (no atomics, the same
// bits from run to run).  colidx and vals are read through L1: no matrix on
// K7's paths passes spmv_cuda.STREAM_BYTES, and reading them past L1 was
// slower on all three of the paths' shapes (PERF.md, K7).
// Nothing is staged in shared memory: the operands are gathers, not tiles.
//
// C interface (bound with ctypes): returns the cudaError_t of the launch
// (0 when nothing needed launching); dtype 0 = float, 1 = double; reduce
// 0 = sum, 1 = max; streamed (K3) 0 = direct, 1 = stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kThreads = 256;

// ---- K3 ---------------------------------------------------------------------

constexpr int kTileRows = kThreads;  // a row start a thread, so each row of a tile has its lanes

// A load that does not allocate in L1: a matrix that streams from device
// memory is read once, and in L1 it would only evict the x it gathers.
__device__ __forceinline__ int ld_stream(const int* p) {
  int v;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float ld_stream(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ double ld_stream(const double* p) {
  double v;
  asm("ld.global.nc.L1::no_allocate.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}

// Shared memory, in bytes: the tile's products, its row starts and the
// warps' partial results.
template <typename T, int E>
struct Smem {
  static constexpr int kCap = kThreads * E;  // entries a tile holds, but a long row
  static constexpr int kStarts = kCap * static_cast<int>(sizeof(T));
  static constexpr int kPart = kStarts + (kTileRows + 8) * 4;
  static constexpr int kBytes = kPart + 32 * static_cast<int>(sizeof(T));
};

template <typename T, bool kMax>
__device__ __forceinline__ T combine(T a, T b) {
  return kMax ? max(a, b) : a + b;
}

// A tile's entries, values and row starts, loaded from global memory through
// L1 (direct) or past it (stream).
template <typename T, bool kStream>
struct GlobalTile {
  const int* __restrict__ rowmap;
  const int* __restrict__ colidx;
  const T* __restrict__ vals;

  template <typename U>
  __device__ __forceinline__ static U load(const U* p) {
    return kStream ? ld_stream(p) : __ldg(p);
  }
  __device__ __forceinline__ int col(const int4& t, int j) const { return load(colidx + t.z + j); }
  __device__ __forceinline__ T val(const int4& t, int j) const { return load(vals + t.z + j); }
  __device__ __forceinline__ int start(const int4& t, int q) const { return load(rowmap + t.x + q); }
};

// A tile of whole rows (t: first row, rows <= 256, first entry, entries <=
// 256·E) read through src: entry j at thread j % 256, its E gathers issued
// before any is used; the products and the row starts go to shared memory,
// then each row is summed by V = 256 / rows lanes (a power of two, 1 to 32),
// lane l adding the row's products l, l + V, ... and the lanes combined by a
// shuffle tree.
template <typename T, int E, bool kMax, typename Source>
__device__ __forceinline__ void tile_sums(const int4 t, const Source& src, const T* __restrict__ x,
                                          T* __restrict__ y, T* prod, int* starts) {
  const int tid = threadIdx.x;
  int col[E];
  T val[E], xv[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = tid + k * kThreads;
    col[k] = j < t.w ? src.col(t, j) : -1;
    val[k] = j < t.w ? src.val(t, j) : T(0);
  }
  const int s0 = tid <= t.y ? src.start(t, tid) : 0;
  const int s1 = tid == 0 && t.y == kThreads ? src.start(t, kThreads) : 0;
#pragma unroll
  for (int k = 0; k < E; ++k) xv[k] = col[k] >= 0 ? __ldg(x + col[k]) : T(0);
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = tid + k * kThreads;
    if (j < t.w) prod[j] = val[k] * xv[k];
  }
  starts[tid] = s0 - t.z;
  if (tid == 0) starts[kThreads] = s1 - t.z;
  __syncthreads();
  const int per = kThreads / t.y;
  const int V = per >= 32 ? 32 : 1 << (31 - __clz(per));
  const int g = tid / V, lane = tid & (V - 1);
  T acc = T(0);
  if (g < t.y) {
    const int end = starts[g + 1];
    for (int j = starts[g] + lane; j < end; j += V) acc = combine<T, kMax>(acc, prod[j]);
  }
  for (int off = V >> 1; off > 0; off >>= 1)
    acc = combine<T, kMax>(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (g < t.y && lane == 0) y[t.x + g] = acc;
}

// A row longer than a tile holds: the block reads it directly in pieces of
// 256·E entries, each thread summing its entries of a piece, then the warps'
// shuffle trees and the 8 warps in order, carried across pieces.  Off the
// common path, and not inlined into it.
template <typename T, int E, bool kMax>
__device__ __noinline__ void long_row(int4 t, const int* __restrict__ colidx,
                                      const T* __restrict__ vals, const T* __restrict__ x,
                                      T* __restrict__ y, T* part) {
  const int tid = threadIdx.x;
  T total = T(0);
  for (int first = t.z; first < t.z + t.w; first += kThreads * E) {
    const int count = min(kThreads * E, t.z + t.w - first);
    int col[E];
    T val[E];
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int j = tid + k * kThreads;
      col[k] = j < count ? __ldg(colidx + first + j) : -1;
      val[k] = j < count ? __ldg(vals + first + j) : T(0);
    }
#pragma unroll
    for (int k = 0; k < E; ++k)
      acc = combine<T, kMax>(acc, val[k] * (col[k] >= 0 ? __ldg(x + col[k]) : T(0)));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = combine<T, kMax>(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if ((tid & 31) == 0) part[tid >> 5] = acc;
    __syncthreads();
    if (tid == 0)
      for (int w = 0; w < kThreads / 32; ++w) total = combine<T, kMax>(total, part[w]);
    __syncthreads();
  }
  if (tid == 0) y[t.x] = total;
}

// A tile record the kernel's shared memory cannot hold is the plan's fault.
template <int kCap, bool kLong>
__device__ __forceinline__ int4 checked_tile(int4 u) {
  if (u.y < 1 || u.y > kTileRows || (u.w > kCap && (u.y > 1 || !kLong))) __trap();
  return u;
}

// A block a tile.  A row longer than a tile holds is read by long_row, which
// only the kLong instances hold (the plan knows whether it has such a row),
// so the common path carries no call.
template <typename T, int E, bool kMax, bool kStream, bool kLong>
__global__ void __launch_bounds__(kThreads)
csr_spmv_kernel(const int4* __restrict__ tiles, const int* __restrict__ rowmap,
                const int* __restrict__ colidx, const T* __restrict__ vals,
                const T* __restrict__ x, T* __restrict__ y) {
  using S = Smem<T, E>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int4 t = checked_tile<S::kCap, kLong>(tiles[blockIdx.x]);
  if (kLong && t.w > S::kCap)
    long_row<T, E, kMax>(t, colidx, vals, x, y, reinterpret_cast<T*>(smem + S::kPart));
  else
    tile_sums<T, E, kMax>(t, GlobalTile<T, kStream>{rowmap, colidx, vals}, x, y,
                          reinterpret_cast<T*>(smem), reinterpret_cast<int*>(smem + S::kStarts));
}

constexpr int kMaxDevices = 64;
constexpr int kSmemPerBlockReserved = 1024;  // the runtime's own shared memory per block

// The blocks of one kernel instance resident on an SM, cached per device.  On
// first use it sets the instance's carve-out preference to the shared memory
// those blocks need, which leaves the rest of the SM's 256 KB to L1, where
// the gathers of x hit.  -1 on failure.
template <typename Kernel>
int prefer_l1(Kernel kernel, int bytes, std::atomic<int>* cache) {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= kMaxDevices) return -1;
  const int hit = cache[device].load(std::memory_order_relaxed);
  if (hit > 0) return hit;
  int per_sm = 0, resident = 0;
  if (cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device) !=
          cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kThreads, bytes) !=
          cudaSuccess ||
      resident < 1)
    return -1;
  const int need = resident * (bytes + kSmemPerBlockReserved);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           min(100, (100 * need + per_sm - 1) / per_sm)) != cudaSuccess)
    return -1;
  cache[device].store(resident, std::memory_order_relaxed);
  return resident;
}

template <typename T, int E, bool kMax, bool kStream, bool kLong>
int launch_tiles(const int4* tiles, int ntiles, const int* rowmap, const int* colidx,
                 const void* vals, const void* x, void* y, cudaStream_t stream) {
  static std::atomic<int> cache[kMaxDevices];
  auto kernel = csr_spmv_kernel<T, E, kMax, kStream, kLong>;
  constexpr int bytes = Smem<T, E>::kBytes;
  if (prefer_l1(kernel, bytes, cache) <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(ntiles), kThreads, bytes, stream>>>(
      tiles, rowmap, colidx, static_cast<const T*>(vals), static_cast<const T*>(x),
      static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

// direct: tiles of 512 entries (E = 2) through L1; stream: of 1024 (E = 4)
// past it (spmv_cuda.csr_tile_entries)
template <typename T, bool kMax>
int launch_spmv(int streamed, int long_rows, const int4* t, int ntiles, const int* rowmap,
                const int* colidx, const void* vals, const void* x, void* y, cudaStream_t s) {
  if (ntiles == 0) return 0;
  if (streamed && long_rows)
    return launch_tiles<T, 4, kMax, true, true>(t, ntiles, rowmap, colidx, vals, x, y, s);
  if (streamed)
    return launch_tiles<T, 4, kMax, true, false>(t, ntiles, rowmap, colidx, vals, x, y, s);
  if (long_rows)
    return launch_tiles<T, 2, kMax, false, true>(t, ntiles, rowmap, colidx, vals, x, y, s);
  return launch_tiles<T, 2, kMax, false, false>(t, ntiles, rowmap, colidx, vals, x, y, s);
}

// ---- K7 ----------------------------------------------------------------------

// One vector load of V values of X's row through the read-only path, and one
// vector store of Y's row.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load_vec(const float* p, float (&v)[2]) {
  const float2 q = __ldg(reinterpret_cast<const float2*>(p));
  v[0] = q.x, v[1] = q.y;
}
__device__ __forceinline__ void load_vec(const double* p, double (&v)[2]) {
  const double2 q = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = q.x, v[1] = q.y;
}
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store_vec(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[1]) {
  *p = v[0];
}

__host__ __device__ constexpr int log2_of(int c) { return c <= 1 ? 0 : 1 + log2_of(c / 2); }

// A group of S·C lanes a row (S = 1 << log_slots entry slots of C column
// lanes); lane g of the group is slot g / C, column lane g % C, and holds
// columns (g % C)·V .. + V - 1.  Each step the lane loads U entries of the row
// (g, g + S·C, ...), then its slot takes the step's entries s, s + S, ...
// from the lanes that loaded them.
template <typename T, int V, int C>
__global__ void __launch_bounds__(kThreads)
csr_spmm_kernel(const int* __restrict__ rowmap, const int* __restrict__ colidx,
                const T* __restrict__ vals, const T* __restrict__ x, T* __restrict__ y,
                int nrows, int k, int log_slots) {
  constexpr int U = C >= 4 ? 1 : 4 / C;  // entries a lane loads a step; a slot takes U·C
  constexpr unsigned kFull = 0xffffffffu;
  using Mat = GlobalTile<T, false>;
  const int S = 1 << log_slots;
  const int log_w = log_slots + log2_of(C);
  const int W = 1 << log_w;
  const int lane = threadIdx.x & 31;
  const int g = lane & (W - 1);
  const int src0 = (lane - g) + g / C;  // the lane that loads this slot's first entry of a step
  const int c = g % C;
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> log_w;
  const bool valid = row < nrows;
  const bool active = c * V < k;  // column lanes past k read and write nothing
  int p0 = 0, p1 = 0;
  if (valid) {
    p0 = __ldg(rowmap + row);
    p1 = __ldg(rowmap + row + 1);
  }
  const int step = U * W;
  const int steps = __reduce_max_sync(kFull, (p1 - p0 + step - 1) / step);
  const T* xc = x + c * V;
  T acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = T(0);
  for (int it = 0, first = p0 + g; it < steps; ++it, first += step) {
    int col[U];
    T val[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = first + u * W;
      col[u] = j < p1 ? Mat::load(colidx + j) : -1;
      val[u] = j < p1 ? Mat::load(vals + j) : T(0);
    }
    T xv[U * C][V];
    T vv[U * C];
#pragma unroll
    for (int i = 0; i < U * C; ++i) {
      // the step's entry s + S·i: loaded by lane S·(i % C) + s, as its entry i / C
      int ci;
      if constexpr (C == 1) {
        ci = col[i];
        vv[i] = val[i];
      } else {
        ci = __shfl_sync(kFull, col[i / C], src0 + S * (i % C));
        vv[i] = __shfl_sync(kFull, val[i / C], src0 + S * (i % C));
      }
      if (ci >= 0 && active) {
        load_vec(xc + static_cast<int64_t>(ci) * k, xv[i]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) xv[i][v] = T(0);
      }
    }
#pragma unroll
    for (int i = 0; i < U * C; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fma(vv[i], xv[i][v], acc[v]);
  }
  for (int off = C; off < W; off <<= 1)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] += __shfl_xor_sync(kFull, acc[v], off);
  if (valid && g < C && active) store_vec(y + row * k + c * V, acc);
}

template <typename T, int V, int C>
int launch_spmm_at(const int* rowmap, const int* colidx, const T* vals, const T* x, T* y,
                   int nrows, int k, int log_slots, cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(nrows) << (log_slots + log2_of(C));
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  csr_spmm_kernel<T, V, C><<<blocks, kThreads, 0, stream>>>(rowmap, colidx, vals, x, y, nrows,
                                                             k, log_slots);
  return static_cast<int>(cudaGetLastError());
}

// The instance of (V, C): C a power of two with k <= C·V <= 16, S·C <= 32,
// k a multiple of V and x on a V-value boundary (the wrapper's spmm_geometry
// picks them so); anything else is cudaErrorInvalidValue.
template <typename T, int V>
int launch_spmm_vec(int cols, const int* rowmap, const int* colidx, const T* vals, const T* x,
                    T* y, int nrows, int k, int log_slots, cudaStream_t s) {
  if (k % V != 0 || reinterpret_cast<uintptr_t>(x) % (V * sizeof(T)) != 0 || cols * V < k ||
      (cols << log_slots) > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto at = [&](auto c) {
    return launch_spmm_at<T, V, decltype(c)::value>(rowmap, colidx, vals, x, y, nrows, k,
                                                    log_slots, s);
  };
  switch (cols) {
    case 1: return at(std::integral_constant<int, 1>{});
    case 2: return at(std::integral_constant<int, 2>{});
    case 4: return at(std::integral_constant<int, 4>{});
    case 8:
      if constexpr (V <= 2) return at(std::integral_constant<int, 8>{});
      break;
    case 16:
      if constexpr (V == 1) return at(std::integral_constant<int, 16>{});
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_spmm(int vec, int cols, int log_slots, const int* rowmap, const int* colidx,
                const void* vals, const void* x, void* y, int nrows, int k, cudaStream_t s) {
  if (k < 1 || k > 16 || log_slots < 0 || log_slots > 5)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nrows == 0) return 0;
  const T* v = static_cast<const T*>(vals);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  if (vec == 1)
    return launch_spmm_vec<T, 1>(cols, rowmap, colidx, v, xx, yy, nrows, k, log_slots, s);
  if (vec == 2)
    return launch_spmm_vec<T, 2>(cols, rowmap, colidx, v, xx, yy, nrows, k, log_slots, s);
  if constexpr (sizeof(T) == 4)
    if (vec == 4)
      return launch_spmm_vec<T, 4>(cols, rowmap, colidx, v, xx, yy, nrows, k, log_slots, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// vec: V, the values of X's row a column lane loads at once (4, 2 or 1 in
// f32; 2 or 1 in f64); cols: C, the column lanes of a slot; log_slots: log2
// of S, the entry slots of a row
extern "C" int tpukk_csr_spmm(int dtype, int vec, int cols, int log_slots, const int* rowmap,
                              const int* colidx, const void* vals, const void* x, void* y,
                              int nrows, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_spmm<float>(vec, cols, log_slots, rowmap, colidx, vals, x, y, nrows, k, s);
  if (dtype == 1)
    return launch_spmm<double>(vec, cols, log_slots, rowmap, colidx, vals, x, y, nrows, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// tiles: (ntiles, 4) int32 records (first row, rows, first entry, entries),
// at most 256 rows and 512 (direct) or 1024 (streamed) entries each, but a
// tile of one row; long_rows: whether a tile exceeds the entry cap
extern "C" int tpukk_csr_spmv(int dtype, int reduce, int streamed, int long_rows,
                              const void* tiles, int ntiles, const int* rowmap,
                              const int* colidx, const void* vals, const void* x, void* y,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* t = static_cast<const int4*>(tiles);
  if (dtype == 0 && reduce == 0)
    return launch_spmv<float, false>(streamed, long_rows, t, ntiles, rowmap, colidx, vals, x, y, s);
  if (dtype == 0 && reduce == 1)
    return launch_spmv<float, true>(streamed, long_rows, t, ntiles, rowmap, colidx, vals, x, y, s);
  if (dtype == 1 && reduce == 0)
    return launch_spmv<double, false>(streamed, long_rows, t, ntiles, rowmap, colidx, vals, x, y,
                                      s);
  if (dtype == 1 && reduce == 1)
    return launch_spmv<double, true>(streamed, long_rows, t, ntiles, rowmap, colidx, vals, x, y,
                                     s);
  return static_cast<int>(cudaErrorInvalidValue);
}
