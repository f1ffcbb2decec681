// SpGEMM numeric phase for Hopper (sm_90a): K8 spgemm_rows<T>.
//
// Replaces the seven TPU kernels of tpukk/sparse/spgemm_pallas.py, which
// compute one function of a c-sorted pair plan in layouts that exist because
// of Mosaic limits (no fast dynamic gather, no native f64):
//   _onehot_pair_call (:345)      flat chunks, one-hot radix gathers
//   _dl_pair_call (:407)          dst-lane chunks
//   _dl_pair_call_batched (:464)  dst-lane chunks, super-steps
//   _gt_pair_call (:997)          gather tables for both value reads
//   _gtp_pk_call (:1063)          packed dual gathers, 4 C tiles per step
//   _expand3_call (:1398)         b gathered into pair order (permute phase 1)
//   _rowperm3a_call (:1447)       permute phase 3 + a gather + product
// and tpukk's f64 XLA pair path (spgemm.py::_numeric_pairs).
//
// What it computes: C's values on C's pattern (from the symbolic phase, its
// columns sorted within a row), C[i, j] = sum_k A[i, k] * B[k, j], each
// product rounded, each C entry summed from 0 in (A entry, B entry) order:
// the order of tpukk's pair plan, so the result is the same bits from run to
// run and for every lane count.
//
// Bound on the H100: bytes.  The compulsory traffic is A's CSR read once,
// C's pattern read once and C's values written once; B's rows are read once
// per A entry that names them, mostly from L1 and L2.  There is no pair plan:
// the pair kernel this replaces streamed one (a_idx, b_idx) per product and
// an int64 offset per C entry, 2.5x the compulsory bytes (PERF.md, K8).  What
// the row-wise design adds instead is work on the chip: a binary search of
// the C row's columns per product, in shared memory.
//
// Design against that bound (a row-wise numeric with a shared-memory
// accumulator, KKMEM, Deveci et al., arXiv 1801.03065): a group of L lanes
// (1, 2, 4, 8, 16 or 32) owns one C row.  A warp's rows lie one after
// another in its shared region; the warp copies their C columns in and zeroes
// a slot per C entry, and at the end writes their values out, both as one
// coalesced run where the rows are consecutive.  Between, each group adds
// its row's products:
//  - one lane (L = 1, the rows with few C entries, most rows in flight):
//    every product in order, kOne entries of a B row loaded at a time, the
//    next entry of A loaded ahead;
//  - a group (L > 1): kPass entries of A a pass, lane l taking B entries
//    l, l + L, ... of each; each product's slot by a binary search of the
//    row's columns (a lane's searches in step).  Within one entry of A no two
//    products share a slot (no row of B repeats a column), so the lanes add
//    an entry's products together, and a group barrier (__syncwarp) between
//    entries keeps the order.  A pass's B entries are loaded during the pass
//    before, its entries of A two passes before.
// So every C entry receives its products from 0 in the pair order.  Where
// some row of B repeats a column (the plan records it), a group leaves its
// row to one lane.  No atomics; products and sums use __fmul_rn/__fadd_rn
// (__dmul_rn/__dadd_rn), so the compiler cannot contract them into an FMA.
// A row whose C part does not fit the shared-memory cap accumulates in C's
// own values in global memory, in the same order, zeroed by its group first.
//
// The row plan (spgemm_cuda.build_row_plan) orders the rows with a C entry by
// bin and hands the kernel a bin table by value: bin b holds rows
// order[first[b] ...] at lanes[b] lanes, kThreads / lanes rows a block, with
// stride[b] shared slots a row (0: accumulate in global memory).  One launch
// covers every bin, so the kernel's registers are those of its widest path.
//
// Complex values (T = cplx<float>, cplx<double>, cplx.cuh) run the same
// kernel: a product is (ar·br − ai·bi, ar·bi + ai·br) with every operation
// rounded on its own, as the plain version forms it from the parts, so the
// bits still match.  A slot then holds 8 or 16 bytes: at complex128 a block
// of the widest bin needs SLOT_CAP · (4 + 16) = 120 KB, which the launch opts
// in to (the H100 gives a block up to 227 KB), at one block an SM.
//
// C interface (bound with ctypes): returns the cudaError_t of the launch (0
// when nothing needed launching); dtype 0 = float, 1 = double, 2 = complex64,
// 3 = complex128.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "cplx.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBins = 7;   // 1, 2, 4, 8, 16, 32 lanes in shared memory; 32 in global memory
// the loads a lane keeps in flight (scratch sweeps on the H100, PERF.md §6 K8)
constexpr int kPass = 2;  // entries of A a group takes a pass
constexpr int kSpan = 1;  // B entries a lane loads for each of them with the pass
constexpr int kOne = 4;   // B entries one lane loads at a time
constexpr int kCopy = 8;  // C columns a lane copies to shared memory at a time
constexpr int kMaxDevices = 64;

struct Bins {
  int n;
  int dups;  // some row of B repeats a column
  int first_block[kMaxBins + 1];
  int first[kMaxBins];   // into order
  int rows[kMaxBins];
  int lanes[kMaxBins];
  int stride[kMaxBins];  // shared slots a row; 0 = C's own values in global memory
};

template <typename T>
struct Operands {
  const int* __restrict__ arm;
  const int* __restrict__ aent;
  const T* __restrict__ aval;
  const int* __restrict__ brm;
  const int* __restrict__ bent;
  const T* __restrict__ bval;
  const int* __restrict__ crm;
  const int* __restrict__ cent;
  T* __restrict__ cval;
  const int* __restrict__ order;
};

// The slots of R columns among the row's n sorted columns: R binary searches
// in step (col < 0 marks no product and leaves slot 0).  The kernel does not
// check that the pattern holds a column: the plan's pattern comes from the
// symbolic phase, or is checked where it is handed in (interop).
template <int R>
__device__ __forceinline__ void find_slots(const int* cols, int n, const int (&col)[R],
                                           int (&slot)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) slot[r] = 0;
  for (int len = n; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (cols[slot[r] + half] <= col[r]) slot[r] += half;
    len -= half;
  }
}

// An entry of A: its B row [bs, be) and its value.  The value comes last: with
// a 16-byte complex128 value first, nvcc 12.9 at -O3 emits PTX in which the
// value of the entry loaded two passes ahead (row_sum's later[1]) is never
// read, so a group of lanes multiplies by a stale value; with the value last
// (or under -G) every loaded value is used and the bits are the plain
// version's (scripts/k8_complex_layout_torch.py).
template <typename T>
struct AEntry {
  int bs, be;
  T a;
};

template <typename T>
__device__ __forceinline__ AEntry<T> a_entry(const Operands<T>& o, int p, int a1) {
  if (p >= a1) return {0, 0, T(0)};
  const int k = __ldg(o.aent + p);
  return {__ldg(o.brm + k), __ldg(o.brm + k + 1), ldg(o.aval + p)};
}

// V entries of a B row from q on, V apart by `step` (col -1 past be).
template <typename T, int V>
__device__ __forceinline__ void b_entries(const Operands<T>& o, int q, int step, int be,
                                          int (&col)[V], T (&bv)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const bool in = q + v * step < be;
    col[v] = in ? __ldg(o.bent + q + v * step) : -1;
    bv[v] = in ? ldg(o.bval + q + v * step) : T(0);
  }
}

// acc[slot] += a·b for each product, in order (col -1: none)
template <typename T, int V>
__device__ __forceinline__ void add_products(T* acc, const int (&col)[V], const int (&slot)[V],
                                             T a, const T (&bv)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (col[v] >= 0) acc[slot[v]] = add_rn(acc[slot[v]], mul_rn(a, bv[v]));
}

// The products of one entry of A from B entry q on, `step` apart (a lane's
// share of its B row), V of them loaded, found and added at a time.
template <typename T, int V>
__device__ __forceinline__ void rest_of_row(const Operands<T>& o, const int* cols, int n, T* acc,
                                            int q, int step, AEntry<T> e) {
  for (; q < e.be; q += V * step) {
    int col[V], slot[V];
    T bv[V];
    b_entries<T, V>(o, q, step, e.be, col, bv);
    find_slots<V>(cols, n, col, slot);
    add_products<T, V>(acc, col, slot, e.a, bv);
  }
}

// The group of the warp whose packed slots hold slot j of the warp: the last
// group whose offset is at most j (a group without a row has no slots).
template <int L>
__device__ __forceinline__ int owner(int off, int j) {
  int h = 0;
#pragma unroll
  for (int step = 16 / L; step > 0; step >>= 1)
    if (__shfl_sync(0xffffffffu, off, (h + step) * L) <= j) h += step;
  return h;
}

// One C row (none where row < 0) by a group of L lanes.  In shared memory
// (kShared) the warp's rows are packed one after another in its region
// (wcols, wacc), and the warp copies their columns in and their values out
// together: where the rows are consecutive (their C entries one run) that is
// one coalesced run, however few lanes a row has.  Otherwise the group uses
// C's own columns and values in global memory.
template <typename T, int L, bool kShared>
__device__ __forceinline__ void row_sum(const Operands<T>& o, int row, bool dups, int* wcols,
                                        T* wacc) {
  const int me = threadIdx.x & 31;
  const int lane = me & (L - 1);
  const unsigned gmask = L == 32 ? 0xffffffffu : ((1u << L) - 1u) << (me & ~(L - 1));
  int c0 = 0, n = 0, a0 = 0, a1 = 0;
  if (row >= 0) {
    c0 = o.crm[row];
    n = o.crm[row + 1] - c0;
    a0 = o.arm[row];
    a1 = o.arm[row + 1];
  }
  const int* cols = o.cent + c0;
  T* acc = o.cval + c0;
  int off = 0, total = 0, first = 0;
  bool run = true;
  if (kShared) {
    // each group's offset in the warp's region: a scan of the rows' lengths
    int incl = lane == 0 ? n : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (me >= d) incl += v;
    }
    off = incl - n;
    total = __shfl_sync(0xffffffffu, incl, 31);
    first = __shfl_sync(0xffffffffu, c0, 0);
    run = __all_sync(0xffffffffu, n == 0 || c0 == first + off);
    // kCopy columns a lane in flight: a load and its store one at a time
    // would wait out a global load's latency per column
    for (int j0 = 0; j0 < total; j0 += kCopy * 32) {  // the same trips for the whole warp
      int c[kCopy];
#pragma unroll
      for (int u = 0; u < kCopy; ++u) {
        const int j = j0 + u * 32 + me;
        int src = first + j;
        if (!run) {
          const int h = owner<L>(off, j);
          src = __shfl_sync(0xffffffffu, c0, h * L) + j - __shfl_sync(0xffffffffu, off, h * L);
        }
        c[u] = j < total ? __ldg(o.cent + src) : 0;
      }
#pragma unroll
      for (int u = 0; u < kCopy; ++u)
        if (j0 + u * 32 + me < total) {
          wcols[j0 + u * 32 + me] = c[u];
          wacc[j0 + u * 32 + me] = T(0);
        }
    }
    cols = wcols + off;
    acc = wacc + off;
    __syncwarp();
  } else {
    for (int j = lane; j < n; j += L) acc[j] = T(0);
    __syncwarp(gmask);
  }
  if (L == 1 || dups) {
    // one lane adds every product in order (where a row of B repeats a
    // column, two products of one A entry may share a slot, so a group
    // leaves this to its first lane), kOne entries of a B row at a time; the
    // next entry of A is loaded before the current one's products are added
    if (lane == 0) {
      AEntry<T> cur = a_entry(o, a0, a1);
      for (int p = a0; p < a1; ++p) {
        const AEntry<T> next = a_entry(o, p + 1, a1);
        rest_of_row<T, kOne>(o, cols, n, acc, cur.bs, 1, cur);
        cur = next;
      }
    }
    __syncwarp(gmask);
  } else {
    // kPass entries of A a pass, lane l taking B entries l, l + L, ... of
    // each (kSpan of them loaded with the pass): within one entry of A no two
    // products share a slot, so the lanes add an entry's products together,
    // and a group barrier between entries keeps the pair order.  Loads run
    // ahead of the order: a pass's B entries are loaded during the pass
    // before, its entries of A two passes before.
    constexpr int R = kPass, V = kSpan;
    AEntry<T> cur[R], next[R];
    int col[R][V];
    T bv[R][V];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      cur[r] = a_entry(o, a0 + r, a1);
      next[r] = a_entry(o, a0 + R + r, a1);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) b_entries<T, V>(o, cur[r].bs + lane, L, cur[r].be, col[r], bv[r]);
    for (int p0 = a0; p0 < a1; p0 += R) {
      int ncol[R][V], slot[R][V];
      T nbv[R][V];
      AEntry<T> later[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        b_entries<T, V>(o, next[r].bs + lane, L, next[r].be, ncol[r], nbv[r]);
        later[r] = a_entry(o, p0 + 2 * R + r, a1);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) find_slots<V>(cols, n, col[r], slot[r]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        add_products<T, V>(acc, col[r], slot[r], cur[r].a, bv[r]);
        rest_of_row<T, V>(o, cols, n, acc, cur[r].bs + V * L + lane, L, cur[r]);
        __syncwarp(gmask);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        cur[r] = next[r];
        next[r] = later[r];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          col[r][v] = ncol[r][v];
          bv[r][v] = nbv[r][v];
        }
      }
    }
  }
  if (kShared) {
    __syncwarp();
    for (int j0 = 0; j0 < total; j0 += 32) {
      const int j = j0 + me;
      int dst = first + j;
      if (!run) {
        const int h = owner<L>(off, j);
        dst = __shfl_sync(0xffffffffu, c0, h * L) + j - __shfl_sync(0xffffffffu, off, h * L);
      }
      if (j < total) o.cval[dst] = wacc[j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spgemm_rows_kernel(const Operands<T> o, const Bins bins) {
  int b = 0;
  while (b + 1 < bins.n && static_cast<int>(blockIdx.x) >= bins.first_block[b + 1]) ++b;
  const int lanes = bins.lanes[b], groups = kThreads / lanes, stride = bins.stride[b];
  const int g = threadIdx.x / lanes;
  const int idx = (static_cast<int>(blockIdx.x) - bins.first_block[b]) * groups + g;
  // a group past the bin's rows has none, but its warp still copies for the
  // others
  const int row = idx < bins.rows[b] ? o.order[bins.first[b] + idx] : -1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int wslots = 32 / min(lanes, 32) * stride;  // a warp's region
  int* wcols = reinterpret_cast<int*>(smem) + (threadIdx.x >> 5) * wslots;
  T* wacc = reinterpret_cast<T*>(smem + ((groups * stride * 4 + 15) & ~15)) +
            (threadIdx.x >> 5) * wslots;
  switch (stride ? lanes : 0) {
    case 0: row_sum<T, 32, false>(o, row, bins.dups, nullptr, nullptr); break;
    case 1: row_sum<T, 1, true>(o, row, bins.dups, wcols, wacc); break;
    case 2: row_sum<T, 2, true>(o, row, bins.dups, wcols, wacc); break;
    case 4: row_sum<T, 4, true>(o, row, bins.dups, wcols, wacc); break;
    case 8: row_sum<T, 8, true>(o, row, bins.dups, wcols, wacc); break;
    case 16: row_sum<T, 16, true>(o, row, bins.dups, wcols, wacc); break;
    default: row_sum<T, 32, true>(o, row, bins.dups, wcols, wacc); break;
  }
}

// Shared bytes of a block: the largest bin's columns and slots.
template <typename T>
int smem_bytes(const Bins& bins) {
  int most = 0;
  for (int b = 0; b < bins.n; ++b) {
    const int slots = kThreads / bins.lanes[b] * bins.stride[b];
    const int bytes = ((slots * 4 + 15) & ~15) + slots * static_cast<int>(sizeof(T));
    most = bytes > most ? bytes : most;
  }
  return most;
}

template <typename T>
int launch(const int* arm, const int* aent, const void* aval, const int* brm, const int* bent,
           const void* bval, const int* crm, const int* cent, void* cval, const int* order,
           const int* table, cudaStream_t stream) {
  Bins bins{};
  bins.n = table[0];
  bins.dups = table[1];
  if (bins.n < 1 || bins.n > kMaxBins) return static_cast<int>(cudaErrorInvalidValue);
  for (int b = 0; b <= bins.n; ++b) bins.first_block[b] = table[2 + b];
  for (int b = 0; b < bins.n; ++b) {
    const int* r = table + 3 + kMaxBins + 4 * b;
    bins.first[b] = r[0];
    bins.rows[b] = r[1];
    bins.lanes[b] = r[2];
    bins.stride[b] = r[3];
    if (r[2] < 1 || r[2] > 32 || (r[2] & (r[2] - 1)) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = bins.first_block[bins.n];
  if (blocks == 0) return 0;
  const int bytes = smem_bytes<T>(bins);
  // more than the default 48 KB needs the kernel's opt-in, once per device
  static std::atomic<int> opted[kMaxDevices];
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (bytes > 48 * 1024 && opted[device].load(std::memory_order_relaxed) < bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        spgemm_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted[device].store(bytes, std::memory_order_relaxed);
  }
  const Operands<T> o{arm, aent, static_cast<const T*>(aval), brm, bent,
                      static_cast<const T*>(bval), crm, cent, static_cast<T*>(cval), order};
  spgemm_rows_kernel<T><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(o, bins);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: host int32 [n, dups, first_block[0..kMaxBins], then per bin (first,
// rows, lanes, stride)], as spgemm_cuda.build_row_plan lays it out
extern "C" int tpukk_spgemm_rows(int dtype, const int* arm, const int* aent, const void* aval,
                                 const int* brm, const int* bent, const void* bval,
                                 const int* crm, const int* cent, void* cval, const int* order,
                                 const int* table, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(arm, aent, aval, brm, bent, bval, crm, cent, cval, order,
                                       table, s);
  if (dtype == 1) return launch<double>(arm, aent, aval, brm, bent, bval, crm, cent, cval, order,
                                        table, s);
  if (dtype == 2)
    return launch<cplx<float>>(arm, aent, aval, brm, bent, bval, crm, cent, cval, order, table, s);
  if (dtype == 3)
    return launch<cplx<double>>(arm, aent, aval, brm, bent, bval, crm, cent, cval, order, table,
                                s);
  return static_cast<int>(cudaErrorInvalidValue);
}
