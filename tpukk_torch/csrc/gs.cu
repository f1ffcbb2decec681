// Colored Gauss-Seidel for Hopper (sm_90a): K6, three entries.
//
// Replaces the TPU kernel _gi4_gs_fused_batched (tpukk/sparse/spmv_pallas.py
// :2125, name "tpukk_gs_gi4_fused"), the color step that tpukk's distributed
// sweep runs (tpukk/dist/gauss_seidel.py:464) and that the single-chip sweep
// (tpukk/sparse/gauss_seidel.py:266-287) runs once per color, each a launch.
//
// The relaxation, the same in every entry, for a row r of the color-permuted
// system (x and b row-major (n, k), k = 1 for a vector) and each column j < k:
//   ax          = sum_{p in row r} vals[p] * x[colidx[p], j]
//   x'[r, j]    = (1 - omega) * x[r, j] + omega * invd[r] * (b[r, j] - ax)
// The CSR holds only off-diagonal entries, with columns in the permuted
// space; invd is 1/diag, 0 where the diagonal is 0.  f32, f64, complex64 and
// complex128 (T = cplx<float>, cplx<double>, cplx.cuh): in complex values
// omega stays real, invd is the complex 1/diag, and every product and sum is
// rounded on its own (the panel's madd, gs_relax below).  A value never
// travels in a sync word (the chunk counters are released after the work
// buffer is written), so complex128's 16-byte values need no tagged words.
// gs_color_step and gs_sweep sum ax with the row panel of csr_panel.cuh (K3's
// vector CSR, a group of G lanes per row, a register panel of k accumulators,
// one fma a product) and finish with gs_relax, so at one G they give the same
// bits.
//
// gs_color_step: one color block, rows [start, start + nrows), one launch.
//   in place      out = x + start * k.  Exact only when no row of the block
//                 refers to a row of the same block (a distance-1 coloring:
//                 POINT), since then no lane reads what another lane writes;
//                 a row's own x is read by the lane that then writes it.
//   out of place  out is a block-sized buffer that the caller copies into x
//                 afterwards.  Needed where rows of one block are coupled
//                 (CLUSTER: a cluster's vertices share a color), and gives
//                 the reference's semantics there: the block's products from
//                 the old x, then the update (Jacobi within the block).
//   Bound: bytes.  The block's rowmap, colidx, vals and invd once, its rows
//   of b and x read once and written once, and each distinct neighbour value.
//
// gs_sweep: a whole apply in one launch: every color step of every
// half-sweep, with the permutations into and out of color order and the zero
// start folded in.  The plan is a list of steps, each a row range and a mode:
//   gather        work[r] = x_in[src[r]] (the given x, into color order)
//   in place      a color block's relaxation into work (uncoupled blocks)
//   to scratch    a coupled block's relaxation into scratch[r - begin]
//   copy          work[r] = scratch[r - begin]
// b is read as b[src[r]]; a step marked final also writes its value to
// out[dst[r]] (out null: work is the result; src, dst null: the identity).
// A step's zero range [zlo, zhi) stands for the rows not yet written when the
// apply starts from x = 0: x there reads 0 without a load, so the working
// buffer needs no fill.
//   Bound: bytes per step (as gs_color_step, summed over the steps) and the
//   chain of steps: a step starts only when the one before it has finished,
//   so an apply costs at least (number of steps) x (one publish-and-observe
//   round trip through L2).  A launch a step paid that trip and the launch's
//   own cost besides (about 3 us on small blocks, PERF.md).
//   Design (K4's ticket argument, sptrsv.cu): blocks take chunks of rows in
//   step order from one ticket counter; a chunk waits, on one thread's
//   acquire poll, until the step before has counted all its chunks (once a
//   block has seen a step finish it does not poll for it again), then the
//   block works the chunk and publishes it with one release add (one atomic
//   a chunk, not a row: same-address atomics serialise in L2).  Every
//   counter sits on its own 128-byte line, so the pollers of one step do not
//   queue behind another step's adds.  A block loads the row data of its
//   chunk that no step writes (rowmap, the lane's first two entries, invd,
//   b, src, dst) before it waits, and takes its next ticket while it waits.
//   Blocks are
//   never relied on to be co-resident: a chunk waits only on chunks with
//   smaller tickets, handed to blocks already running.  The ticket, the
//   blocks-out count and one done count a step live in a small device state
//   array that the last block out resets, so a launch needs no host reset
//   and replays inside a CUDA graph; a plan's state serves one sweep at a
//   time.  A wait of 2^28 polls can only mean a plan whose steps cannot
//   finish: the kernel traps instead of hanging the card.  This ordering is
//   written once (sweep_chunks), for both entries: an operand layout supplies
//   what a chunk loads ahead of its wait and the chunk's work after it.
//
// gs_sweep_dia: the same apply, the same steps, tickets and state, on a
// second operand layout that holds no column index.  The plan takes it where
// every color block is uncoupled, holds at most 32 distinct offsets
// (permuted column - permuted row) and reads fewer bytes so (padded slots x w
// + a 4-byte mask a row, against the CSR's stored x (w + 4) + 4n), for a
// vector b (k = 1): a stencil in a structured coloring, as HPCG's 27 points
// in the 8 parity colors (26 offsets a block, 2 % padding).  A block's values
// lie diagonal-major, vals[d][row in block], 0 in a padded slot, and a row's
// mask marks its real slots.
//   Bound: bytes, as gs_sweep, less the column indices and the row pointers;
//   a first half-sweep from x = 0 also skips every slot whose column lies in
//   its step's zero range (on the parity coloring half the slots forward).
//   Then the chain of steps: a step's rows are relaxed by the rows in flight
//   at once (a CUDA block of 128 threads, five an SM), so a step of 140,608
//   rows takes about two rounds of loads, and the next step starts when the
//   last has been published.
//   Design: one thread a row, so consecutive threads read consecutive values
//   of a diagonal and gather x at consecutive rows.  The row's values of
//   every live slot (a real slot whose column the zero range does not cover)
//   are loaded into registers before the chunk waits, since no step writes
//   them; after it, its x loads carry no branch (a dead slot reads the row's
//   own x).  A chunk is a CUDA block of rows (the plan's step list for the
//   route counts chunks of kDiaThreads rows), 128 against the CSR's 48 on
//   hpcg104, so an apply takes 2.7 times fewer tickets.  A padded slot is
//   neither loaded nor added: the working buffer is never filled, and 0 *
//   garbage may be NaN.  The products are added in slot order with one madd
//   each, so the route differs from gs_sweep by rounding alone (held within
//   20·eps a step).  Tried on hpcg104 f64 and slower (PERF.md, K6): 256-thread
//   blocks; chunks of two or four passes; the values and x staged in shared
//   memory by cp.async; a back-off in the poll; fewer blocks an SM.
//
// C interface (bound with ctypes): returns the cudaError_t of the launch
// (0 when nothing needed launching); dtype 0 = float, 1 = double,
// 2 = complex64, 3 = complex128; 1 <= k <= 16 (gs_sweep_dia: k = 1).

#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_panel.cuh"

namespace {

constexpr unsigned kMaxPolls = 1u << 28;

// x' = (1 - omega) * x + (omega * invd) * (b - ax), with one fma; wd is
// omega * invd
template <typename T>
__device__ __forceinline__ T gs_relax(T x, T b, T ax, T omega, T wd) {
  return fma(wd, b - ax, (T(1) - omega) * x);
}
// in complex values (omega real): wd·(b − ax) + (1 − omega)·x, each
// operation rounded on its own
template <typename R>
__device__ __forceinline__ cplx<R> gs_relax(cplx<R> x, cplx<R> b, cplx<R> ax, R omega,
                                            cplx<R> wd) {
  return add_rn(mul_rn(wd, sub_rn(b, ax)), scale(R(1) - omega, x));
}

template <typename T, int G, int KMAX, typename R = typename real_of<T>::type>
__global__ void __launch_bounds__(kThreads)
gs_color_step_kernel(const int* __restrict__ rowmap, const int* __restrict__ colidx,
                     const T* __restrict__ vals, const T* __restrict__ invd,
                     const T* __restrict__ b, const T* x, T* out, int64_t start,
                     int nrows, int k, R omega) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const int lane = static_cast<int>(threadIdx.x) % G;
  const bool valid = row < nrows;
  T acc[KMAX];
  csr_row_panel<T, G, KMAX>(rowmap, colidx, vals, x, row, lane, valid, k, acc);
  if (valid) {
    const T wd = scale(omega, invd[row]);
    const int64_t g = (start + row) * k;
    T* o = out + row * k;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k && j % G == lane) o[j] = gs_relax(x[g + j], b[g + j], acc[j], omega, wd);
    }
  }
}

// ---- the steps and the scheduler of gs_sweep and gs_sweep_dia --------------

// a step: int32 x kStepInts
enum { kBegin, kEnd, kMode, kFinal, kZeroLo, kZeroHi, kChunk0, kWait, kStepInts };
enum { kGather = 0, kInPlace = 1, kToScratch = 2, kCopy = 3 };

// the state's counters, each on its own 128-byte line: the ticket, the
// blocks-out count, then one done count a step
constexpr int kLine = 32;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// a chunk of rows [r0, r1) of its step, as the scheduler hands it to a layout
struct Chunk {
  int begin, mode, r0, r1, zlo, zhi;
  bool final;  // the step writes the result (where the launch has an out)
};

// K6's ordering, once for both operand layouts.  L.ahead(chunk) loads what
// the chunk's rows read that no step writes, before the chunk waits;
// L.run(chunk) does the chunk's work once the step before has finished.
// state[0]: next chunk ticket; state[kLine]: blocks that have finished the
// launch; state[(2 + s) * kLine]: chunks of step s that have finished.
template <typename Layout>
__device__ __forceinline__ void sweep_chunks(Layout& L, const int* __restrict__ steps, int nsteps,
                                             int nchunks, int chunk_rows, unsigned* state) {
  const int tid = static_cast<int>(threadIdx.x);
  __shared__ int next;
  if (tid == 0) next = static_cast<int>(atomicAdd(state, 1u));
  __syncthreads();
  int t = next, s = 0;
  int seen = -1;     // thread 0: the last step this block has seen finished
  unsigned mine = 0;  // thread 0: the next ticket, in flight
  while (t < nchunks) {
    // the step of chunk t: the last at or after s whose first chunk is <= t
    for (int hi = nsteps - 1; s < hi;) {
      const int mid = (s + hi + 1) / 2;
      if (__ldg(steps + mid * kStepInts + kChunk0) <= t) s = mid; else hi = mid - 1;
    }
    const int* d = steps + s * kStepInts;
    Chunk ch;
    ch.begin = __ldg(d + kBegin);
    ch.mode = __ldg(d + kMode);
    ch.r0 = ch.begin + (t - __ldg(d + kChunk0)) * chunk_rows;
    ch.r1 = min(__ldg(d + kEnd), ch.r0 + chunk_rows);
    ch.final = __ldg(d + kFinal) != 0;
    ch.zlo = __ldg(d + kZeroLo);
    ch.zhi = __ldg(d + kZeroHi);
    const unsigned wait = static_cast<unsigned>(__ldg(d + kWait));
    L.ahead(ch);
    if (tid == 0) {
      mine = atomicAdd(state, 1u);  // in flight while this chunk waits and works
      if (wait > 0 && s - 1 > seen) {
        const unsigned* done = state + (2 + s - 1) * kLine;
        for (unsigned polls = 0; ld_acquire(done) < wait;) {
          if (++polls == kMaxPolls) __trap();
        }
        seen = s - 1;
      }
    }
    __syncthreads();
    L.run(ch);
    if (tid == 0) next = static_cast<int>(mine);
    __syncthreads();  // the block's stores come before thread 0's release
    if (tid == 0) red_release(state + (2 + s) * kLine, 1u);
    t = next;
  }
  // the last block out resets the state for the next launch; no block reads
  // it once it has counted itself out
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(state + kLine, 1u) == gridDim.x - 1) {
      for (int i = 0; i < nsteps; ++i) state[(2 + i) * kLine] = 0;
      state[0] = 0;
      state[kLine] = 0;
    }
  }
}

// ---- gs_sweep: the CSR layout ----------------------------------------------

// what a row of a relaxation step reads that no step writes, loaded before
// the chunk waits: its entry range, the lane's first two entries, omega *
// invd, its b values (the lane's columns) and its output row; the values
// come after the ints (K8's lesson: a 16-byte complex value first in a
// struct lost loaded values under -O3, PERF.md PR 14)
template <typename T, int KMAX>
struct RowAhead {
  int p = 0, end = 0, c0 = 0, c1 = 0, to = 0;
  T v0 = T(0), v1 = T(0), wd = T(0);
  T b[KMAX];
};

template <typename T, int G, int KMAX, typename R>
__device__ __forceinline__ void load_ahead(RowAhead<T, KMAX>& a, const int* __restrict__ rowmap,
                                           const int* __restrict__ colidx,
                                           const T* __restrict__ vals,
                                           const T* __restrict__ invd, const T* __restrict__ b,
                                           const int* __restrict__ src,
                                           const int* __restrict__ dst, int row, bool valid,
                                           int lane, int k, R omega) {
  a.p = a.end = 0;
  if (!valid) return;
  a.end = __ldg(rowmap + row + 1);
  a.p = __ldg(rowmap + row) + lane;
  if (a.p < a.end) {
    a.c0 = __ldg(colidx + a.p);
    a.v0 = ldg(vals + a.p);
  }
  if (a.p + G < a.end) {
    a.c1 = __ldg(colidx + a.p + G);
    a.v1 = ldg(vals + a.p + G);
  }
  a.wd = scale(omega, ldg(invd + row));
  const int64_t sr = static_cast<int64_t>(src ? __ldg(src + row) : row) * k;
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    if (j < k && j % G == lane) a.b[j] = ldg(b + sr + j);
  a.to = dst ? __ldg(dst + row) : row;
}

// G lanes a row (kThreads / G rows a pass); a chunk of several passes loads
// its first pass ahead of the wait and each later pass after the one before
template <typename T, int G, int KMAX, typename R>
struct CsrRows {
  const int* rowmap;
  const int* colidx;
  const T* vals;
  const T* invd;
  const T* b;
  const T* xin;
  const int* src;
  const int* dst;
  T* work;
  T* scratch;
  T* out;
  int k;
  R omega;
  RowAhead<T, KMAX> a;

  __device__ __forceinline__ void ahead(const Chunk& ch) {
    const int tid = static_cast<int>(threadIdx.x);
    if (ch.mode == kInPlace || ch.mode == kToScratch)
      load_ahead<T, G, KMAX>(a, rowmap, colidx, vals, invd, b, src, dst, ch.r0 + tid / G,
                             ch.r0 + tid / G < ch.r1, tid % G, k, omega);
  }

  __device__ __forceinline__ void run(const Chunk& ch) {
    constexpr int kRows = kThreads / G;  // rows a block relaxes side by side
    const int tid = static_cast<int>(threadIdx.x), lane = tid % G;
    const bool final = ch.final && out != nullptr;
    if (ch.mode == kInPlace || ch.mode == kToScratch) {
      for (int base = ch.r0; base < ch.r1; base += kRows) {
        const int row = base + tid / G;
        const bool valid = row < ch.r1;
        if (base != ch.r0)
          load_ahead<T, G, KMAX>(a, rowmap, colidx, vals, invd, b, src, dst, row, valid, lane,
                                 k, omega);
        T acc[KMAX];
#pragma unroll
        for (int j = 0; j < KMAX; ++j) acc[j] = T(0);
        if (a.p < a.end) {
          panel_add<T, KMAX>(work, a.c0, a.v0, k, a.c0 >= ch.zlo && a.c0 < ch.zhi, acc);
          if (a.p + G < a.end) {
            panel_add<T, KMAX>(work, a.c1, a.v1, k, a.c1 >= ch.zlo && a.c1 < ch.zhi, acc);
            for (int p = a.p + 2 * G; p < a.end; p += G) {
              const int c = __ldg(colidx + p);
              panel_add<T, KMAX>(work, c, ldg(vals + p), k, c >= ch.zlo && c < ch.zhi, acc);
            }
          }
        }
        panel_reduce<T, G, KMAX>(k, acc);
        if (valid) {
          const bool unwritten = row >= ch.zlo && row < ch.zhi;
          const int64_t g = static_cast<int64_t>(row) * k;
          T* o = ch.mode == kInPlace ? work + g
                                     : scratch + static_cast<int64_t>(row - ch.begin) * k;
#pragma unroll
          for (int j = 0; j < KMAX; ++j) {
            if (j < k && j % G == lane) {
              const T x = gs_relax(unwritten ? T(0) : work[g + j], a.b[j], acc[j], omega, a.wd);
              o[j] = x;
              if (final) out[static_cast<int64_t>(a.to) * k + j] = x;
            }
          }
        }
      }
    } else {
      const int count = (ch.r1 - ch.r0) * k;
      for (int e = tid; e < count; e += kThreads) {
        const int r = ch.r0 + e / k, j = e % k;
        const int64_t g = static_cast<int64_t>(r) * k + j;
        if (ch.mode == kGather) {
          work[g] = ldg(xin + static_cast<int64_t>(src ? __ldg(src + r) : r) * k + j);
        } else {
          const T x = scratch[static_cast<int64_t>(r - ch.begin) * k + j];
          work[g] = x;
          if (final) out[static_cast<int64_t>(dst ? __ldg(dst + r) : r) * k + j] = x;
        }
      }
    }
  }
};

template <typename T, int G, int KMAX, typename R = typename real_of<T>::type>
__global__ void __launch_bounds__(kThreads)
gs_sweep_kernel(const int* __restrict__ rowmap, const int* __restrict__ colidx,
                const T* __restrict__ vals, const T* __restrict__ invd,
                const int* __restrict__ steps, int nsteps, int nchunks, int chunk_rows,
                const T* __restrict__ b, const T* __restrict__ xin, const int* __restrict__ src,
                const int* __restrict__ dst, T* work, T* scratch, T* __restrict__ out,
                unsigned* state, int k, R omega) {
  CsrRows<T, G, KMAX, R> rows{rowmap, colidx, vals, invd, b,   xin,   src,
                              dst,    work,   scratch, out, k, omega};
  sweep_chunks(rows, steps, nsteps, nchunks, chunk_rows, state);
}

// ---- gs_sweep_dia: the layout of constant offsets --------------------------

constexpr int kDiaSlots = 32;     // a block's offsets are padded to this in the table
constexpr int kDiaThreads = 128;  // rows a pass of a CUDA block, one a thread

// ld_stream (cplx.cuh) kept where it is written: the values loaded ahead of a
// chunk's wait are then in flight during it, and not sunk to their first use
// after it, behind the branch of their slot
__device__ __forceinline__ float ld_ahead(const float* p) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ double ld_ahead(const double* p) {
  double v;
  asm volatile("ld.global.nc.L1::no_allocate.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ cplx<float> ld_ahead(const cplx<float>* p) {
  cplx<float> v;
  asm volatile("ld.global.nc.L1::no_allocate.v2.f32 {%0, %1}, [%2];" : "=f"(v.re), "=f"(v.im)
               : "l"(p));
  return v;
}
__device__ __forceinline__ cplx<double> ld_ahead(const cplx<double>* p) {
  cplx<double> v;
  asm volatile("ld.global.nc.L1::no_allocate.v2.f64 {%0, %1}, [%2];" : "=d"(v.re), "=d"(v.im)
               : "l"(p));
  return v;
}

// what a row of the DIA route reads that no step writes, loaded before the
// chunk waits: its live slots (real, and outside the step's zero range),
// their values, omega * invd, b and its output row
template <typename T, int NV>
struct DiaAhead {
  unsigned live = 0;
  int to = 0;
  T wd = T(0), b = T(0);
  T v[NV];
};

// offs and vals: the row's color block's offsets and values; local: the
// row's place in the block of nrows rows
template <typename T, int NV, typename R>
__device__ __forceinline__ void dia_ahead(DiaAhead<T, NV>& a, const unsigned* __restrict__ mask,
                                          const int* __restrict__ offs,
                                          const T* __restrict__ vals, int nrows, int local,
                                          const T* __restrict__ invd, const T* __restrict__ b,
                                          const int* __restrict__ src,
                                          const int* __restrict__ dst, int row, bool valid,
                                          int zlo, int zhi, R omega) {
  a.live = 0;
  if (!valid) return;
  unsigned m = __ldg(mask + row);
#pragma unroll
  for (int d = 0; d < NV; ++d) {
    a.v[d] = T(0);
    if ((m >> d) & 1u) {
      const int c = row + __ldg(offs + d);
      if (c >= zlo && c < zhi)
        m &= ~(1u << d);
      else
        a.v[d] = ld_ahead(vals + static_cast<int64_t>(d) * nrows + local);
    }
  }
  a.live = m;
  a.wd = scale(omega, ldg(invd + row));
  a.b = ldg(b + (src ? __ldg(src + row) : row));
  a.to = dst ? __ldg(dst + row) : row;
}

// one thread a row; starts: the blocks' first rows (nblocks + 1); offs:
// kDiaSlots offsets a block; vbase: each block's first value; soff: shared,
// the chunk's block's offsets.  The route's plans have no coupled block, so
// no to-scratch or copy step.
template <typename T, int NV, typename R>
struct DiaRows {
  const int* starts;
  int nblocks;
  const int* offs;
  const int64_t* vbase;
  const T* vals;
  const unsigned* mask;
  const T* invd;
  const T* b;
  const T* xin;
  const int* src;
  const int* dst;
  T* work;
  T* out;
  R omega;
  int* soff;
  int nrows = 0;            // the chunk's color block: its rows,
  const int* o = nullptr;   // offsets
  const T* v = nullptr;     // and values
  DiaAhead<T, NV> a;

  __device__ __forceinline__ void ahead(const Chunk& ch) {
    const int tid = static_cast<int>(threadIdx.x);
    const bool relax = ch.mode == kInPlace;
    // the step's color block: the one that starts at its first row
    int c = 0;
    for (int hi = nblocks - 1; relax && c < hi;) {
      const int mid = (c + hi + 1) / 2;
      if (__ldg(starts + mid) <= ch.begin) c = mid; else hi = mid - 1;
    }
    nrows = __ldg(starts + c + 1) - ch.begin;
    o = offs + c * kDiaSlots;
    v = vals + __ldg(vbase + c);
    if (tid < kDiaSlots) soff[tid] = __ldg(o + tid);  // read after the scheduler's barrier
    if (relax)
      dia_ahead<T, NV>(a, mask, o, v, nrows, ch.r0 + tid - ch.begin, invd, b, src, dst,
                       ch.r0 + tid, ch.r0 + tid < ch.r1, ch.zlo, ch.zhi, omega);
  }

  __device__ __forceinline__ void run(const Chunk& ch) {
    const int tid = static_cast<int>(threadIdx.x);
    const bool final = ch.final && out != nullptr;
    if (ch.mode == kInPlace) {
      for (int base = ch.r0; base < ch.r1; base += kDiaThreads) {
        const int row = base + tid;
        const bool valid = row < ch.r1;
        if (base != ch.r0)
          dia_ahead<T, NV>(a, mask, o, v, nrows, row - ch.begin, invd, b, src, dst, row, valid,
                           ch.zlo, ch.zhi, omega);
        if (valid) {
          // no x load behind a branch: a dead slot reads the row's own x
          // (read below anyway) in place of its column's
          T xs[NV];
#pragma unroll
          for (int j = 0; j < NV; ++j) xs[j] = work[row + (((a.live >> j) & 1u) ? soff[j] : 0)];
          T ax = T(0);
#pragma unroll
          for (int j = 0; j < NV; ++j)
            if ((a.live >> j) & 1u) ax = madd(a.v[j], xs[j], ax);
          const bool unwritten = row >= ch.zlo && row < ch.zhi;
          const T x = gs_relax(unwritten ? T(0) : work[row], a.b, ax, omega, a.wd);
          work[row] = x;
          if (final) out[a.to] = x;
        }
      }
    } else {
      for (int r = ch.r0 + tid; r < ch.r1; r += kDiaThreads)
        work[r] = ldg(xin + (src ? __ldg(src + r) : r));
    }
  }
};

// Five blocks an SM: f64 rows of 32 slots without spills (96 registers)
template <typename T, int NV, typename R = typename real_of<T>::type>
__global__ void __launch_bounds__(kDiaThreads, 5)
gs_sweep_dia_kernel(const int* __restrict__ starts, int nblocks, const int* __restrict__ offs,
                    const int64_t* __restrict__ vbase, const T* __restrict__ vals,
                    const unsigned* __restrict__ mask, const T* __restrict__ invd,
                    const int* __restrict__ steps, int nsteps, int nchunks, int chunk_rows,
                    const T* __restrict__ b, const T* __restrict__ xin,
                    const int* __restrict__ src, const int* __restrict__ dst, T* work,
                    T* __restrict__ out, unsigned* state, R omega) {
  __shared__ int soff[kDiaSlots];
  DiaRows<T, NV, R> rows{starts, nblocks, offs, vbase, vals, mask, invd, b,
                         xin,    src,     dst,  work,  out,  omega, soff};
  sweep_chunks(rows, steps, nsteps, nchunks, chunk_rows, state);
}

template <typename T, int NV>
int launch_sweep_dia(const int* starts, int nblocks, const int* offs, const int64_t* vbase,
                     const void* vals, const unsigned* mask, const void* invd, const int* steps,
                     int nsteps, int nchunks, int chunk_rows, const void* b, const void* xin,
                     const int* src, const int* dst, void* work, void* out, unsigned* state,
                     double omega, cudaStream_t stream) {
  auto kernel = gs_sweep_dia_kernel<T, NV>;
  int device = 0, sms = 0, resident = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kDiaThreads, 0);
  const int blocks = min(nchunks, max(resident, 1) * sms);
  kernel<<<static_cast<unsigned>(blocks), kDiaThreads, 0, stream>>>(
      starts, nblocks, offs, vbase, static_cast<const T*>(vals), mask,
      static_cast<const T*>(invd), steps, nsteps, nchunks, chunk_rows,
      static_cast<const T*>(b), static_cast<const T*>(xin), src, dst, static_cast<T*>(work),
      static_cast<T*>(out), state, static_cast<typename real_of<T>::type>(omega));
  return static_cast<int>(cudaGetLastError());
}

// the register panel of slots: 8, 16 or 32, the fewest that holds the
// plan's most offsets of a block
template <typename T>
int dispatch_sweep_dia(int max_diags, const int* starts, int nblocks, const int* offs,
                       const int64_t* vbase, const void* vals, const unsigned* mask,
                       const void* invd, const int* steps, int nsteps, int nchunks,
                       int chunk_rows, const void* b, const void* xin, const int* src,
                       const int* dst, void* work, void* out, unsigned* state, double omega,
                       cudaStream_t stream) {
  if (nchunks == 0) return 0;
  if (nsteps <= 0 || chunk_rows <= 0 || nblocks <= 0 || max_diags < 0 || max_diags > kDiaSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  if (max_diags <= 8)
    return launch_sweep_dia<T, 8>(starts, nblocks, offs, vbase, vals, mask, invd, steps, nsteps,
                                  nchunks, chunk_rows, b, xin, src, dst, work, out, state, omega,
                                  stream);
  if (max_diags <= 16)
    return launch_sweep_dia<T, 16>(starts, nblocks, offs, vbase, vals, mask, invd, steps,
                                   nsteps, nchunks, chunk_rows, b, xin, src, dst, work, out,
                                   state, omega, stream);
  return launch_sweep_dia<T, 32>(starts, nblocks, offs, vbase, vals, mask, invd, steps, nsteps,
                                 nchunks, chunk_rows, b, xin, src, dst, work, out, state, omega,
                                 stream);
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
  using R = typename real_of<T>::type;
  const R w = static_cast<R>(omega);
  return dispatch_panel(group, k, [&](auto g, auto kmax) {
    constexpr int G = decltype(g)::value, KMAX = decltype(kmax)::value;
    gs_color_step_kernel<T, G, KMAX><<<panel_grid(nrows, G), kThreads, 0, stream>>>(
        rowmap, colidx, v, d, bb, xx, o, start, nrows, k, w);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int launch_sweep(int group, const int* rowmap, const int* colidx, const void* vals,
                 const void* invd, const int* steps, int nsteps, int nchunks, int chunk_rows,
                 const void* b, const void* xin, const int* src, const int* dst, void* work,
                 void* scratch, void* out, unsigned* state, int k, double omega,
                 cudaStream_t stream) {
  if (nchunks == 0) return 0;
  if (nsteps <= 0 || chunk_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_panel(group, k, [&](auto g, auto kmax) {
    constexpr int G = decltype(g)::value, KMAX = decltype(kmax)::value;
    auto kernel = gs_sweep_kernel<T, G, KMAX>;
    int device = 0, sms = 0, resident = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kThreads, 0);
    const int blocks = min(nchunks, max(resident, 1) * sms);
    kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        rowmap, colidx, static_cast<const T*>(vals), static_cast<const T*>(invd), steps, nsteps,
        nchunks, chunk_rows, static_cast<const T*>(b), static_cast<const T*>(xin), src, dst,
        static_cast<T*>(work), static_cast<T*>(scratch), static_cast<T*>(out), state, k,
        static_cast<typename real_of<T>::type>(omega));
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
  if (dtype == 2)
    return launch<cplx<float>>(group, rowmap, colidx, vals, invd, b, x, out, start, nrows, k,
                               omega, s);
  if (dtype == 3)
    return launch<cplx<double>>(group, rowmap, colidx, vals, invd, b, x, out, start, nrows, k,
                                omega, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int tpukk_gs_sweep(int dtype, int group, const int* rowmap, const int* colidx,
                              const void* vals, const void* invd, const int* steps, int nsteps,
                              int nchunks, int chunk_rows, const void* b, const void* xin,
                              const int* src, const int* dst, void* work, void* scratch,
                              void* out, unsigned* state, int k, double omega, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_sweep<float>(group, rowmap, colidx, vals, invd, steps, nsteps, nchunks,
                               chunk_rows, b, xin, src, dst, work, scratch, out, state, k, omega, s);
  if (dtype == 1)
    return launch_sweep<double>(group, rowmap, colidx, vals, invd, steps, nsteps, nchunks,
                                chunk_rows, b, xin, src, dst, work, scratch, out, state, k, omega, s);
  if (dtype == 2)
    return launch_sweep<cplx<float>>(group, rowmap, colidx, vals, invd, steps, nsteps, nchunks,
                                     chunk_rows, b, xin, src, dst, work, scratch, out, state, k,
                                     omega, s);
  if (dtype == 3)
    return launch_sweep<cplx<double>>(group, rowmap, colidx, vals, invd, steps, nsteps, nchunks,
                                      chunk_rows, b, xin, src, dst, work, scratch, out, state, k,
                                      omega, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int tpukk_gs_sweep_dia(int dtype, int max_diags, const int* starts, int nblocks,
                                  const int* offs, const int64_t* vbase, const void* vals,
                                  const unsigned* mask, const void* invd, const int* steps,
                                  int nsteps, int nchunks, int chunk_rows, const void* b,
                                  const void* xin, const int* src, const int* dst, void* work,
                                  void* out, unsigned* state, double omega, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_sweep_dia<float>(max_diags, starts, nblocks, offs, vbase, vals, mask, invd,
                                     steps, nsteps, nchunks, chunk_rows, b, xin, src, dst, work,
                                     out, state, omega, s);
  if (dtype == 1)
    return dispatch_sweep_dia<double>(max_diags, starts, nblocks, offs, vbase, vals, mask, invd,
                                      steps, nsteps, nchunks, chunk_rows, b, xin, src, dst, work,
                                      out, state, omega, s);
  if (dtype == 2)
    return dispatch_sweep_dia<cplx<float>>(max_diags, starts, nblocks, offs, vbase, vals, mask,
                                           invd, steps, nsteps, nchunks, chunk_rows, b, xin, src,
                                           dst, work, out, state, omega, s);
  if (dtype == 3)
    return dispatch_sweep_dia<cplx<double>>(max_diags, starts, nblocks, offs, vbase, vals, mask,
                                            invd, steps, nsteps, nchunks, chunk_rows, b, xin,
                                            src, dst, work, out, state, omega, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
