// Colored Gauss-Seidel for Hopper (sm_90a): K6, two entries.
//
// Replaces the TPU kernel _gi4_gs_fused_batched (tpukk/sparse/spmv_pallas.py
// :2125, name "tpukk_gs_gi4_fused"), the color step that tpukk's distributed
// sweep runs (tpukk/dist/gauss_seidel.py:464) and that the single-chip sweep
// (tpukk/sparse/gauss_seidel.py:266-287) runs once per color, each a launch.
//
// The relaxation, the same in both entries, for a row r of the color-permuted
// system (x and b row-major (n, k), k = 1 for a vector) and each column j < k:
//   ax          = sum_{p in row r} vals[p] * x[colidx[p], j]
//   x'[r, j]    = (1 - omega) * x[r, j] + omega * invd[r] * (b[r, j] - ax)
// The CSR holds only off-diagonal entries, with columns in the permuted
// space; invd is 1/diag, 0 where the diagonal is 0.  f32, f64, complex64 and
// complex128 (T = cplx<float>, cplx<double>, cplx.cuh): in complex values
// omega stays real, invd is the complex 1/diag, and every product and sum is
// rounded on its own (the panel's madd, gs_relax below).  A value never
// travels in a sync word (the chunk counters are released after the work
// buffer is written), so complex128's 16-byte values need no tagged words.  Both entries sum ax with
// the row panel of csr_panel.cuh (K3's vector CSR, a group of G lanes per
// row, a register panel of k accumulators, one fma a product) and finish
// with gs_relax, so at one G they give the same bits.
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
//   finish: the kernel traps instead of hanging the card.
//
// C interface (bound with ctypes): returns the cudaError_t of the launch
// (0 when nothing needed launching); dtype 0 = float, 1 = double,
// 2 = complex64, 3 = complex128; 1 <= k <= 16.

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

// ---- gs_sweep --------------------------------------------------------------

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

// state[0]: next chunk ticket; state[kLine]: blocks that have finished the
// launch; state[(2 + s) * kLine]: chunks of step s that have finished
template <typename T, int G, int KMAX, typename R = typename real_of<T>::type>
__global__ void __launch_bounds__(kThreads)
gs_sweep_kernel(const int* __restrict__ rowmap, const int* __restrict__ colidx,
                const T* __restrict__ vals, const T* __restrict__ invd,
                const int* __restrict__ steps, int nsteps, int nchunks, int chunk_rows,
                const T* __restrict__ b, const T* __restrict__ xin, const int* __restrict__ src,
                const int* __restrict__ dst, T* work, T* scratch, T* __restrict__ out,
                unsigned* state, int k, R omega) {
  constexpr int kRows = kThreads / G;  // rows a block relaxes side by side
  const int tid = static_cast<int>(threadIdx.x), lane = tid % G;
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
    const int begin = __ldg(d + kBegin), mode = __ldg(d + kMode);
    const int r0 = begin + (t - __ldg(d + kChunk0)) * chunk_rows;
    const int r1 = min(__ldg(d + kEnd), r0 + chunk_rows);
    const bool final = __ldg(d + kFinal) != 0 && out != nullptr;
    const int zlo = __ldg(d + kZeroLo), zhi = __ldg(d + kZeroHi);
    const unsigned wait = static_cast<unsigned>(__ldg(d + kWait));
    const bool relax = mode == kInPlace || mode == kToScratch;
    RowAhead<T, KMAX> a;
    if (relax)
      load_ahead<T, G, KMAX>(a, rowmap, colidx, vals, invd, b, src, dst, r0 + tid / G,
                             r0 + tid / G < r1, lane, k, omega);
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
    if (relax) {
      for (int base = r0; base < r1; base += kRows) {
        const int row = base + tid / G;
        const bool valid = row < r1;
        if (base != r0)
          load_ahead<T, G, KMAX>(a, rowmap, colidx, vals, invd, b, src, dst, row, valid, lane,
                                 k, omega);
        T acc[KMAX];
#pragma unroll
        for (int j = 0; j < KMAX; ++j) acc[j] = T(0);
        if (a.p < a.end) {
          panel_add<T, KMAX>(work, a.c0, a.v0, k, a.c0 >= zlo && a.c0 < zhi, acc);
          if (a.p + G < a.end) {
            panel_add<T, KMAX>(work, a.c1, a.v1, k, a.c1 >= zlo && a.c1 < zhi, acc);
            for (int p = a.p + 2 * G; p < a.end; p += G) {
              const int c = __ldg(colidx + p);
              panel_add<T, KMAX>(work, c, ldg(vals + p), k, c >= zlo && c < zhi, acc);
            }
          }
        }
        panel_reduce<T, G, KMAX>(k, acc);
        if (valid) {
          const bool unwritten = row >= zlo && row < zhi;
          const int64_t g = static_cast<int64_t>(row) * k;
          T* o = mode == kInPlace ? work + g : scratch + static_cast<int64_t>(row - begin) * k;
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
      const int count = (r1 - r0) * k;
      for (int e = tid; e < count; e += kThreads) {
        const int r = r0 + e / k, j = e % k;
        const int64_t g = static_cast<int64_t>(r) * k + j;
        if (mode == kGather) {
          work[g] = ldg(xin + static_cast<int64_t>(src ? __ldg(src + r) : r) * k + j);
        } else {
          const T x = scratch[static_cast<int64_t>(r - begin) * k + j];
          work[g] = x;
          if (final) out[static_cast<int64_t>(dst ? __ldg(dst + r) : r) * k + j] = x;
        }
      }
    }
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
