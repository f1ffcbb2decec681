// Level-scheduled sparse triangular solve for Hopper (sm_90a):
// K4 sptrsv_levels<T>.
//
// Replaces the TPU kernels of tpukk/sparse/sptrsv_pallas.py, which solve the
// whole level-scheduled triangle in one launch (the TPU grid runs the levels
// in order on one core):
//   _fused_call_wide_pk (:457)  packed layout, also the supernodal DAG's
//   _fused_call_wide    (:515)  (S, 8, 128) f32 tiles, several levels a step
//   _fused_call         (:585)  deep layout, levels padded to 128 rows
//
// What it computes: the plan is the strict triangle in level order (rows
// sorted by level, columns renamed to level-order positions), so every
// dependency of row r sits at a position below r, for lower and upper
// triangles alike.  Then x[r] = (b[r] - sum_{p in row r} vals[p] * x[cols[p]])
// * invd[r], with b and x in level order.
//
// Bound on the H100: the dependency chain, not the bytes.  The least traffic
// is rowptr, cols, vals, invd, b and x once each, but a row cannot start
// before its last dependency is published, so the solve takes at least
// (number of levels) x (one publish-and-observe round trip through L2).
//
// Design (sync-free, Liu et al., Euro-Par 2016): one launch for the whole
// triangle.  A warp takes the next row from a global ticket counter
// (atomicAdd), so rows start in level order; blocks are never relied on to be
// scheduled in any order, and a warp only ever waits on rows whose tickets
// were handed out before its own, to warps that are running.  The lanes split
// the row's entries; each lane waits for its source rows' ready flags with
// acquire loads, multiplies, and the warp reduces with shuffles.  Lane 0
// writes x[r] and publishes it with a release store of the flag.  Flags hold
// the solve's epoch number, so no memset per solve is needed: the epoch, the
// ticket and an exit count live in a small device state array, and the last
// warp out resets the ticket and advances the epoch for the next launch.  The
// launch therefore needs no host-side reset and replays correctly inside a
// CUDA graph.  A plan's flags and state serve one solve at a time.  A wait
// of 2^28 polls, far more than the longest level chain needs, can only mean
// a plan that does not order the triangle: the kernel traps, so the launch
// fails with an error instead of hanging the card.
//
// C interface (bound with ctypes): returns the cudaError_t of the launch (0
// when nothing needed launching); dtype 0 = float, 1 = double.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kMaxPolls = 1u << 28;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// state[0]: next row ticket; state[1]: epoch of the last finished solve;
// state[2]: warps that have finished this solve
template <typename T>
__global__ void __launch_bounds__(kThreads)
sptrsv_levels_kernel(const int* __restrict__ rowptr, const int* __restrict__ cols,
                     const T* __restrict__ vals, const T* __restrict__ invd,
                     const T* __restrict__ b, T* x, int* flags, unsigned* state, int n) {
  const int lane = threadIdx.x & 31;
  const int epoch = ld_acquire(reinterpret_cast<const int*>(state + 1)) + 1;
  while (true) {
    int row = 0;
    if (lane == 0) row = static_cast<int>(atomicAdd(state, 1u));
    row = __shfl_sync(kFull, row, 0);
    if (row >= n) break;
    T acc = T(0);
    const int end = __ldg(rowptr + row + 1);
    for (int p = __ldg(rowptr + row) + lane; p < end; p += 32) {
      const int c = __ldg(cols + p);
      for (unsigned polls = 0; ld_acquire(flags + c) != epoch;) {
        if (++polls == kMaxPolls) __trap();
      }
      acc += __ldg(vals + p) * __ldcg(x + c);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) {
      __stcg(x + row, (__ldg(b + row) - acc) * __ldg(invd + row));
      st_release(flags + row, epoch);
    }
  }
  // the last warp out resets the ticket and publishes the epoch for the next
  // launch; every warp read the epoch before it counted itself out
  if (lane == 0) {
    __threadfence();
    const unsigned warps = gridDim.x * (blockDim.x / 32);
    if (atomicAdd(state + 2, 1u) == warps - 1) {
      atomicExch(state, 0u);
      atomicExch(state + 2, 0u);
      atomicExch(state + 1, static_cast<unsigned>(epoch));
    }
  }
}

template <typename T>
int launch(const int* rowptr, const int* cols, const void* vals, const void* invd,
           const void* b, void* x, int* flags, unsigned* state, int n, int blocks,
           cudaStream_t stream) {
  if (n == 0) return 0;
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  sptrsv_levels_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      rowptr, cols, static_cast<const T*>(vals), static_cast<const T*>(invd),
      static_cast<const T*>(b), static_cast<T*>(x), flags, state, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tpukk_sptrsv_levels(int dtype, const int* rowptr, const int* cols,
                                   const void* vals, const void* invd, const void* b, void* x,
                                   int* flags, unsigned* state, int n, int blocks,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(rowptr, cols, vals, invd, b, x, flags, state, n, blocks, s);
  if (dtype == 1) return launch<double>(rowptr, cols, vals, invd, b, x, flags, state, n, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
