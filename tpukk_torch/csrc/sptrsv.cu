// Level-scheduled sparse triangular solve for Hopper (sm_90a):
// K4 sptrsv_levels<T>.
//
// Replaces the TPU kernels of tpukk/sparse/sptrsv_pallas.py, which solve the
// whole level-scheduled triangle in one launch (the TPU grid runs the levels
// in order on one core), and the two permutation phases that
// fused_sptrsv_solve runs around them (tpukk/common/permute.py):
//   _fused_call_wide_pk (:457)  packed layout, also the supernodal DAG's
//   _fused_call_wide    (:515)  (S, 8, 128) f32 tiles, several levels a step
//   _fused_call         (:585)  deep layout, levels padded to 128 rows
//
// What it computes: the plan is the strict triangle in level order (rows
// sorted by level, columns renamed to level-order positions), so every
// dependency of row r sits at a position below r, for lower and upper
// triangles alike.  Then x[r] = (b_l[r] - sum_{p in row r} vals[p] * x[cols[p]])
// * invd[r].  The level permutations are folded in: row r reads
// b_l[r] = b[src[r]] (0 where src[r] < 0, the supernodal DAG's zero slot) and
// writes x[r] to out[dst[r]] where dst[r] >= 0; a null src or dst is the
// identity.
//
// Bound on the H100: the dependency chain, not the bytes.  The least traffic
// is rowptr, cols, vals, invd, b and x once each, but a row cannot start
// before its last dependency is published, so the solve takes at least
// (number of levels) x (one publish-and-observe round trip through L2).
//
// Design (sync-free, Liu et al., Euro-Par 2016): one launch for the whole
// triangle.  Rows go to G-lane groups of a warp (G = 32, or 16 on plans whose
// levels average a thousand rows or more): a warp takes 32/G consecutive
// rows from one global ticket counter (atomicAdd) and solves them side by
// side, so rows start in level order and one atomic serves 32/G rows
// (same-address atomics serialise in L2, about a nanosecond each, which on
// wide levels makes one ticket a row the bound).  Blocks are never relied on
// to be scheduled in any order: a group only ever waits on smaller rows,
// whose tickets were handed out before its own, to warps that are running
// (the smallest unfinished row's warp has finished its earlier rows, so it is
// working on it; groups of one warp that wait on each other progress
// independently).  A group's lanes split the row's entries (lane-strided
// partial sums, then an xor-shuffle reduction whose steps stop where the
// partner lanes hold no entry: on rows of one or two entries that is most of
// a level's latency).  What keeps the chain at one L2 round trip per level:
// * The value travels in its ready word.  A row publishes x with relaxed
//   gpu-scope stores of (epoch << 32 | bits): one 64-bit word for f32; for
//   f64 the pair (epoch, hi32), (epoch, lo32) as one 16-byte access, each
//   word tagged, so no 128-bit atomicity is assumed (a poll that sees one new
//   word and one old polls again).  A 64-bit access is single-copy atomic, so
//   a relaxed load that sees the epoch also sees the value: no release fence
//   behind the value's store, no acquire, no second load of x.
// * Everything a row reads that no other row writes (rowptr, cols, vals, src,
//   b, invd, dst) is loaded before its first poll, and the warp's next ticket
//   is taken while its rows wait.
// Words hold the solve's epoch number, so no memset per solve is needed: the
// epoch, the ticket and an exit count live in a small device state array, and
// the last warp out resets the ticket and advances the epoch for the next
// launch.  The launch therefore needs no host-side reset and replays
// correctly inside a CUDA graph.  A plan's words and state serve one solve at
// a time.  A wait of 2^28 polls, far more than the longest level chain needs,
// can only mean a plan that does not order the triangle: the kernel traps, so
// the launch fails with an error instead of hanging the card.
//
// Complex values (complex64, complex128: T = cplx<float>, cplx<double>,
// cplx.cuh) run the same kernel; a value then travels in two or four tagged
// words (Word<cplx<...>> below), and the plan's words buffer holds kWords a
// row (sptrsv_cuda.words_per_value).
//
// C interface (bound with ctypes): returns the cudaError_t of the launch (0
// when nothing needed launching); dtype 0 = float, 1 = double, 2 = complex64,
// 3 = complex128; lanes (G) 16 or 32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cplx.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kMaxPolls = 1u << 28;
typedef unsigned long long u64;

// no "memory" clobber: loads of read-only data may move ahead of a poll
__device__ __forceinline__ u64 ld_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_relaxed(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v));
}

// two 64-bit words in one 16-byte access (p 16-byte aligned); each word is
// single-copy atomic, the pair is not assumed to be
__device__ __forceinline__ void ld_relaxed2(const u64* p, u64& a, u64& b) {
  asm volatile("ld.relaxed.gpu.global.v2.b64 {%0, %1}, [%2];" : "=l"(a), "=l"(b) : "l"(p));
}

__device__ __forceinline__ void st_relaxed2(u64* p, u64 a, u64 b) {
  asm volatile("st.relaxed.gpu.global.v2.b64 [%0], {%1, %2};" ::"l"(p), "l"(a), "l"(b));
}

__device__ __forceinline__ u64 tag(unsigned epoch, unsigned bits) {
  return (static_cast<u64>(epoch) << 32) | bits;
}

__device__ __forceinline__ bool tagged(u64 w, unsigned epoch) {
  return static_cast<unsigned>(w >> 32) == epoch;
}

// the publication words of row r: f32 words[r], f64 words[2r] (hi), [2r+1]
// (lo), complex64 words[2r] (re), [2r+1] (im), complex128 words[4r ..
// 4r+3] (re hi, re lo, im hi, im lo): kWords a value
template <typename T>
struct Word;

template <>
struct Word<float> {
  static constexpr int kWords = 1;
  __device__ static bool read(const u64* w, int c, unsigned epoch, float& x) {
    const u64 a = ld_relaxed(w + kWords * static_cast<size_t>(c));
    x = __uint_as_float(static_cast<unsigned>(a));
    return tagged(a, epoch);
  }
  __device__ static void publish(u64* w, int r, unsigned epoch, float x) {
    st_relaxed(w + kWords * static_cast<size_t>(r), tag(epoch, __float_as_uint(x)));
  }
};

template <>
struct Word<double> {
  static constexpr int kWords = 2;
  __device__ static bool read(const u64* w, int c, unsigned epoch, double& x) {
    u64 hi, lo;
    ld_relaxed2(w + kWords * static_cast<size_t>(c), hi, lo);
    x = __hiloint2double(static_cast<int>(hi), static_cast<int>(lo));
    return tagged(hi, epoch) && tagged(lo, epoch);
  }
  __device__ static void publish(u64* w, int r, unsigned epoch, double x) {
    st_relaxed2(w + kWords * static_cast<size_t>(r), tag(epoch, __double2hiint(x)),
                tag(epoch, __double2loint(x)));
  }
};

// complex64 takes f64's layout: (epoch, re) and (epoch, im) in one 16-byte
// access
template <>
struct Word<cplx<float>> {
  static constexpr int kWords = 2;
  __device__ static bool read(const u64* w, int c, unsigned epoch, cplx<float>& x) {
    u64 re, im;
    ld_relaxed2(w + kWords * static_cast<size_t>(c), re, im);
    x = {__uint_as_float(static_cast<unsigned>(re)), __uint_as_float(static_cast<unsigned>(im))};
    return tagged(re, epoch) && tagged(im, epoch);
  }
  __device__ static void publish(u64* w, int r, unsigned epoch, cplx<float> x) {
    st_relaxed2(w + kWords * static_cast<size_t>(r), tag(epoch, __float_as_uint(x.re)),
                tag(epoch, __float_as_uint(x.im)));
  }
};

// complex128: four tagged words in two 16-byte accesses; the value counts
// only when all four carry the epoch (each 64-bit word is single-copy atomic,
// a 16-byte access is not assumed to be, so the tags carry the correctness)
template <>
struct Word<cplx<double>> {
  static constexpr int kWords = 4;
  __device__ static bool read(const u64* w, int c, unsigned epoch, cplx<double>& x) {
    u64 rh, rl, ih, il;
    const u64* p = w + kWords * static_cast<size_t>(c);
    ld_relaxed2(p, rh, rl);
    ld_relaxed2(p + 2, ih, il);
    x = {__hiloint2double(static_cast<int>(rh), static_cast<int>(rl)),
         __hiloint2double(static_cast<int>(ih), static_cast<int>(il))};
    return tagged(rh, epoch) && tagged(rl, epoch) && tagged(ih, epoch) && tagged(il, epoch);
  }
  __device__ static void publish(u64* w, int r, unsigned epoch, cplx<double> x) {
    u64* p = w + kWords * static_cast<size_t>(r);
    st_relaxed2(p, tag(epoch, __double2hiint(x.re)), tag(epoch, __double2loint(x.re)));
    st_relaxed2(p + 2, tag(epoch, __double2hiint(x.im)), tag(epoch, __double2loint(x.im)));
  }
};

template <typename T>
__device__ __forceinline__ T wait_value(const u64* words, int c, unsigned epoch) {
  T x;
  for (unsigned polls = 0; !Word<T>::read(words, c, epoch, x);) {
    if (++polls == kMaxPolls) __trap();
  }
  return x;
}

// state[0]: next row ticket; state[1]: epoch of the last finished solve;
// state[2]: warps that have finished this solve
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
sptrsv_levels_kernel(const int* __restrict__ rowptr, const int* __restrict__ cols,
                     const T* __restrict__ vals, const T* __restrict__ invd,
                     const T* __restrict__ b, const int* __restrict__ src,
                     const int* __restrict__ dst, T* __restrict__ out, u64* words,
                     unsigned* state, int n) {
  constexpr int kRows = 32 / G;  // rows a warp solves side by side
  const int lane = threadIdx.x & 31, sub = lane % G, slot = lane / G;
  const unsigned group = G == 32 ? kFull : ((1u << G) - 1) << (slot * G);
  const unsigned epoch = __ldcg(state + 1) + 1;
  unsigned ticket = 0;
  if (lane == 0) ticket = atomicAdd(state, static_cast<unsigned>(kRows));
  int base = static_cast<int>(__shfl_sync(kFull, ticket, 0));
  while (base < n) {
    const int row = base + slot;
    int beg = 0, end = 0, to = -1, p = 0, c = 0;
    T bv = T(0), dinv = T(0), v = T(0);
    if (row < n) {
      beg = __ldg(rowptr + row);
      end = __ldg(rowptr + row + 1);
      if (sub == 0) {
        const int s = src ? __ldg(src + row) : row;
        if (s >= 0) bv = ldg(b + s);
        dinv = ldg(invd + row);
        to = dst ? __ldg(dst + row) : row;
      }
      p = beg + sub;
      if (p < end) {
        c = __ldg(cols + p);
        v = ldg(vals + p);
      }
    }
    // the next rows, in flight while these wait
    if (lane == 0) ticket = atomicAdd(state, static_cast<unsigned>(kRows));
    if (row < n) {
      T acc = T(0);
      while (p < end) {
        const int pn = p + G;
        int cn = 0;
        T vn = T(0);
        if (pn < end) {
          cn = __ldg(cols + pn);
          vn = ldg(vals + pn);
        }
        acc += v * wait_value<T>(words, c, epoch);
        p = pn;
        c = cn;
        v = vn;
      }
      // lanes at or past the row's length hold 0: the steps that would add
      // only those are left out, which changes no bit of the group's sum
      const int span = end - beg;
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        if (off < span) acc += shfl_xor(group, acc, off, G);
      if (sub == 0) {
        const T x = (bv - acc) * dinv;
        Word<T>::publish(words, row, epoch, x);
        if (to >= 0) out[to] = x;
      }
    }
    base = static_cast<int>(__shfl_sync(kFull, ticket, 0));
  }
  // the last warp out resets the ticket and publishes the epoch for the next
  // launch; every warp read the epoch before it counted itself out
  if (lane == 0) {
    __threadfence();
    const unsigned warps = gridDim.x * (blockDim.x / 32);
    if (atomicAdd(state + 2, 1u) == warps - 1) {
      atomicExch(state, 0u);
      atomicExch(state + 2, 0u);
      atomicExch(state + 1, epoch);
    }
  }
}

template <typename T, int G>
int launch(const int* rowptr, const int* cols, const void* vals, const void* invd,
           const void* b, const int* src, const int* dst, void* out, void* words,
           unsigned* state, int n, int blocks, cudaStream_t stream) {
  sptrsv_levels_kernel<T, G><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      rowptr, cols, static_cast<const T*>(vals), static_cast<const T*>(invd),
      static_cast<const T*>(b), src, dst, static_cast<T*>(out), static_cast<u64*>(words),
      state, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_lanes(int lanes, const int* rowptr, const int* cols, const void* vals,
                 const void* invd, const void* b, const int* src, const int* dst, void* out,
                 void* words, unsigned* state, int n, int blocks, cudaStream_t s) {
  if (n == 0) return 0;
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (lanes) {
    case 16:
      return launch<T, 16>(rowptr, cols, vals, invd, b, src, dst, out, words, state, n, blocks,
                           s);
    case 32:
      return launch<T, 32>(rowptr, cols, vals, invd, b, src, dst, out, words, state, n, blocks,
                           s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int tpukk_sptrsv_levels(int dtype, int lanes, const int* rowptr, const int* cols,
                                   const void* vals, const void* invd, const void* b,
                                   const int* src, const int* dst, void* out, void* words,
                                   unsigned* state, int n, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_lanes<float>(lanes, rowptr, cols, vals, invd, b, src, dst, out, words, state, n,
                               blocks, s);
  if (dtype == 1)
    return launch_lanes<double>(lanes, rowptr, cols, vals, invd, b, src, dst, out, words, state,
                                n, blocks, s);
  if (dtype == 2)
    return launch_lanes<cplx<float>>(lanes, rowptr, cols, vals, invd, b, src, dst, out, words,
                                     state, n, blocks, s);
  if (dtype == 3)
    return launch_lanes<cplx<double>>(lanes, rowptr, cols, vals, invd, b, src, dst, out, words,
                                      state, n, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
