// Variants of K3 (tpukk_torch/csrc/csr.cu's csr_spmv) for
// scripts/k3_sweep_torch.py, built by that script and by nothing in the
// package: K3's two modes (direct, stream) at either tile cap, and the ring of
// asynchronous copies into shared memory that K3's Hopper design began with
// and that lost to direct loads on every shape swept (PERF.md §6, K3).
//
// The ring ("bulk"): a persistent grid of the blocks that fit walks the
// tiles; while a block sums tile i, one thread has issued tile i+1's rowmap,
// colidx and vals windows into the other of two shared-memory stages with
// cp.async.bulk, counted in bytes on the stage's mbarrier ("cp.async": the
// same ring filled 16 bytes a thread).  A bulk copy moves whole 16 bytes, so
// each window is the range rounded out to 16 bytes and read at an offset,
// stopped at the array's last whole 16 bytes, past which the few elements
// come from global memory; the arrays must start on 16 bytes (the script
// copies them where they do not).  Parity across the ring: a bit a stage,
// flipped on each wait, so that a long row's skipped stage keeps its phase.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o build/k3_variants/libk3_variants.so scripts/k3_variants.cu
//
// C interface: k3_variant_spmv returns the launch's cudaError_t; dtype 0 =
// float, 1 = double; reduce 0 = sum, 1 = max; copy 0 = bulk, 1 = cp.async,
// 2 = direct, 3 = stream; tile_entries 512 or 1024 (256 · E).

#include "../tpukk_torch/csrc/csr.cu"

namespace {

constexpr int kBulk = 0, kCpAsync = 1, kDirect = 2, kStream = 3;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// the one arrival of the stage's phase, and the bytes its copies will bring
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// Elements [lo, hi) of an array of len elements of 16 / Q bytes, the range
// [first, first + count) rounded out to 16 bytes and stopped at the last
// whole 16 bytes of the array: element first + j sits at off + j of the
// window when first + j < hi, and is read from global memory otherwise.
struct Window {
  int lo, off, hi;
};

template <int Q>
__device__ __forceinline__ Window window(int first, int count, int len) {
  const int lo = first & ~(Q - 1);
  const int hi = min((first + count + Q - 1) & ~(Q - 1), len & ~(Q - 1));
  return {lo, first - lo, max(hi, lo)};
}

// Shared memory, in bytes: two stages of (colidx, vals, rowmap) windows, then
// the tile's products, its row starts, the warps' partial results and the
// stages' mbarriers.
template <typename T, int E>
struct RingSmem {
  static constexpr int kCap = kThreads * E;
  static constexpr int kCol = (kCap + 8) * 4;
  static constexpr int kVal = (kCap + 8) * static_cast<int>(sizeof(T));
  static constexpr int kRow = (kTileRows + 8) * 4;
  static constexpr int kStage = kCol + kVal + kRow;
  static constexpr int kProd = 2 * kStage;
  static constexpr int kStarts = kProd + kCap * static_cast<int>(sizeof(T));
  static constexpr int kPart = kStarts + (kTileRows + 8) * 4;
  static constexpr int kBar = kPart + 32 * static_cast<int>(sizeof(T));
  static constexpr int kBytes = kBar + 16;
};

// A tile's entries and row starts from the stage the ring copied them into,
// with whatever lies past the stage's windows from global memory.
template <typename T>
struct RingTile {
  const int* __restrict__ rowmap;
  const int* __restrict__ colidx;
  const T* __restrict__ vals;
  const int* sc;
  const T* sv;
  const int* sr;
  Window wc, wv, wr;

  __device__ __forceinline__ int col(const int4& t, int j) const {
    const int e = t.z + j;
    return e < wc.hi ? sc[wc.off + j] : __ldg(colidx + e);
  }
  __device__ __forceinline__ T val(const int4& t, int j) const {
    const int e = t.z + j;
    return e < wv.hi ? sv[wv.off + j] : __ldg(vals + e);
  }
  __device__ __forceinline__ int start(const int4& t, int q) const {
    const int r = t.x + q;
    return r < wr.hi ? sr[wr.off + q] : __ldg(rowmap + r);
  }
};

// The ring: tiles blockIdx.x, + gridDim.x, ..., the record of the tile after
// the next loaded a tile ahead of its use.
template <typename T, int E, bool kMax, int kCopy, bool kLong>
__global__ void __launch_bounds__(kThreads)
ring_spmv_kernel(const int4* __restrict__ tiles, int ntiles, const int* __restrict__ rowmap,
                 const int* __restrict__ colidx, const T* __restrict__ vals,
                 const T* __restrict__ x, T* __restrict__ y, int nrows, int nnz) {
  using S = RingSmem<T, E>;
  constexpr int kCap = S::kCap;
  constexpr int QV = 16 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(128) unsigned char smem[];
  T* prod = reinterpret_cast<T*>(smem + S::kProd);
  int* starts = reinterpret_cast<int*>(smem + S::kStarts);
  T* part = reinterpret_cast<T*>(smem + S::kPart);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S::kBar);
  const int tid = threadIdx.x;
  const int stride = static_cast<int>(gridDim.x);

  int tile = blockIdx.x;
  int4 t = checked_tile<kCap, kLong>(tiles[tile]);
  int4 ahead = tile + stride < ntiles ? tiles[tile + stride] : int4{0, 0, 0, 0};

  auto stage = [&](int s) { return smem + s * S::kStage; };
  auto wcol = [&](const int4& u) { return window<4>(u.z, u.w, nnz); };
  auto wval = [&](const int4& u) { return window<QV>(u.z, u.w, nnz); };
  auto wrow = [&](const int4& u) { return window<4>(u.x, u.y + 1, nrows + 1); };
  // copy tile u's windows into stage s: one thread and an mbarrier (bulk), or
  // every thread 16 bytes at a time (cp.async; the caller commits)
  auto issue = [&](const int4& u, int s) {
    const Window wc = wcol(u), wv = wval(u), wr = wrow(u);
    const uint32_t bc = (wc.hi - wc.lo) * 4u, bv = (wv.hi - wv.lo) * sizeof(T),
                   br = (wr.hi - wr.lo) * 4u;
    unsigned char* dst = stage(s);
    if (kCopy == kBulk) {
      if (tid == 0) {
        mbar_expect(bar + s, bc + bv + br);
        if (bc) bulk_load(dst, colidx + wc.lo, bc, bar + s);
        if (bv) bulk_load(dst + S::kCol, vals + wv.lo, bv, bar + s);
        if (br) bulk_load(dst + S::kCol + S::kVal, rowmap + wr.lo, br, bar + s);
      }
    } else {
      const char* gc = reinterpret_cast<const char*>(colidx + wc.lo);
      const char* gv = reinterpret_cast<const char*>(vals + wv.lo);
      const char* gr = reinterpret_cast<const char*>(rowmap + wr.lo);
      for (uint32_t q = tid * 16u; q < bc; q += kThreads * 16u) cp_async16(dst + q, gc + q);
      for (uint32_t q = tid * 16u; q < bv; q += kThreads * 16u)
        cp_async16(dst + S::kCol + q, gv + q);
      for (uint32_t q = tid * 16u; q < br; q += kThreads * 16u)
        cp_async16(dst + S::kCol + S::kVal + q, gr + q);
    }
  };

  // thread 0 sets the barriers up and issues the first copy before the
  // block's first sync, after which the others may wait on the barriers
  if (kCopy == kBulk && tid == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!kLong || t.w <= kCap) issue(t, 0);
  if (kCopy == kCpAsync) asm volatile("cp.async.commit_group;\n" ::: "memory");
  __syncthreads();
  uint32_t phase = 0;  // bit s: the parity of stage s's next phase
  for (int i = 0;; ++i) {
    const int s = i & 1;
    const int next = tile + stride;
    int4 u = int4{0, 0, 0, 0};
    if (next < ntiles) {
      u = checked_tile<kCap, kLong>(ahead);
      if (next + stride < ntiles) ahead = tiles[next + stride];
      if (!kLong || u.w <= kCap) issue(u, s ^ 1);
    }
    if (kCopy == kCpAsync) {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncthreads();
    }
    if (kLong && t.w > kCap) {
      long_row<T, E, kMax>(t, colidx, vals, x, y, part);
    } else {
      if (kCopy == kBulk) {
        mbar_wait(bar + s, (phase >> s) & 1u);
        phase ^= 1u << s;
      }
      const unsigned char* st = stage(s);
      const RingTile<T> src{rowmap,
                            colidx,
                            vals,
                            reinterpret_cast<const int*>(st),
                            reinterpret_cast<const T*>(st + S::kCol),
                            reinterpret_cast<const int*>(st + S::kCol + S::kVal),
                            wcol(t),
                            wval(t),
                            wrow(t)};
      tile_sums<T, E, kMax>(t, src, x, y, prod, starts);
    }
    if (next >= ntiles) return;
    tile = next;
    t = u;
    __syncthreads();  // the stage, prod and starts are free again
  }
}

template <typename T, int E, bool kMax, int kCopy, bool kLong>
int launch_variant(const int4* tiles, int ntiles, const int* rowmap, const int* colidx,
                   const void* vals, const void* x, void* y, int nrows, int nnz,
                   cudaStream_t stream) {
  if (kCopy == kDirect || kCopy == kStream)
    return launch_tiles<T, E, kMax, kCopy == kStream, kLong>(tiles, ntiles, rowmap, colidx, vals,
                                                             x, y, stream);
  static std::atomic<int> cache[kMaxDevices];
  auto kernel = ring_spmv_kernel<T, E, kMax, kCopy, kLong>;
  constexpr int bytes = RingSmem<T, E>::kBytes;
  int device = 0, sms = 0;
  const int resident = prefer_l1(kernel, bytes, cache);
  if (resident <= 0 || cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(min(ntiles, resident * sms)), kThreads, bytes, stream>>>(
      tiles, ntiles, rowmap, colidx, static_cast<const T*>(vals), static_cast<const T*>(x),
      static_cast<T*>(y), nrows, nnz);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kMax, int kCopy>
int by_cap(int tile_entries, int long_rows, const int4* t, int ntiles, const int* rowmap,
           const int* colidx, const void* vals, const void* x, void* y, int nrows, int nnz,
           cudaStream_t s) {
  if (tile_entries == 512 && long_rows)
    return launch_variant<T, 2, kMax, kCopy, true>(t, ntiles, rowmap, colidx, vals, x, y, nrows,
                                                   nnz, s);
  if (tile_entries == 512)
    return launch_variant<T, 2, kMax, kCopy, false>(t, ntiles, rowmap, colidx, vals, x, y, nrows,
                                                    nnz, s);
  if (tile_entries == 1024 && long_rows)
    return launch_variant<T, 4, kMax, kCopy, true>(t, ntiles, rowmap, colidx, vals, x, y, nrows,
                                                   nnz, s);
  if (tile_entries == 1024)
    return launch_variant<T, 4, kMax, kCopy, false>(t, ntiles, rowmap, colidx, vals, x, y, nrows,
                                                    nnz, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, bool kMax>
int by_copy(int copy, int tile_entries, int long_rows, const int4* t, int ntiles,
            const int* rowmap, const int* colidx, const void* vals, const void* x, void* y,
            int nrows, int nnz, cudaStream_t s) {
  if (ntiles == 0) return 0;
  if (nnz < 0 || nnz > 0x7fffffc0) return static_cast<int>(cudaErrorInvalidValue);
  switch (copy) {
    case kBulk:
      return by_cap<T, kMax, kBulk>(tile_entries, long_rows, t, ntiles, rowmap, colidx, vals, x,
                                    y, nrows, nnz, s);
    case kCpAsync:
      return by_cap<T, kMax, kCpAsync>(tile_entries, long_rows, t, ntiles, rowmap, colidx, vals,
                                       x, y, nrows, nnz, s);
    case kDirect:
      return by_cap<T, kMax, kDirect>(tile_entries, long_rows, t, ntiles, rowmap, colidx, vals,
                                      x, y, nrows, nnz, s);
    case kStream:
      return by_cap<T, kMax, kStream>(tile_entries, long_rows, t, ntiles, rowmap, colidx, vals,
                                      x, y, nrows, nnz, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int k3_variant_spmv(int dtype, int reduce, int copy, int tile_entries, int long_rows,
                               const void* tiles, int ntiles, const int* rowmap,
                               const int* colidx, const void* vals, const void* x, void* y,
                               int nrows, int nnz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* t = static_cast<const int4*>(tiles);
  if (dtype == 0 && reduce == 0)
    return by_copy<float, false>(copy, tile_entries, long_rows, t, ntiles, rowmap, colidx, vals,
                                 x, y, nrows, nnz, s);
  if (dtype == 0 && reduce == 1)
    return by_copy<float, true>(copy, tile_entries, long_rows, t, ntiles, rowmap, colidx, vals, x,
                                y, nrows, nnz, s);
  if (dtype == 1 && reduce == 0)
    return by_copy<double, false>(copy, tile_entries, long_rows, t, ntiles, rowmap, colidx, vals,
                                  x, y, nrows, nnz, s);
  if (dtype == 1 && reduce == 1)
    return by_copy<double, true>(copy, tile_entries, long_rows, t, ntiles, rowmap, colidx, vals,
                                 x, y, nrows, nnz, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
