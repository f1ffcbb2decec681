// Static permutation for Hopper (sm_90a): K5 permute_gather.
//
// Replaces the TPU kernels of the routed static permutation
// (tpukk/common/permute.py): _rowperm3_call (:91) and _rowperm_call (:144),
// each one phase of a three-phase Benes/Slepian-Duguid network that exists
// because Mosaic has no fast dynamic gather across a whole vector.  No
// routing tables: the H100 gathers from device memory directly, so the host
// router is not carried.
//
// What it computes: out[i, :] = x[src[i], :] for i < n, with x and out
// row-major (n, k) (k = 1 for a vector) and src an int32 index vector (a
// permutation wherever the port uses it: the level-scheduled triangular
// solve's unfolded permutations, the RCM SpMV route and RCM-permuted GMRES,
// the ILU(k) refresh's value permutations).  A gather copies values, so the
// result is index_select's bit for bit.
//
// Bound on the H100: bytes.  It reads src (4 B a row) and x (k values a row)
// and writes out once.  src and out are streams; the x reads are a gather
// whose locality is the permutation's.  At k = 1 a random gather of one 4-
// or 8-byte value pulls a whole 32-byte sector, so a random permutation of
// 1M f32 values moves about 32 MB of x's sectors where the byte bound counts
// 4 MB (3.58 µs): the "sectors" bound in PERF.md counts those sectors at
// 32 B over the device-memory rate (11.9 µs).  With x L2-resident, what
// holds it is the SMs' rate of random sectors from L2: 1M of them take
// about 9.5 µs in every design tried (PERF.md, K5), one value a thread
// or 16 bytes.  At k > 1 a row is contiguous, so the bound is the bytes.
//
// Design against that bound:
//   k = 1 (permute_vec_kernel<T, V>): a thread owns V consecutive outputs.
//   It loads their V src entries with one V-vector load and issues its V
//   gathers of x before any use (V independent loads in flight), then
//   writes the V outputs with one V-vector store.  src and x go through
//   the read-only path (__ldg), where a permutation's locality finds x; the
//   evict-first hint on src and out measured 1-3 % slower here and 4 %
//   faster at k > 1, so only the row gather carries it.  The wrapper
//   (common/permute.py, permute_geometry) takes V = 16 bytes of out (4 f32,
//   2 f64) only where
//   src and out lie on that boundary and the n / V threads fill half the
//   card's resident threads: below that (the paths' 30,000-row
//   permutations) fewer threads leave SMs idle and one value a thread is
//   faster.  The last n % V outputs go through a scalar step of the kernel.
//   k > 1 (permute_rows_kernel<C, L>): a group of L lanes owns an output
//   row and copies x[src[i], :] to out[i, :] in chunks C of 16 bytes (8 or
//   4 where the row's bytes or x's or out's alignment forbid 16), lane j
//   taking chunks j, j + L, ...: no division per element, one src load a
//   row, every access a vector, two rows a group in flight each trip; src
//   and out streamed with the evict-first hint (__ldcs, __stcs), so that
//   they take no lines from x's rows.  The chunks are copied as raw bits, so
//   the kernel is dtype-free.
// Both run one wave of blocks (the SMs times the blocks that fit on one,
// queried once a device) or fewer, in a grid-stride loop.
//
// C interface (bound with ctypes): returns the cudaError_t of the launch (0
// when nothing needed launching); dtype 0 = float, 1 = double; vec = values
// a vector access moves, lanes = lanes a row (1 for k = 1).

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
// rows a lane group takes each trip of the k > 1 loop (all loads issued
// before any store)
constexpr int kRows = 2;

template <int V> struct IdxVec;
template <> struct IdxVec<4> { using type = int4; };
template <> struct IdxVec<2> { using type = int2; };
template <> struct IdxVec<1> { using type = int; };
template <typename T, int V> struct ValVec;
template <> struct ValVec<float, 4> { using type = float4; };
template <> struct ValVec<float, 2> { using type = float2; };
template <> struct ValVec<float, 1> { using type = float; };
template <> struct ValVec<double, 2> { using type = double2; };
template <> struct ValVec<double, 1> { using type = double; };
template <int B> struct Chunk;
template <> struct Chunk<16> { using type = uint4; };
template <> struct Chunk<8> { using type = uint2; };
template <> struct Chunk<4> { using type = unsigned int; };

template <typename T>
__device__ __forceinline__ T gather(const T* p) {
  return __ldg(p);
}

// A row gather's src and out are streams, each touched once: loaded and
// stored with the evict-first hint, so that neither takes the L1 or L2 lines
// x's row reads hit (at k = 1 the hint measured slower: PERF.md, K5)
template <typename S>
__device__ __forceinline__ S stream_load(const S* p) {
  return __ldcs(p);
}
template <typename O>
__device__ __forceinline__ void stream_store(O* p, const O& v) {
  __stcs(p, v);
}

// A thread gathers V consecutive outputs: one V-vector load of src, V
// independent gathers, one V-vector store.  src and out go the default way
// (src through the read-only path).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
permute_vec_kernel(const int* __restrict__ src, const T* __restrict__ x, T* __restrict__ out,
                   int64_t n) {
  using S = typename IdxVec<V>::type;
  using O = typename ValVec<T, V>::type;
  const int64_t nv = n / V;
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (int64_t v = t; v < nv; v += threads) {
    const S s = __ldg(reinterpret_cast<const S*>(src) + v);
    const int* si = reinterpret_cast<const int*>(&s);
    O o;
    T* oi = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int j = 0; j < V; ++j) oi[j] = gather(x + si[j]);
    reinterpret_cast<O*>(out)[v] = o;
  }
  // the last n % V outputs, one a thread of the grid's first
  const int64_t e = nv * V + t;
  if (e < n) out[e] = gather(x + __ldg(src + e));
}

// Group g = thread / L owns rows g, g + groups, ...; its lane j copies chunks
// j, j + L, ... of the row (chunks a row = k / V).
template <typename C, int L>
__global__ void __launch_bounds__(kThreads)
permute_rows_kernel(const int* __restrict__ src, const C* __restrict__ x, C* __restrict__ out,
                    int64_t n, int64_t chunks) {
  const int lane = threadIdx.x % L;
  const int64_t groups = static_cast<int64_t>(gridDim.x) * (kThreads / L);
  const int64_t g = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / L;
  for (int64_t i0 = g; i0 < n; i0 += groups * kRows) {
    const C* xr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t i = i0 + r * groups;
      xr[r] = i < n ? x + static_cast<int64_t>(stream_load(src + i)) * chunks : nullptr;
    }
    for (int64_t c = lane; c < chunks; c += L) {
      C v[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (xr[r] != nullptr) v[r] = __ldg(xr[r] + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (xr[r] != nullptr) stream_store(out + (i0 + r * groups) * chunks + c, v[r]);
    }
  }
}

struct Wave {
  std::once_flag queried;
  cudaError_t err = cudaSuccess;
  int blocks = 0;
};

// The blocks of one wave of `kernel` on the current device (SMs × blocks
// that fit on one), queried once a device and instance.
template <typename Kernel>
cudaError_t wave(Kernel kernel, Wave (&state)[kMaxDevices], int* blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  Wave& w = state[device];
  std::call_once(w.queried, [&] {
    int sms = 0, resident = 0;
    cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kThreads, 0);
    if (e == cudaSuccess && (sms < 1 || resident < 1)) e = cudaErrorInvalidConfiguration;
    w.err = e;
    w.blocks = sms * resident;
  });
  *blocks = w.blocks;
  return w.err;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, Wave (&state)[kMaxDevices], int64_t need, cudaStream_t s,
           Args... args) {
  int blocks = 0;
  const cudaError_t err = wave(kernel, state, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = need < blocks ? need : blocks;
  kernel<<<static_cast<unsigned>(grid < 1 ? 1 : grid), kThreads, 0, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_vec(const int* src, const void* x, void* out, int64_t n, cudaStream_t s) {
  static Wave state[kMaxDevices];
  const int64_t per_block = static_cast<int64_t>(kThreads) * V;
  return launch(permute_vec_kernel<T, V>, state, (n / V + per_block - 1) / per_block, s, src,
                static_cast<const T*>(x), static_cast<T*>(out), n);
}

template <int B, int L>
int launch_rows(const int* src, const void* x, void* out, int64_t n, int64_t chunks,
                cudaStream_t s) {
  using C = typename Chunk<B>::type;
  static Wave state[kMaxDevices];
  const int64_t per_block = static_cast<int64_t>(kThreads / L) * kRows;
  return launch(permute_rows_kernel<C, L>, state, (n + per_block - 1) / per_block, s, src,
                static_cast<const C*>(x), static_cast<C*>(out), n, chunks);
}

template <int B>
int dispatch_lanes(int lanes, const int* src, const void* x, void* out, int64_t n,
                   int64_t chunks, cudaStream_t s) {
  switch (lanes) {
    case 1: return launch_rows<B, 1>(src, x, out, n, chunks, s);
    case 2: return launch_rows<B, 2>(src, x, out, n, chunks, s);
    case 4: return launch_rows<B, 4>(src, x, out, n, chunks, s);
    case 8: return launch_rows<B, 8>(src, x, out, n, chunks, s);
    case 16: return launch_rows<B, 16>(src, x, out, n, chunks, s);
    case 32: return launch_rows<B, 32>(src, x, out, n, chunks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int tpukk_permute_gather(int dtype, int vec, int lanes, const int* src,
                                    const void* x, void* out, int64_t n, int64_t k,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || k == 0) return 0;
  if (k == 1) {
    if (lanes != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0 && vec == 4) return launch_vec<float, 4>(src, x, out, n, s);
    if (dtype == 0 && vec == 2) return launch_vec<float, 2>(src, x, out, n, s);
    if (dtype == 0 && vec == 1) return launch_vec<float, 1>(src, x, out, n, s);
    if (dtype == 1 && vec == 2) return launch_vec<double, 2>(src, x, out, n, s);
    if (dtype == 1 && vec == 1) return launch_vec<double, 1>(src, x, out, n, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec < 1 || k % vec != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = vec * (dtype == 0 ? 4 : 8);
  const int64_t chunks = k / vec;
  if (bytes == 16) return dispatch_lanes<16>(lanes, src, x, out, n, chunks, s);
  if (bytes == 8) return dispatch_lanes<8>(lanes, src, x, out, n, chunks, s);
  if (bytes == 4) return dispatch_lanes<4>(lanes, src, x, out, n, chunks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
