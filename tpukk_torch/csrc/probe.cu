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
// Design against that bound.  The host lists each lane's chunks (a lane is an
// output tile: a block, or a sub-tile of mt4's block) in (g, j) order, each
// record the chunk, its source block and whether it ends its step, with the
// steps a later first step overwrites left out (common/probe_cuda.py), so a
// lane's y starts at +0 and adds each step's sum: the plain version's bits.
// One CTA owns one row of one lane, one thread a column (mt4's CTAs walk only
// their own sub-tile's chunks).  Only the sums form a chain; no load depends
// on a sum.  So a thread takes its lane's chunks in rounds of kGroup and
// pipelines the loads of each round over kAhead + 1 rounds: while it sums
// round k it loads the words of its column for round k + kAhead (gt or pk,
// lo, v: each a coalesced 512-byte row across the CTA) and the records of the
// round after, and issues round k + 1's x loads, so kAhead rounds of rows are
// in flight a thread.  The gather is split as the TPU kernel splits it:
// thread c reads t[c] = X[gt[r, c], c], which needs only its own word; a
// round's t rows meet in shared memory, and after one barrier thread c reads
// xg = t[lo[r, c]] and adds v * xg in order.  Two t buffers in turn, so one
// barrier a round.  x (256 KB at the probe's shapes) is read through L1, and
// the launch leaves the SM's shared memory beyond its blocks' 4 KB each to
// L1.  The words are read once, past L1, where they would only evict x (read
// through L1, they were no faster on any plan: PERF.md, K9).  Rounds of 4
// chunks and rows 2 rounds ahead: the fastest of the depths tried on the
// H100 (PERF.md, K9).
//
// C interface (bound with ctypes): returns the cudaError_t of the launch (0
// when nothing needed launching).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace {

constexpr int kCols = 128;    // tile width: one thread a column
constexpr int kRows = 8;      // tile height: rows of a lane, a CTA each
constexpr int kSrcRows = 32;  // rows of one source block of x
constexpr int kGroup = 4;     // chunks a round
constexpr int kAhead = 2;     // rounds of rows loaded beyond the round being summed
constexpr int kMinBlocks = 4; // blocks an SM must hold: 512 for the probe's shapes
static_assert(kAhead >= 2, "round k + 1's x loads read the rows loaded a round before");
constexpr int kMaxDevices = 64;
constexpr int kSmemPerBlockReserved = 1024;  // the runtime's own shared memory per block

// A streamed word, read once: it does not allocate in L1, where it would only
// evict the x that the gathers hit.
__device__ __forceinline__ int ld_word(const int* p) {
  int v;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float ld_word(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// A round of chunks as a thread holds them: its column's words and the records.
struct Round {
  int own[kGroup];   // gt (base) or pk
  int lo[kGroup];    // base only
  float v[kGroup];
  int word[kGroup];  // s << 1 | ends its step
};

template <bool kPacked>
__device__ __forceinline__ void load_round(const int2 (&q)[kGroup], int i0, int n, int r, int c,
                                           const int* __restrict__ gt_or_pk,
                                           const int* __restrict__ lo,
                                           const float* __restrict__ v, Round& R) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    if (i0 + u < n) {
      const int64_t e = (static_cast<int64_t>(q[u].x) * kRows + r) * kCols + c;
      R.own[u] = ld_word(gt_or_pk + e);
      if constexpr (!kPacked) R.lo[u] = ld_word(lo + e);
      R.v[u] = ld_word(v + e);
      R.word[u] = q[u].y;
    }
  }
}

__device__ __forceinline__ void load_records(const int2* __restrict__ rec, int i0, int n,
                                             int2 (&q)[kGroup]) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) q[u] = i0 + u < n ? __ldg(rec + i0 + u) : make_int2(0, 0);
}

// t[c] = X[gt[r, c], c] of each chunk of the round
template <bool kPacked>
__device__ __forceinline__ void load_t(const Round& R, int i0, int n, int c,
                                       const float* __restrict__ x, float (&t)[kGroup]) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    if (i0 + u < n) {
      const int w = R.own[u];
      const int gi = kPacked ? 8 * (w >> 16) + ((w >> 13) & 7) : w;
      t[u] = __ldg(x + (static_cast<int64_t>(R.word[u] >> 1) * kSrcRows + gi) * kCols + c);
    }
  }
}

template <bool kPacked>
__global__ void __launch_bounds__(kCols, kMinBlocks)
probe_gather_acc_kernel(const float* __restrict__ x, const int* __restrict__ lane_ptr,
                        const int2* __restrict__ lane_rec, const int* __restrict__ gt_or_pk,
                        const int* __restrict__ lo, const float* __restrict__ v,
                        float* __restrict__ y) {
  __shared__ float s_t[2][kGroup][kCols];
  const int c = threadIdx.x;
  const int lane_id = blockIdx.x / kRows;  // the output tile; y's row is blockIdx.x
  const int r = blockIdx.x - lane_id * kRows;
  const int p0 = __ldg(lane_ptr + lane_id);
  const int n = __ldg(lane_ptr + lane_id + 1) - p0;
  const int2* rec = lane_rec + p0;

  // rounds 0 .. kAhead - 1 loaded, round kAhead's records, round 0's t
  Round w[kAhead];
  int2 q[kAhead + 1][kGroup];
#pragma unroll
  for (int a = 0; a <= kAhead; ++a) load_records(rec, a * kGroup, n, q[a]);
#pragma unroll
  for (int a = 0; a < kAhead; ++a)
    load_round<kPacked>(q[a], a * kGroup, n, r, c, gt_or_pk, lo, v, w[a]);
  int2 (&next_rec)[kGroup] = q[kAhead];
  float t[kGroup];
  load_t<kPacked>(w[0], 0, n, c, x, t);

  float acc = 0.0f, yv = 0.0f;
  for (int i0 = 0, buf = 0; i0 < n; i0 += kGroup, buf ^= 1) {
    Round fresh;
    load_round<kPacked>(next_rec, i0 + kAhead * kGroup, n, r, c, gt_or_pk, lo, v, fresh);
    load_records(rec, i0 + (kAhead + 1) * kGroup, n, next_rec);
    float t_next[kGroup];
    load_t<kPacked>(w[1], i0 + kGroup, n, c, x, t_next);
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      if (i0 + u < n) s_t[buf][u][c] = t[u];
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (i0 + u < n) {
        const int l = kPacked ? w[0].own[u] & 1023 : w[0].lo[u];
        acc = __fadd_rn(acc, __fmul_rn(w[0].v[u], s_t[buf][u][l]));
        if (w[0].word[u] & 1) {
          yv = __fadd_rn(yv, acc);
          acc = 0.0f;
        }
      }
    }
#pragma unroll
    for (int a = 0; a + 1 < kAhead; ++a) w[a] = w[a + 1];
    w[kAhead - 1] = fresh;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) t[u] = t_next[u];
  }
  y[static_cast<int64_t>(blockIdx.x) * kCols + c] = yv;
}

// One kernel's carve-out on one device: the numbers that set it, queried at
// the kernel's first launch there, and the preference set last (+ 1; 0: none).
struct CarveOut {
  std::once_flag queried;
  cudaError_t query = cudaSuccess;
  int sms = 0, per_sm = 0, resident = 0, need_per_block = 0;
  std::atomic<int> set{0};
};

// Leave the SM's shared memory beyond what the grid's blocks on it use to
// L1, where x's loads hit: the carve-out preference for min(the blocks that
// fit, the grid's blocks an SM), set only when it differs from the one set
// last on the device.  Returns the failing runtime call's error, else
// cudaSuccess.
template <typename Kernel>
cudaError_t prefer_l1(Kernel kernel, unsigned grid, CarveOut (&state)[kMaxDevices]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  CarveOut& o = state[device];
  std::call_once(o.queried, [&] {
    cudaFuncAttributes attr;
    cudaError_t e = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&o.per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.resident, kernel, kCols, 0);
    if (e == cudaSuccess && (o.resident < 1 || o.sms < 1 || o.per_sm < 1))
      e = cudaErrorInvalidConfiguration;
    if (e == cudaSuccess)
      o.need_per_block = static_cast<int>(attr.sharedSizeBytes) + kSmemPerBlockReserved;
    o.query = e;
  });
  if (o.query != cudaSuccess) return o.query;
  const int blocks = min(o.resident, static_cast<int>((grid + o.sms - 1) / o.sms));
  const int percent = min(100, (100 * blocks * o.need_per_block + o.per_sm - 1) / o.per_sm);
  if (o.set.load(std::memory_order_relaxed) == percent + 1) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, percent);
  if (err == cudaSuccess) o.set.store(percent + 1, std::memory_order_relaxed);
  return err;
}

template <bool kPacked>
int launch(const float* x, const int* lane_ptr, const int2* rec, const int* gt_or_pk,
           const int* lo, const float* v, float* y, unsigned grid, cudaStream_t s) {
  static CarveOut state[kMaxDevices];
  auto kernel = probe_gather_acc_kernel<kPacked>;
  const cudaError_t err = prefer_l1(kernel, grid, state);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kCols, 0, s>>>(x, lane_ptr, rec, gt_or_pk, lo, v, y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lane_ptr (n_lanes + 1) and lane_rec (records, 2): each lane's chunk list
// (chunk, s << 1 | ends its step); gt_or_pk, lo and v: the streamed
// (8·chunks, 128) rows; y: (8·n_lanes, 128)
extern "C" int tpukk_probe_gather_acc(int packed, const float* x, const int* lane_ptr,
                                      const int* lane_rec, const int* gt_or_pk, const int* lo,
                                      const float* v, float* y, int n_lanes, void* stream) {
  if (n_lanes == 0) return 0;
  if (n_lanes < 0 || (!packed && lo == nullptr) ||
      reinterpret_cast<uintptr_t>(lane_rec) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(n_lanes) * kRows;
  const int2* rec = reinterpret_cast<const int2*>(lane_rec);
  if (packed) return launch<true>(x, lane_ptr, rec, gt_or_pk, lo, v, y, grid, s);
  return launch<false>(x, lane_ptr, rec, gt_or_pk, lo, v, y, grid, s);
}
