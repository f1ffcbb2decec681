// SpGEMM numeric phase for Hopper (sm_90a): K8 spgemm_pair_sum<T>.
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
// What it computes: for each C entry c < nnz_c,
//   C[c] = sum_{p = c_ptr[c]}^{c_ptr[c+1]-1} A[a_idx[p]] * B[b_idx[p]],
// each product rounded, then summed in plan order starting from 0, so the
// result is the same for every lane count and from run to run.
//
// Bound on the H100: bytes.  Per pair it reads two int32 indices and gathers
// two values for one multiply-add; the compulsory traffic of the product (A
// and B once, C's pattern read and its values written once) is about 40 % of
// what this design moves, since it also streams the pair plan (8 B per pair
// and 8 B per C entry).  A row-wise kernel with an accumulator in shared
// memory (KKMEM) would drop the plan; that is later work.
//
// Design against that bound: G lanes (1, 2, 4, 8, 16 or 32, chosen on the
// host from the mean pairs per C entry) own one C entry.  They load G pairs
// at a time at consecutive addresses (coalesced index reads, G gathers in
// flight), and lane 0 of the group adds the G products in plan order through
// shuffles.  No atomics, no cross-block reduction, one write per C entry.
// Products and sums use __fmul_rn/__fadd_rn (__dmul_rn/__dadd_rn) so the
// compiler cannot contract them into an FMA: a product is rounded exactly as
// the plain torch version rounds it.
//
// C interface (bound with ctypes): returns the cudaError_t of the launch (0
// when nothing needed launching); dtype 0 = float, 1 = double.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
spgemm_pair_sum_kernel(const int64_t* __restrict__ c_ptr, const int* __restrict__ a_idx,
                       const int* __restrict__ b_idx, const T* __restrict__ a,
                       const T* __restrict__ b, T* __restrict__ c, int64_t nnz_c) {
  const int64_t e = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const int lane = static_cast<int>(threadIdx.x) % G;
  // a group's lanes share e, so a whole group leaves or stays
  if (e >= nnz_c) return;
  const int64_t p0 = c_ptr[e], p1 = c_ptr[e + 1];
  T acc = T(0);
  if (G == 1) {
    for (int64_t p = p0; p < p1; ++p) acc = add_rn(acc, mul_rn(__ldg(a + a_idx[p]), __ldg(b + b_idx[p])));
  } else {
    const int group0 = (static_cast<int>(threadIdx.x) % 32) / G * G;
    const unsigned mask = (G == 32) ? 0xffffffffu : (((1u << (G % 32)) - 1u) << group0);
    for (int64_t base = p0; base < p1; base += G) {
      const int64_t p = base + lane;
      const T prod = p < p1 ? mul_rn(__ldg(a + a_idx[p]), __ldg(b + b_idx[p])) : T(0);
      const int n = static_cast<int>(p1 - base < G ? p1 - base : G);
      for (int j = 0; j < n; ++j) acc = add_rn(acc, __shfl_sync(mask, prod, j, G));
    }
  }
  if (lane == 0) c[e] = acc;
}

template <typename T>
int launch(int group, const int64_t* c_ptr, const int* a_idx, const int* b_idx, const void* a,
           const void* b, void* c, int64_t nnz_c, cudaStream_t stream) {
  if (nnz_c == 0) return 0;
  const int64_t blocks = (nnz_c * group + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned nb = static_cast<unsigned>(blocks);
  const T* av = static_cast<const T*>(a);
  const T* bv = static_cast<const T*>(b);
  T* cv = static_cast<T*>(c);
  switch (group) {
    case 1: spgemm_pair_sum_kernel<T, 1><<<nb, kThreads, 0, stream>>>(c_ptr, a_idx, b_idx, av, bv, cv, nnz_c); break;
    case 2: spgemm_pair_sum_kernel<T, 2><<<nb, kThreads, 0, stream>>>(c_ptr, a_idx, b_idx, av, bv, cv, nnz_c); break;
    case 4: spgemm_pair_sum_kernel<T, 4><<<nb, kThreads, 0, stream>>>(c_ptr, a_idx, b_idx, av, bv, cv, nnz_c); break;
    case 8: spgemm_pair_sum_kernel<T, 8><<<nb, kThreads, 0, stream>>>(c_ptr, a_idx, b_idx, av, bv, cv, nnz_c); break;
    case 16: spgemm_pair_sum_kernel<T, 16><<<nb, kThreads, 0, stream>>>(c_ptr, a_idx, b_idx, av, bv, cv, nnz_c); break;
    case 32: spgemm_pair_sum_kernel<T, 32><<<nb, kThreads, 0, stream>>>(c_ptr, a_idx, b_idx, av, bv, cv, nnz_c); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tpukk_spgemm_pair_sum(int dtype, int group, const int64_t* c_ptr, const int* a_idx,
                                     const int* b_idx, const void* a, const void* b, void* c,
                                     int64_t nnz_c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(group, c_ptr, a_idx, b_idx, a, b, c, nnz_c, s);
  if (dtype == 1) return launch<double>(group, c_ptr, a_idx, b_idx, a, b, c, nnz_c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
