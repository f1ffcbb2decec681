// Static permutation for Hopper (sm_90a): K5 permute_gather<T>.
//
// Replaces the TPU kernels of the routed static permutation
// (tpukk/common/permute.py): _rowperm3_call (:91) and _rowperm_call (:144),
// each one phase of a three-phase Benes/Slepian-Duguid network that exists
// because Mosaic has no fast dynamic gather across a whole vector.
//
// What it computes: out[i, :] = x[src[i], :] for i < n, with x and out
// row-major (n, k) (k = 1 for a vector) and src an int32 index vector (a
// permutation wherever the port uses it: both sides of the level-scheduled
// triangular solve, the RCM SpMV route and the RCM-permuted GMRES).
//
// Bound on the H100: bytes.  It reads src (4 B) and x (4 or 8 B) and writes
// out once per element.  The src and out streams are coalesced; the x reads
// are a gather whose locality is the permutation's, served through L2.
//
// Design against that bound: one element per thread (neighbouring threads on
// neighbouring columns of one row when k > 1), a grid-stride loop, the gather
// through the read-only path (__ldg).  No routing tables: the H100
// gathers from device memory directly, so the host router is not carried.
//
// C interface (bound with ctypes): returns the cudaError_t of the launch (0
// when nothing needed launching); dtype 0 = float, 1 = double.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
permute_gather_kernel(const int* __restrict__ src, const T* __restrict__ x,
                      T* __restrict__ out, int64_t total, int64_t k) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    if (k == 1) {
      out[e] = __ldg(x + __ldg(src + e));
    } else {
      const int64_t i = e / k;
      out[e] = __ldg(x + static_cast<int64_t>(__ldg(src + i)) * k + (e - i * k));
    }
  }
}

template <typename T>
int launch(const int* src, const void* x, void* out, int64_t n, int64_t k,
           cudaStream_t stream) {
  const int64_t total = n * k;
  if (total == 0) return 0;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;  // grid-stride beyond this
  permute_gather_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      src, static_cast<const T*>(x), static_cast<T*>(out), total, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tpukk_permute_gather(int dtype, const int* src, const void* x, void* out,
                                    int64_t n, int64_t k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(src, x, out, n, k, s);
  if (dtype == 1) return launch<double>(src, x, out, n, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
