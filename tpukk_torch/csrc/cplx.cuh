// Complex values for the kernels that take them: K1 (dia.cu's dia_spmv), K3
// (csr.cu's csr_spmv, sum only), K4 (sptrsv.cu) and K8 (spgemm.cu).
//
// cplx<R> is the pair (re, im) of R = float or double, aligned to its own
// size (8 or 16 bytes), so one value is one float2/double2 access and an
// array of them has the layout of torch's complex64/complex128.  The CUDA
// intrinsics the kernels use (__ldg, the streamed load, __shfl_*_sync) have
// overloads for built-in types only, so this header gives each kernel one
// spelling for real and complex T:
//   ldg(p)          a read-only load (complex: one float2/double2 __ldg)
//   ld_stream(p)    a load that does not allocate in L1 (complex: one v2 load)
//   shfl_xor(...)   __shfl_xor_sync (complex: two shuffles, one a half)
// and the arithmetic: +, -, *, += and conj.  A complex product is
// (ar·br − ai·bi, ar·bi + ai·br); the compiler may contract it into FMAs,
// except where a kernel asks for separately rounded operations
// (spgemm.cu's mul_rn/add_rn).

#pragma once

#include <cuda_runtime.h>

namespace {

template <typename R>
struct alignas(2 * sizeof(R)) cplx {
  R re, im;
  cplx() = default;
  __host__ __device__ constexpr cplx(R r, R i = R(0)) : re(r), im(i) {}
};

template <typename R>
__device__ __forceinline__ cplx<R> operator+(cplx<R> a, cplx<R> b) {
  return {a.re + b.re, a.im + b.im};
}
template <typename R>
__device__ __forceinline__ cplx<R> operator-(cplx<R> a, cplx<R> b) {
  return {a.re - b.re, a.im - b.im};
}
template <typename R>
__device__ __forceinline__ cplx<R> operator*(cplx<R> a, cplx<R> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
template <typename R>
__device__ __forceinline__ cplx<R>& operator+=(cplx<R>& a, cplx<R> b) {
  a = a + b;
  return a;
}
template <typename R>
__device__ __forceinline__ cplx<R> conj(cplx<R> a) {
  return {a.re, -a.im};
}

// read-only loads
template <typename U>
__device__ __forceinline__ U ldg(const U* p) {
  return __ldg(p);
}
__device__ __forceinline__ cplx<float> ldg(const cplx<float>* p) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  return {v.x, v.y};
}
__device__ __forceinline__ cplx<double> ldg(const cplx<double>* p) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  return {v.x, v.y};
}

// loads that do not allocate in L1: a matrix that streams from device memory
// is read once, and in L1 it would only evict the x it gathers
__device__ __forceinline__ int ld_stream(const int* p) {
  int v;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float ld_stream(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ double ld_stream(const double* p) {
  double v;
  asm("ld.global.nc.L1::no_allocate.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ cplx<float> ld_stream(const cplx<float>* p) {
  cplx<float> v;
  asm("ld.global.nc.L1::no_allocate.v2.f32 {%0, %1}, [%2];" : "=f"(v.re), "=f"(v.im) : "l"(p));
  return v;
}
__device__ __forceinline__ cplx<double> ld_stream(const cplx<double>* p) {
  cplx<double> v;
  asm("ld.global.nc.L1::no_allocate.v2.f64 {%0, %1}, [%2];" : "=d"(v.re), "=d"(v.im) : "l"(p));
  return v;
}

// warp shuffles
template <typename U>
__device__ __forceinline__ U shfl_xor(unsigned mask, U v, int lane_mask, int width = 32) {
  return __shfl_xor_sync(mask, v, lane_mask, width);
}
template <typename R>
__device__ __forceinline__ cplx<R> shfl_xor(unsigned mask, cplx<R> v, int lane_mask,
                                            int width = 32) {
  return {__shfl_xor_sync(mask, v.re, lane_mask, width),
          __shfl_xor_sync(mask, v.im, lane_mask, width)};
}

}  // namespace
