// Complex values for the kernels that take them: K1 and K2 (dia.cu), K3
// (csr.cu's csr_spmv, sum only) and K7 (csr_spmm), K4 (sptrsv.cu), K6 (gs.cu,
// through csr_panel.cuh) and K8 (spgemm.cu).
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
//   shfl(...)       __shfl_sync (the same)
// and the arithmetic: +, -, *, += and conj.  A complex product is
// (ar·br − ai·bi, ar·bi + ai·br); the compiler may contract it into FMAs,
// except where a kernel asks for separately rounded operations: mul_rn,
// add_rn and sub_rn round each operation on its own, and madd(a, b, acc),
// the multiply-add of K2, K6 and K7, is one fma for real values and
// add_rn(acc, mul_rn(a, b)) for complex ones, so a complex product is formed
// as K8's is, in the plain version's order, whichever kernel forms it.
// real_of<T>::type is T's real type (ω and other real scales);
// scale(s, a) multiplies a by a real s (each part rounded on its own).

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

template <typename T>
struct real_of {
  using type = T;
};
template <typename R>
struct real_of<cplx<R>> {
  using type = R;
};

// separately rounded operations: no contraction into an FMA
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
// a complex product from its parts, each operation rounded on its own:
// (ar·br − ai·bi, ar·bi + ai·br), the formula and order of the plain version
template <typename R>
__device__ __forceinline__ cplx<R> mul_rn(cplx<R> a, cplx<R> b) {
  return {sub_rn(mul_rn(a.re, b.re), mul_rn(a.im, b.im)),
          add_rn(mul_rn(a.re, b.im), mul_rn(a.im, b.re))};
}
template <typename R>
__device__ __forceinline__ cplx<R> add_rn(cplx<R> a, cplx<R> b) {
  return {add_rn(a.re, b.re), add_rn(a.im, b.im)};
}
template <typename R>
__device__ __forceinline__ cplx<R> sub_rn(cplx<R> a, cplx<R> b) {
  return {sub_rn(a.re, b.re), sub_rn(a.im, b.im)};
}

// acc + a·b: one fma in real values, the product from its parts in complex
__device__ __forceinline__ float madd(float a, float b, float acc) { return fmaf(a, b, acc); }
__device__ __forceinline__ double madd(double a, double b, double acc) { return fma(a, b, acc); }
template <typename R>
__device__ __forceinline__ cplx<R> madd(cplx<R> a, cplx<R> b, cplx<R> acc) {
  return add_rn(acc, mul_rn(a, b));
}

// s·a for a real s
__device__ __forceinline__ float scale(float s, float a) { return s * a; }
__device__ __forceinline__ double scale(double s, double a) { return s * a; }
template <typename R>
__device__ __forceinline__ cplx<R> scale(R s, cplx<R> a) {
  return {mul_rn(s, a.re), mul_rn(s, a.im)};
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
template <typename U>
__device__ __forceinline__ U shfl(unsigned mask, U v, int src, int width = 32) {
  return __shfl_sync(mask, v, src, width);
}
template <typename R>
__device__ __forceinline__ cplx<R> shfl(unsigned mask, cplx<R> v, int src, int width = 32) {
  return {__shfl_sync(mask, v.re, src, width), __shfl_sync(mask, v.im, src, width)};
}

}  // namespace
