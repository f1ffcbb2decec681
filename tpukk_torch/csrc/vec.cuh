// Vector access to a row of a row-major multivector, shared by K2
// (dia.cu's dia_spmm) and K7 (csr.cu's csr_spmm): one load of V consecutive
// values through the read-only path, and one store of V values, each a
// single 16-, 8- or 4-byte access (V = 4, 2, 1 in f32; 2, 1 in f64 and
// complex64; 1 in complex128).  The address must lie on a V-value boundary;
// the callers check that.

#pragma once

#include <cuda_runtime.h>

#include "cplx.cuh"

namespace {

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load_vec(const float* p, float (&v)[2]) {
  const float2 q = __ldg(reinterpret_cast<const float2*>(p));
  v[0] = q.x, v[1] = q.y;
}
__device__ __forceinline__ void load_vec(const double* p, double (&v)[2]) {
  const double2 q = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = q.x, v[1] = q.y;
}
__device__ __forceinline__ void load_vec(const cplx<float>* p, cplx<float> (&v)[2]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = {q.x, q.y}, v[1] = {q.z, q.w};
}
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[1]) {
  v[0] = ldg(p);
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store_vec(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void store_vec(cplx<float>* p, const cplx<float> (&v)[2]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0].re, v[0].im, v[1].re, v[1].im);
}
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[1]) {
  *p = v[0];
}

}  // namespace
