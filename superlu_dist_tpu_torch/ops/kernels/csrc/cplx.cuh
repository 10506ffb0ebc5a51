// cplx.cuh: the complex element type of the level executor's kernels and
// the element-type helpers that let one template serve float, double,
// complex64 and complex128 (diag_lu.cu on tile_lu.cuh, schur.cu on
// chain.cuh and panel.cuh, solve_gemm.cu on rows.cuh).
//
// Replaces: nothing on the TPU. The JAX package has no complex kernel: its
// TPU runs complex64 through the real ring embedding a+bi -> [[a,-b],[b,a]]
// and the fused float32 kernels, other accelerators through planar (re, im)
// real arithmetic (superlu_dist_tpu/models/driver.py::_use_embed,
// _use_planar). The port gives its kernels a native complex element type
// instead, in torch's own interleaved layout.
//
// cplx<R> is two R, re then im, aligned to 2 * sizeof(R): bit-compatible
// with torch.complex64 (R = float) and torch.complex128 (R = double), so a
// kernel takes a complex tensor's data_ptr() as it is. What a kernel does
// with an element goes through the overloads below, each written once:
//   fma(a, b, c)     c + a . b; for cplx four real FMAs in a fixed order
//                    (re: + a.re b.re, then - a.im b.im; im: + a.re b.im,
//                    then + a.im b.re), so a result repeats bit for bit;
//   a / p            division by a pivot, the one complex division;
//   abs_of(a)        |a| of a cplx in the real type (hypot);
//   replace_tiny     the tiny-pivot rule of ReplaceTinyPivot (reference
//                    pdgstrf2.c), keeping the pivot's phase;
//   shfl             a warp shuffle (re and im shuffled apart for cplx);
//   real_t<T>        the real type of T, the type of the threshold;
//   is_cplx<T>       whether T is complex.
// The arithmetic is IEEE in R on the CUDA cores. Callers in other
// namespaces take the names by using-declarations, except fma and the
// operators, which argument-dependent lookup finds for cplx (a
// using-declaration of fma would hide the global float and double fma).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace slu_cplx {

template <typename R>
struct alignas(2 * sizeof(R)) cplx {
  R re, im;
  cplx() = default;
  __host__ __device__ constexpr cplx(R r, R i = R(0)) : re(r), im(i) {}
};

static_assert(sizeof(cplx<float>) == 8 && alignof(cplx<float>) == 8,
              "complex64 layout");
static_assert(sizeof(cplx<double>) == 16 && alignof(cplx<double>) == 16,
              "complex128 layout");

template <typename T>
struct real_of {
  using type = T;
};
template <typename R>
struct real_of<cplx<R>> {
  using type = R;
};
// the real type of T (T itself for float and double)
template <typename T>
using real_t = typename real_of<T>::type;
// whether T is complex
template <typename T>
constexpr bool is_cplx = sizeof(T) != sizeof(real_t<T>);

template <typename R>
__device__ __forceinline__ cplx<R> operator+(cplx<R> a, cplx<R> b) {
  return cplx<R>(a.re + b.re, a.im + b.im);
}
template <typename R>
__device__ __forceinline__ cplx<R> operator-(cplx<R> a, cplx<R> b) {
  return cplx<R>(a.re - b.re, a.im - b.im);
}
template <typename R>
__device__ __forceinline__ cplx<R> operator-(cplx<R> a) {
  return cplx<R>(-a.re, -a.im);
}
template <typename R>
__device__ __forceinline__ cplx<R>& operator+=(cplx<R>& a, cplx<R> b) {
  a = a + b;
  return a;
}
template <typename R>
__device__ __forceinline__ cplx<R>& operator-=(cplx<R>& a, cplx<R> b) {
  a = a - b;
  return a;
}

// c + a . b in four real FMAs, in the order the header states
template <typename R>
__device__ __forceinline__ cplx<R> fma(cplx<R> a, cplx<R> b, cplx<R> c) {
  R re = ::fma(a.re, b.re, c.re);
  re = ::fma(-a.im, b.im, re);
  R im = ::fma(a.re, b.im, c.im);
  im = ::fma(a.im, b.re, im);
  return cplx<R>(re, im);
}

template <typename R>
__device__ __forceinline__ cplx<R> conj(cplx<R> a) {
  return cplx<R>(a.re, -a.im);
}

// a / p: a . conj(p) / |p|^2. The pivots that reach it are at least the
// tiny-pivot threshold in modulus, so |p|^2 neither under- nor overflows
// for the scaled matrices the factor sees.
template <typename R>
__device__ __forceinline__ cplx<R> operator/(cplx<R> a, cplx<R> p) {
  const R d = ::fma(p.re, p.re, p.im * p.im);
  const R re = ::fma(a.re, p.re, a.im * p.im);
  const R im = ::fma(a.im, p.re, -(a.re * p.im));
  return cplx<R>(re / d, im / d);
}

__device__ __forceinline__ float abs_of(cplx<float> a) {
  return hypotf(a.re, a.im);
}
__device__ __forceinline__ double abs_of(cplx<double> a) {
  return hypot(a.re, a.im);
}

// ReplaceTinyPivot: p with |p| < thresh becomes (p / |p|) . thresh, or
// +thresh at p == 0 (for a real p, sign(p) . thresh); returns whether it
// was replaced. The JAX package's blocklu._replace_tiny.
__device__ __forceinline__ bool replace_tiny(float& p, float thresh) {
  const float ap = fabsf(p);
  if (!(ap < thresh)) return false;
  p = ap > 0.f ? copysignf(thresh, p) : thresh;
  return true;
}
__device__ __forceinline__ bool replace_tiny(double& p, double thresh) {
  const double ap = fabs(p);
  if (!(ap < thresh)) return false;
  p = ap > 0.0 ? copysign(thresh, p) : thresh;
  return true;
}
template <typename R>
__device__ __forceinline__ bool replace_tiny(cplx<R>& p, R thresh) {
  const R ap = abs_of(p);
  if (!(ap < thresh)) return false;
  p = ap > R(0) ? cplx<R>(p.re / ap * thresh, p.im / ap * thresh)
                : cplx<R>(thresh);
  return true;
}

__device__ __forceinline__ float shfl(unsigned mask, float v, int src) {
  return __shfl_sync(mask, v, src);
}
__device__ __forceinline__ double shfl(unsigned mask, double v, int src) {
  return __shfl_sync(mask, v, src);
}
template <typename R>
__device__ __forceinline__ cplx<R> shfl(unsigned mask, cplx<R> v, int src) {
  return cplx<R>(__shfl_sync(mask, v.re, src), __shfl_sync(mask, v.im, src));
}

// a load through the read-only path of one element
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ double ldg(const double* p) { return __ldg(p); }
__device__ __forceinline__ cplx<float> ldg(const cplx<float>* p) {
  const float2 a = __ldg(reinterpret_cast<const float2*>(p));
  return cplx<float>(a.x, a.y);
}
__device__ __forceinline__ cplx<double> ldg(const cplx<double>* p) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  return cplx<double>(a.x, a.y);
}

// v = p[0 : 16 / sizeof(T)] of a complex T, p 16-byte aligned: one
// 16-byte load (through the read-only path with ro), and its store
__device__ __forceinline__ void ld16v(const cplx<float>* p,
                                      cplx<float>* v, bool ro = false) {
  const float4 x = ro ? __ldg(reinterpret_cast<const float4*>(p))
                      : *reinterpret_cast<const float4*>(p);
  v[0] = cplx<float>(x.x, x.y);
  v[1] = cplx<float>(x.z, x.w);
}
__device__ __forceinline__ void ld16v(const cplx<double>* p,
                                      cplx<double>* v, bool ro = false) {
  const double2 x = ro ? __ldg(reinterpret_cast<const double2*>(p))
                       : *reinterpret_cast<const double2*>(p);
  v[0] = cplx<double>(x.x, x.y);
}
__device__ __forceinline__ void st16v(cplx<float>* p,
                                      const cplx<float>* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0].re, v[0].im, v[1].re,
                                              v[1].im);
}
__device__ __forceinline__ void st16v(cplx<double>* p,
                                      const cplx<double>* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0].re, v[0].im);
}

}  // namespace slu_cplx
