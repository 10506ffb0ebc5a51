// strip.cuh: the block-strip update of schur.cu (waves.cuh, for clk.cu
// and tck.cu, takes its Vec4 and FIN_U).
//
// One CTA of bs threads owns one strip of kStrip scalar columns (or rows)
// of one target block T of the pool and computes, in registers,
//   T <- T - sum over p in [p0, p1) of pool[cl[p]] . pool[cu[p]]
// in the order of p, then an optional finalize by a stored inverse:
//   FIN_L: T <- T . uinv[step]   (an L panel)
//   FIN_U: T <- linv[step] . T   (a U panel)
// and writes T once. FIN_L mixes the columns of a row, so its strips are
// strips of whole rows; FIN_NONE and FIN_U (which mixes the rows of a
// column) use strips of whole columns. flk.cu and rdma.cu run chain.cuh's
// staged chain product instead, and the panel TRSMs panel.cuh's band
// kernel.
//
// Each thread owns a 4x4 tile of the strip. The operand that is read
// along the strip (the U strip, or the L row strip, then T itself for the
// finalize) is staged in shared memory; the other block is read from
// device memory (L2) through the read-only path, which is safe because no
// block that a launch reads is written in that launch (the sources and
// inverses belong to lower elimination levels or to an earlier launch).
// Every function is a template on the element type T (float or double);
// each thread moves 4 consecutive elements at a time (one float4, or two
// double2), and the arithmetic is IEEE in T. Offsets are 64-bit
// (slot * bs^2 passes 2^31 near n = 885k).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace slu_strip {

constexpr int kStrip = 16;     // scalar columns (or rows) per strip
constexpr int kMaxBs = 128;    // largest block size (CUDA_BLOCK_SIZES)

// finalize codes, the values of the JAX package's flk.py
constexpr int FIN_NONE = 0;
constexpr int FIN_L = 2;
constexpr int FIN_U = 3;

// 4 consecutive elements (16-byte aligned): one float4 or two double2
template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  static __device__ __forceinline__ void ld(const float* p, float v[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  static __device__ __forceinline__ void ldg(const float* p, float v[4]) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  static __device__ __forceinline__ void st(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec4<double> {
  static __device__ __forceinline__ void ld(const double* p, double v[4]) {
    const double2 x = reinterpret_cast<const double2*>(p)[0];
    const double2 y = reinterpret_cast<const double2*>(p)[1];
    v[0] = x.x;
    v[1] = x.y;
    v[2] = y.x;
    v[3] = y.y;
  }
  static __device__ __forceinline__ void ldg(const double* p, double v[4]) {
    const double2 x = __ldg(reinterpret_cast<const double2*>(p));
    const double2 y = __ldg(reinterpret_cast<const double2*>(p) + 1);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = y.x;
    v[3] = y.y;
  }
  static __device__ __forceinline__ void st(double* p, const double v[4]) {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  }
};

// acc += A[r0:r0+4, :] . B[:, c0:c0+4]; A is bs x bs in device memory,
// B is bs x kStrip in shared memory.
template <typename T>
__device__ __forceinline__ void mul_dev_smem(const T* __restrict__ A,
                                             const T* B, int bs, int r0,
                                             int c0, T acc[4][4]) {
  const T* a0 = A + (int64_t)r0 * bs;
  for (int k = 0; k < bs; k += 4) {
    T a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) Vec4<T>::ldg(a0 + i * bs + k, a[i]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      T b[4];
      Vec4<T>::ld(B + (k + kk) * kStrip + c0, b);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const T av = a[i][kk];
        acc[i][0] += av * b[0];
        acc[i][1] += av * b[1];
        acc[i][2] += av * b[2];
        acc[i][3] += av * b[3];
      }
    }
  }
}

// acc += X[r0:r0+4, :] . B[:, c0:c0+4]; X is kStrip x bs in shared
// memory, B is bs x bs in device memory.
template <typename T>
__device__ __forceinline__ void mul_smem_dev(const T* X,
                                             const T* __restrict__ B,
                                             int bs, int r0, int c0,
                                             T acc[4][4]) {
  for (int k = 0; k < bs; ++k) {
    T b[4];
    Vec4<T>::ldg(B + (int64_t)k * bs + c0, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const T a = X[(r0 + i) * bs + k];
      acc[i][0] += a * b[0];
      acc[i][1] += a * b[1];
      acc[i][2] += a * b[2];
      acc[i][3] += a * b[3];
    }
  }
}

// The strip update described at the top of this file, for strip number
// `strip` of the block at `slot`. Launched with blockDim.x == bs.
template <typename T>
__device__ __forceinline__ void strip_update(
    T* pool, const T* __restrict__ linv, const T* __restrict__ uinv,
    int64_t slot, int64_t step, int fin, const int32_t* __restrict__ cl,
    const int32_t* __restrict__ cu, int p0, int p1, int bs, int strip) {
  __shared__ __align__(16) T S[kMaxBs * kStrip];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t bb = (int64_t)bs * bs;
  const bool rows = fin == FIN_L;
  // the strip is kStrip x bs (rows) or bs x kStrip (columns); ld is the
  // leading dimension of its copy in S
  const int ld = rows ? bs : kStrip;
  const int r0 = rows ? (tid / (bs / 4)) * 4 : (tid / (kStrip / 4)) * 4;
  const int c0 = rows ? (tid % (bs / 4)) * 4 : (tid % (kStrip / 4)) * 4;
  const int64_t off = rows ? (int64_t)strip * kStrip * bs : strip * kStrip;
  T* Tb = pool + slot * bb + off;

  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) Vec4<T>::ld(Tb + (int64_t)(r0 + i) * bs + c0,
                                          acc[i]);

  for (int p = p0; p < p1; ++p) {
    const T* L = pool + (int64_t)cl[p] * bb;
    const T* U = pool + (int64_t)cu[p] * bb;
    __syncthreads();   // every thread is done with the previous strip
    if (rows) {        // rows [strip*kStrip, +kStrip) of L: contiguous
      for (int e = tid; e < kStrip * bs / 4; e += nt) {
        T v[4];
        Vec4<T>::ldg(L + off + 4 * e, v);
        Vec4<T>::st(S + 4 * e, v);
      }
    } else {           // columns [strip*kStrip, +kStrip) of U
      for (int e = tid; e < bs * (kStrip / 4); e += nt) {
        const int r = e / (kStrip / 4);
        const int c = (e % (kStrip / 4)) * 4;
        T v[4];
        Vec4<T>::ldg(U + (int64_t)r * bs + off + c, v);
        Vec4<T>::st(S + r * kStrip + c, v);
      }
    }
    __syncthreads();
    T prod[4][4] = {};
    if (rows)
      mul_smem_dev<T>(S, U, bs, r0, c0, prod);
    else
      mul_dev_smem<T>(L, S, bs, r0, c0, prod);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] -= prod[i][j];
  }

  if (fin != FIN_NONE) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) Vec4<T>::st(S + (r0 + i) * ld + c0, acc[i]);
    __syncthreads();
    T out[4][4] = {};
    if (rows)
      mul_smem_dev<T>(S, uinv + step * bb, bs, r0, c0, out);
    else
      mul_dev_smem<T>(linv + step * bb, S, bs, r0, c0, out);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = out[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) Vec4<T>::st(Tb + (int64_t)(r0 + i) * bs + c0,
                                          acc[i]);
}

}  // namespace slu_strip
