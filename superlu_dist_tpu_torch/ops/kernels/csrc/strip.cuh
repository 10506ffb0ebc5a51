// strip.cuh: the block-strip update shared by flk.cu and schur.cu.
//
// One CTA of bs threads owns one strip of kStrip scalar columns (or rows)
// of one target block T of the pool and computes, in registers,
//   T <- T - sum over p in [p0, p1) of pool[cl[p]] . pool[cu[p]]
// in the order of p, then an optional finalize by a stored inverse:
//   FIN_L: T <- T . uinv[step]   (an L panel)
//   FIN_U: T <- linv[step] . T   (a U panel)
// and writes T once. FIN_L mixes the columns of a row, so its strips are
// strips of whole rows; FIN_NONE and FIN_U (which mixes the rows of a
// column) use strips of whole columns. With p0 == p1 this is the panel
// TRSM by a stored inverse.
//
// Each thread owns a 4x4 tile of the strip. The operand that is read
// along the strip (the U strip, or the L row strip, then T itself for the
// finalize) is staged in shared memory; the other block is read from
// device memory (L2) through the read-only path, which is safe because no
// block that a launch reads is written in that launch (the sources and
// inverses belong to lower elimination levels or to an earlier launch).
// IEEE FP32 throughout; offsets are 64-bit (slot * bs^2 passes 2^31 near
// n = 885k).

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

// acc += A[r0:r0+4, :] . B[:, c0:c0+4]; A is bs x bs in device memory,
// B is bs x kStrip in shared memory.
__device__ __forceinline__ void mul_dev_smem(const float* __restrict__ A,
                                             const float* B, int bs, int r0,
                                             int c0, float acc[4][4]) {
  const float* a0 = A + (int64_t)r0 * bs;
  for (int k = 0; k < bs; k += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = __ldg(reinterpret_cast<const float4*>(a0 + i * bs + k));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b =
          *reinterpret_cast<const float4*>(B + (k + kk) * kStrip + c0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                       : kk == 2 ? a[i].z : a[i].w;
        acc[i][0] += av * b.x;
        acc[i][1] += av * b.y;
        acc[i][2] += av * b.z;
        acc[i][3] += av * b.w;
      }
    }
  }
}

// acc += X[r0:r0+4, :] . B[:, c0:c0+4]; X is kStrip x bs in shared
// memory, B is bs x bs in device memory.
__device__ __forceinline__ void mul_smem_dev(const float* X,
                                             const float* __restrict__ B,
                                             int bs, int r0, int c0,
                                             float acc[4][4]) {
  for (int k = 0; k < bs; ++k) {
    const float4 b =
        __ldg(reinterpret_cast<const float4*>(B + (int64_t)k * bs + c0));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = X[(r0 + i) * bs + k];
      acc[i][0] += a * b.x;
      acc[i][1] += a * b.y;
      acc[i][2] += a * b.z;
      acc[i][3] += a * b.w;
    }
  }
}

// The strip update described at the top of this file, for strip number
// `strip` of the block at `slot`. Launched with blockDim.x == bs.
__device__ __forceinline__ void strip_update(
    float* pool, const float* __restrict__ linv,
    const float* __restrict__ uinv, int64_t slot, int64_t step, int fin,
    const int32_t* __restrict__ cl, const int32_t* __restrict__ cu, int p0,
    int p1, int bs, int strip) {
  __shared__ __align__(16) float S[kMaxBs * kStrip];
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
  float* T = pool + slot * bb + off;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v =
        *reinterpret_cast<const float4*>(T + (int64_t)(r0 + i) * bs + c0);
    acc[i][0] = v.x;
    acc[i][1] = v.y;
    acc[i][2] = v.z;
    acc[i][3] = v.w;
  }

  for (int p = p0; p < p1; ++p) {
    const float* L = pool + (int64_t)cl[p] * bb;
    const float* U = pool + (int64_t)cu[p] * bb;
    __syncthreads();   // every thread is done with the previous strip
    if (rows) {        // rows [strip*kStrip, +kStrip) of L: contiguous
      const float4* src = reinterpret_cast<const float4*>(L + off);
      for (int e = tid; e < kStrip * bs / 4; e += nt)
        reinterpret_cast<float4*>(S)[e] = __ldg(src + e);
    } else {           // columns [strip*kStrip, +kStrip) of U
      for (int e = tid; e < bs * (kStrip / 4); e += nt) {
        const int r = e / (kStrip / 4);
        const int c = (e % (kStrip / 4)) * 4;
        *reinterpret_cast<float4*>(S + r * kStrip + c) = __ldg(
            reinterpret_cast<const float4*>(U + (int64_t)r * bs + off + c));
      }
    }
    __syncthreads();
    float prod[4][4] = {};
    if (rows)
      mul_smem_dev(S, U, bs, r0, c0, prod);
    else
      mul_dev_smem(L, S, bs, r0, c0, prod);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] -= prod[i][j];
  }

  if (fin != FIN_NONE) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(S + (r0 + i) * ld + c0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();
    float out[4][4] = {};
    if (rows)
      mul_smem_dev(S, uinv + step * bb, bs, r0, c0, out);
    else
      mul_dev_smem(linv + step * bb, S, bs, r0, c0, out);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = out[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(T + (int64_t)(r0 + i) * bs + c0) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

}  // namespace slu_strip
