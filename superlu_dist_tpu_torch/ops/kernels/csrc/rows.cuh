// rows.cuh: block-times-tile products shared by rdma.cu and solve_gemm.cu.
//
// A tile is up to kRT right-hand sides of one block row of X, staged in
// shared memory column major (V[c * bs + k]), so that the threads of a
// warp that walk k read consecutive words. M is one bs x bs block of the
// pool or of the diagonal inverses, read from device memory through the
// read-only path (no launch writes a block that it reads). Every function
// is a template on the element type T (float or double); the arithmetic
// is IEEE in T.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace slu_rows {

constexpr int kRT = 8;          // right-hand sides per CTA
constexpr int kThreads = 256;   // threads per CTA; every block size divides it

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The dynamic shared memory of a kernel instantiated on T (one raw buffer
// for every instantiation, since extern arrays of different types may not
// share a name).
template <typename T>
__device__ __forceinline__ T* dyn_smem() {
  extern __shared__ __align__(16) unsigned char slu_rows_smem[];
  return reinterpret_cast<T*>(slu_rows_smem);
}

// out[r][c] = sum_k M[r][k] * V[c*bs + k] (the product by M): each warp
// walks rows of M with coalesced loads and reduces across its lanes with
// shuffles; lane 0 hands each row's sums to emit(r, sums).
template <typename T, typename Emit>
__device__ __forceinline__ void rows_times(const T* __restrict__ M,
                                           const T* V, int bs, int rt,
                                           Emit emit) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int r = warp; r < bs; r += nw) {
    T part[kRT];
#pragma unroll
    for (int c = 0; c < kRT; ++c) part[c] = T(0);
    const T* m = M + (int64_t)r * bs;
    for (int k = lane; k < bs; k += 32) {
      const T a = __ldg(m + k);
#pragma unroll
      for (int c = 0; c < kRT; ++c)
        if (c < rt) part[c] += a * V[c * bs + k];
    }
#pragma unroll
    for (int c = 0; c < kRT; ++c)
      if (c < rt) part[c] = warp_sum(part[c]);
    if (lane == 0) emit(r, part);
  }
}

// out[i][c] = sum_k M[k][i] * V[c*bs + k] (the product by M^T): thread t
// owns output row i = t % bs and sums the k of its group g = t / bs (k = g,
// g + ng, ..., ng = blockDim / bs groups), so the threads of a warp read
// consecutive words of row k of M (coalesced, no transpose in shared
// memory), every word of M is read once, and V's word is a broadcast. The
// groups' partial sums meet in `red` (kRT * blockDim elements of shared
// memory) and group 0 adds them in the order of g and hands each (i, c) to
// emit(i, c, value). Contains a __syncthreads(): call it from every thread
// of the CTA, and synchronise again before `red` is reused.
template <typename T, typename Emit>
__device__ __forceinline__ void cols_times(const T* __restrict__ M,
                                           const T* V, int bs, int rt,
                                           T* red, Emit emit) {
  const int i = threadIdx.x % bs;
  const int g = threadIdx.x / bs;
  const int ng = blockDim.x / bs;
  T part[kRT];
#pragma unroll
  for (int c = 0; c < kRT; ++c) part[c] = T(0);
#pragma unroll 4
  for (int k = g; k < bs; k += ng) {
    const T a = __ldg(M + (int64_t)k * bs + i);
#pragma unroll
    for (int c = 0; c < kRT; ++c)
      if (c < rt) part[c] += a * V[c * bs + k];
  }
#pragma unroll
  for (int c = 0; c < kRT; ++c)
    if (c < rt) red[(c * ng + g) * bs + i] = part[c];
  __syncthreads();
  if (g != 0) return;
#pragma unroll
  for (int c = 0; c < kRT; ++c) {
    if (c < rt) {
      T s = part[c];
      for (int h = 1; h < ng; ++h) s += red[(c * ng + h) * bs + i];
      emit(i, c, s);
    }
  }
}

// Stage X[I]'s tile (bs x rt of a row-major bs x nrhs block) column major
// into shared memory; the caller synchronises.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* XI, int bs,
                                          int rt, int nrhs) {
  for (int e = threadIdx.x; e < bs * rt; e += blockDim.x) {
    const int r = e / rt, c = e - r * rt;
    dst[c * bs + r] = XI[(int64_t)r * nrhs + c];
  }
}

}  // namespace slu_rows
