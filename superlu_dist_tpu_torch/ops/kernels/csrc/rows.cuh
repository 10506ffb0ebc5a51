// rows.cuh: block-times-tile products shared by rdma.cu and solve_gemm.cu.
//
// A tile is up to kRT right-hand sides of one block row of X (bs x nrhs,
// row major). Map is how the kThreads threads of a CTA share the product
// of one block with a tile: 16-byte loads of the block through the
// read-only path, eight in flight per thread, the threads' partial sums
// meeting once in shared memory in a fixed order. chunk_sum is the first
// pass of a chunked level sweep (solve_gemm.cu's `solve_gemm`, rdma.cu's
// `rdma_solve_chunks`): the sum of one chunk of a destination's chain.
// The diagonal applies (solve_gemm.cu's pass 2, rdma.cu's
// `rdma_solve_diag`) run Map on a tile staged in shared memory. M is one
// bs x bs block of the pool or of the diagonal inverses; no launch writes
// a block that it reads. Every function is a template on the element type
// T and serves float, double and cplx.cuh's complex64 and complex128 (each
// complex FMA four real ones in a fixed order). The arithmetic is IEEE in
// T (in its real type for complex).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cplx.cuh"

namespace slu_rows {

using slu_cplx::cplx;
using slu_cplx::ldg;

constexpr int kRT = 8;          // right-hand sides per CTA
constexpr int kThreads = 256;   // threads per CTA; every block size divides it

// The dynamic shared memory of a kernel instantiated on T (one raw buffer
// for every instantiation, since extern arrays of different types may not
// share a name).
template <typename T>
__device__ __forceinline__ T* dyn_smem() {
  extern __shared__ __align__(16) unsigned char slu_rows_smem[];
  return reinterpret_cast<T*>(slu_rows_smem);
}

// one 16-byte load through the read-only path into kV = 16 / sizeof(T)
// elements; p is 16-byte aligned
__device__ __forceinline__ void ld16(const float* __restrict__ p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void ld16(const double* __restrict__ p,
                                     double* v) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = a.x;
  v[1] = a.y;
}
template <typename R>
__device__ __forceinline__ void ld16(const cplx<R>* __restrict__ p,
                                     cplx<R>* v) {
  slu_cplx::ld16v(p, v, true);
}

// the right-hand sides per CTA of the level sweeps' tiles: kRT, or 4 for
// the complex types (complex128's pass 2 would need 49,408 bytes of shared
// memory at bs = 128 for tiles of 8, over 48 KiB without opting in, and
// complex64's tiles of 8 spilled at bs = 64)
template <typename T>
constexpr int kRTof = slu_cplx::is_cplx<T> ? 4 : kRT;

// How the kThreads threads of a CTA share the product of one bs x bs
// block M (row major) with a bs x rt tile x (x(k, c) gives its entries).
template <typename T, int BS, bool kTrans>
struct Map {
  static constexpr int kV = 16 / sizeof(T);    // elements per 16-byte load
  static constexpr int kQ = BS / kV;           // 16-byte words per row of M
  // threads that hold partial sums of the same outputs
  static constexpr int kGroups = kTrans ? kThreads / kQ : kThreads / BS;
  static constexpr int kOut = kTrans ? kV : 1;  // outputs per thread
  // 16-byte loads per thread per block
  static constexpr int kSteps = kTrans ? BS / kGroups : kQ / kGroups;
  static constexpr int kLd = BS + kV;          // padded row of `red`
  static_assert(kQ <= kThreads && kSteps >= 1, "block size");

  template <int RT>
  static constexpr int red_elems() {
    return kGroups * RT * kLd > kThreads ? kGroups * RT * kLd : kThreads;
  }

  __device__ static int group() {
    return kTrans ? threadIdx.x / kQ : threadIdx.x / BS;
  }

  // acc += op(M) . x over this thread's share of M.
  //   M^T: thread (j, g) owns outputs i = j*kV .. j*kV + kV-1 and reads
  //        16-byte word j of rows k = g, g + kGroups, ...; a warp reads
  //        consecutive words of a row.
  //   M:   thread (r, h) owns output row r and reads its 16-byte words
  //        j = h, h + kGroups, ...; each lane's words fill whole sectors.
  template <int RT, typename XAt>
  __device__ static void accumulate(const T* __restrict__ M, int rt, XAt x,
                                    T (&acc)[kOut][RT]) {
    const int g = group();
    if constexpr (kTrans) {
      const T* col = M + (threadIdx.x % kQ) * kV;
#pragma unroll 8
      for (int m = 0; m < kSteps; ++m) {
        const int k = g + kGroups * m;
        T a[kV];
        ld16(col + k * BS, a);
#pragma unroll
        for (int c = 0; c < RT; ++c) {
          if (c < rt) {
            const T xv = x(k, c);
#pragma unroll
            for (int v = 0; v < kV; ++v) acc[v][c] = fma(a[v], xv, acc[v][c]);
          }
        }
      }
    } else {
      const T* row = M + (threadIdx.x % BS) * BS;
#pragma unroll 8
      for (int m = 0; m < kSteps; ++m) {
        const int j = g + kGroups * m;
        T a[kV];
        ld16(row + j * kV, a);
#pragma unroll
        for (int v = 0; v < kV; ++v) {
#pragma unroll
          for (int c = 0; c < RT; ++c)
            if (c < rt) acc[0][c] = fma(a[v], x(j * kV + v, c), acc[0][c]);
        }
      }
    }
  }

  // The groups' partial sums meet in `red` and are added in group order;
  // emit(i, c, value) for each output row i and column c < rt. Contains a
  // __syncthreads(): call it from every thread of the CTA.
  template <int RT, typename Emit>
  __device__ static void reduce(const T (&acc)[kOut][RT], int rt, T* red,
                                Emit emit) {
    const int g = group();
    const int i0 = kTrans ? (threadIdx.x % kQ) * kV : threadIdx.x % BS;
#pragma unroll
    for (int c = 0; c < RT; ++c) {
      if (c < rt) {
#pragma unroll
        for (int v = 0; v < kOut; ++v)
          red[(g * RT + c) * kLd + i0 + v] = acc[v][c];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < BS * rt; e += kThreads) {
      const int i = e / rt, c = e - i * rt;
      T s = red[c * kLd + i];
      for (int h = 1; h < kGroups; ++h) s += red[(h * RT + c) * kLd + i];
      emit(i, c, s);
    }
  }
};

// S = sum over p in [p0, p1), in order, of op(pool[cslot[p]]) . X[csrc[p]]
// for the tile of right-hand sides c0 .. c0+RT of X (bs x nrhs blocks);
// emit(i, c, S[i][c]) for each row i and column c of the tile. Uses the
// kernel's dynamic shared memory (Map::red_elems<RT>() elements) and
// contains a __syncthreads(): call it from every thread of the CTA.
template <typename T, int BS, bool kTrans, int RT, typename Emit>
__device__ __forceinline__ void chunk_sum(const T* __restrict__ pool,
                                          const T* __restrict__ X, int p0,
                                          int p1,
                                          const int32_t* __restrict__ cslot,
                                          const int32_t* __restrict__ csrc,
                                          int c0, int nrhs, Emit emit) {
  using M = Map<T, BS, kTrans>;
  const int rt = min(RT, nrhs - c0);
  T acc[M::kOut][RT] = {};
  for (int p = p0; p < p1; ++p) {
    const T* x = X + (int64_t)csrc[p] * BS * nrhs + c0;
    M::template accumulate<RT>(
        pool + (int64_t)cslot[p] * BS * BS, rt,
        [&](int k, int c) { return ldg(x + k * nrhs + c); }, acc);
  }
  M::template reduce<RT>(acc, rt, dyn_smem<T>(), emit);
}

}  // namespace slu_rows
