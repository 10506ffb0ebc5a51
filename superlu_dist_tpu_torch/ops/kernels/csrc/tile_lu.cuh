// tile_lu.cuh: no-pivot LU with both triangular inverses of one diagonal
// tile, run by one CTA; shared by diag_lu.cu and rdma.cu.
//
// Replaces: superlu_dist_tpu/ops/kernels/flk.py::_lu_tile_blocked (with
// _lu_tile_inkernel), the device function that clk, tck, flk and the 2D
// RDMA factor run on each diagonal block on the TPU.
//
// What it computes, for the tile g = pool[slots[b]] of CTA b (bs x bs, row
// major):
//   Doolittle LU without pivoting; a pivot with |p| < thresh becomes
//   sign(p)*thresh (+thresh at p == 0) and is counted (ReplaceTinyPivot,
//   reference pdgstrf2.c). The compact LU goes back into the tile,
//   L^{-1} into linv[steps[b]] and U^{-1} into uinv[steps[b]], and the
//   count of replaced pivots is added to *tiny.
//
// The tile and the inverse being built live in dynamic shared memory
// (2 x 64 KiB at bs=128), so the bs steps touch device memory only to
// load the tile and store the three results. L^{-1} is accumulated in the
// same forward sweep (each elimination step applies the same rank-1
// update to it); U^{-1} follows by a right-looking backward sweep.
// Arithmetic is IEEE in T. In double the tile and an inverse would take
// 2 x 128 KiB at bs=128, above the 227 KiB a block may have, so with
// kInvSmem = false only the tile (and the L column) stays in shared
// memory and each inverse is built in place in its output block (device
// memory, L2-resident: 128 KiB per tile).
//
// The caller launches kTileThreads threads with tile_lu_smem_bytes<T,
// kInvSmem>(bs) of dynamic shared memory, CTA b for the tile of
// slots[b]. The last stores of uinv[steps[b]] are not followed by a
// barrier: synchronise before reading the inverses back.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace slu_tile {

constexpr int kTileThreads = 512;

template <typename T, bool kInvSmem>
constexpr size_t tile_lu_smem_bytes(int bs) {
  return (size_t)((kInvSmem ? 2 : 1) * bs * bs + bs) * sizeof(T);
}

// Not inlined: each CTA calls it once, and inlined into diag_lu's float
// kernel the compiler scheduled it ~7% slower than the kernel body it came
// from; as a function of its own it runs as fast as that body (an H100,
// superlu_dist_tpu_torch/tools/diag_lu_ab.py).
template <typename T, bool kInvSmem>
__device__ __noinline__ void tile_lu(T* __restrict__ pool,
                                        T* __restrict__ linv,
                                        T* __restrict__ uinv,
                                        const int32_t* __restrict__ slots,
                                        const int32_t* __restrict__ steps,
                                        int bs, int lg, T thresh,
                                        int32_t* __restrict__ tiny) {
  extern __shared__ __align__(16) unsigned char tile_lu_smem[];
  const int bb = bs * bs;
  T* A = reinterpret_cast<T*>(tile_lu_smem);   // bs*bs: the tile, LU in place
  T* lcol = A + (kInvSmem ? 2 * bb : bb);      // bs: column of L at step j
  __shared__ T piv_s;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int msk = bs - 1;
  T* g = pool + (int64_t)slots[blockIdx.x] * bb;
  const int64_t step = steps[blockIdx.x];
  T* gl = linv + step * bb;
  T* gu = uinv + step * bb;
  T* R = kInvSmem ? A + bb : gl;               // bs*bs: L^{-1}, then U^{-1}

  for (int e = tid; e < bb; e += nt) {
    A[e] = g[e];
    R[e] = ((e >> lg) == (e & msk)) ? T(1) : T(0);
  }
  int ntiny = 0;
  __syncthreads();

  for (int j = 0; j < bs; ++j) {
    if (tid == 0) {
      T p = A[j * bs + j];
      const T ap = fabs(p);
      if (ap < thresh) {
        p = ap > T(0) ? copysign(thresh, p) : thresh;
        A[j * bs + j] = p;
        ++ntiny;
      }
      piv_s = p;
    }
    __syncthreads();
    const T p = piv_s;
    for (int i = j + 1 + tid; i < bs; i += nt) lcol[i] = A[i * bs + j] / p;
    __syncthreads();
    // rows below j: trailing update of A right of j, the rank-1 update of
    // L^{-1} left of and at j, and the L entry itself at column j
    const int cnt = (bs - j - 1) * bs;
    for (int e = tid; e < cnt; e += nt) {
      const int i = j + 1 + (e >> lg);
      const int c = e & msk;
      const T l = lcol[i];
      if (c > j) {
        A[i * bs + c] -= l * A[j * bs + c];
      } else {
        if (c == j) A[i * bs + j] = l;
        R[i * bs + c] -= l * R[j * bs + c];
      }
    }
    __syncthreads();
  }

  if (!kInvSmem) R = gu;
  for (int e = tid; e < bb; e += nt) {
    g[e] = A[e];
    if (kInvSmem) gl[e] = R[e];
    R[e] = ((e >> lg) == (e & msk)) ? T(1) : T(0);
  }
  if (tid == 0 && ntiny) atomicAdd(tiny, ntiny);
  __syncthreads();

  // U X = I by right-looking back substitution: row j of X is final once
  // divided by U[j][j]; then it is eliminated from the rows above.
  for (int j = bs - 1; j >= 0; --j) {
    const T d = A[j * bs + j];
    for (int c = j + tid; c < bs; c += nt) R[j * bs + c] /= d;
    __syncthreads();
    const int w = bs - j;
    const int cnt = j * w;
    for (int e = tid; e < cnt; e += nt) {
      const int i = e / w;
      const int c = j + (e - i * w);
      R[i * bs + c] -= A[i * bs + j] * R[j * bs + c];
    }
    __syncthreads();
  }
  if (kInvSmem)
    for (int e = tid; e < bb; e += nt) gu[e] = R[e];
}

// log2 of a power-of-two block size
inline int log2_bs(int bs) {
  int lg = 0;
  while ((1 << lg) < bs) ++lg;
  return lg;
}

}  // namespace slu_tile
