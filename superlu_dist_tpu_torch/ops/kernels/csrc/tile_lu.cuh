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
// What bounds it: latency on one SM, not bytes or operations (4 tiles of
// 64 KiB and ~2.8 MFLOP at bs = 128). So the design counts barriers and
// the instructions between them.
//
// Design. The forward LU runs right-looking in panels of kPb = 32 columns,
// as _lu_tile_blocked does. Per panel: (a) warp 0 factors the 32x32
// diagonal subtile alone, lane i holding row i in registers and the pivot
// row passed by __shfl_sync, then warps 0 and 1 (joined by a named
// barrier, not a CTA one) form the subtile's inverses li and ui, a column
// per lane; (b) all 16 warps form the L block below, A[rest, p] . ui, and
// the U block to the right, li . A[p, rest], into registers, then write
// them in place after a barrier; (c) the trailing update A[rest, rest] -=
// L . U with k = 32, each warp a register tile of whole rows. Then the
// inverses are two unblocked sweeps sharing one loop of bs - 1 steps and
// one barrier a step: warps 0-7 substitute forward for L^{-1}, warps 8-15
// backward for U^{-1} in the TPU's column-product form (U = (I + C) D,
// C[i][j] = U[i][j] / U[j][j] strictly upper, U^{-1} = D^{-1} (I + C)^{-1}),
// both packed in one square over the tile's shared memory. Barriers per
// tile (CTA-wide): 1 + 4 (bs / 32) - 3 + 2 + (bs - 1), i.e. 143 at bs =
// 128 (the element-by-element form took 640), 71 at 64, 35 at 32, and
// bs / 32 named ones for warps 0-1. Arithmetic is IEEE in T on the CUDA
// cores, each sum in ascending k.
//
// Measured on an H100 (tools/diag_lu_ab.py, tools/diag_lu_phases.py):
// a launch takes one tile's latency, 0.19 ms in float and 0.27-0.30 ms
// in double at bs = 128, half the element-by-element form's; the sweeps,
// one step at a time, hold 53-63% of it.
//
// Shared memory: the tile (then the packed inverses), three padded 32 x 33
// subtiles (the staged LU, li, ui), two double-buffered factor columns and
// the pivots: 79 KiB in float, 158 KiB in double at bs = 128.
//
// The caller launches kTileThreads threads with tile_lu_smem_bytes<T>(bs)
// of dynamic shared memory, CTA b for the tile of slots[b], bs in {32,
// 64, 128}. The last stores of linv[steps[b]] and uinv[steps[b]] are not
// followed by a barrier: synchronise before reading the inverses back.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace slu_tile {

constexpr int kTileThreads = 512;
constexpr int kWarps = kTileThreads / 32;
constexpr int kPb = 32;                 // panel width
constexpr int kPad = kPb + 1;           // row stride of a staged subtile
constexpr int kSub = kPb * kPad;
constexpr unsigned kFull = 0xffffffffu;

// entries of T in one 16-byte shared-memory load
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

// v = p[0 : kVec<T>], p 16-byte aligned: one load (a broadcast when all
// lanes ask for one address)
__device__ __forceinline__ void ldv(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void ldv(const double* p, double (&v)[2]) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  v[0] = x.x;
  v[1] = x.y;
}

template <typename T>
constexpr size_t tile_lu_smem_bytes(int bs) {
  return ((size_t)bs * bs + 3 * kSub + 5 * bs) * sizeof(T);
}

// (a1) Warp 0: the 32x32 subtile D (row stride ld) is factored in place,
// lane i holding row i in registers, the pivot row passed by shuffles; S
// receives a padded copy of its LU. Returns the count of replaced pivots
// (in lane 0). Not inlined: every panel and block size share the code.
template <typename T>
__device__ __noinline__ int subtile_lu(T* __restrict__ D, int ld,
                                       T* __restrict__ S, T thresh) {
  const int lane = threadIdx.x;
  int ntiny = 0;
  // rows of D are read across lanes through S: both accesses conflict-free
#pragma unroll
  for (int i = 0; i < kPb; ++i) S[i * kPad + lane] = D[i * ld + lane];
  __syncwarp();
  T a[kPb];
#pragma unroll
  for (int c = 0; c < kPb; ++c) a[c] = S[lane * kPad + c];
#pragma unroll
  for (int j = 0; j < kPb; ++j) {
    T p = __shfl_sync(kFull, a[j], j);
    const T ap = fabs(p);
    if (ap < thresh) {
      p = ap > T(0) ? copysign(thresh, p) : thresh;
      if (lane == 0) ++ntiny;
    }
    const T l = a[j] / p;
    if (lane == j) a[j] = p;
    if (lane > j) a[j] = l;
#pragma unroll
    for (int c = j + 1; c < kPb; ++c) {
      const T u = __shfl_sync(kFull, a[c], j);
      if (lane > j) a[c] = fma(-l, u, a[c]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < kPb; ++c) S[lane * kPad + c] = a[c];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kPb; ++i) D[i * ld + lane] = S[i * kPad + lane];
  return ntiny;
}

// (a2) Warps 0 and 1, once the LU is in S: lane c of warp 0 forms column c
// of the subtile's L^{-1} into LI, lane c of warp 1 column c of U^{-1}
// into UI (both padded), each a substitution in registers with the
// factor's entries read by broadcast.
template <typename T>
__device__ __noinline__ void subtile_inverses(const T* __restrict__ S,
                                              T* __restrict__ LI,
                                              T* __restrict__ UI) {
  const int c = threadIdx.x & 31;
  T x[kPb];
#pragma unroll
  for (int i = 0; i < kPb; ++i) x[i] = i == c ? T(1) : T(0);
  if (threadIdx.x < 32) {
#pragma unroll
    for (int k = 0; k < kPb - 1; ++k)
#pragma unroll
      for (int i = k + 1; i < kPb; ++i)
        x[i] = fma(-S[i * kPad + k], x[k], x[i]);
#pragma unroll
    for (int i = 0; i < kPb; ++i) LI[i * kPad + c] = x[i];
  } else {
#pragma unroll
    for (int k = kPb - 1; k >= 0; --k) {
      x[k] = x[k] / S[k * kPad + k];
#pragma unroll
      for (int i = 0; i < k; ++i) x[i] = fma(-S[i * kPad + k], x[k], x[i]);
    }
#pragma unroll
    for (int i = 0; i < kPb; ++i) UI[i * kPad + c] = x[i];
  }
}

// (b) The L block A[O+32:, O:O+32] . UI and the U block LI . A[O:O+32,
// O+32:], in place: read into registers, barrier, write, barrier. Warp w
// takes REST / 16 rows of the L block (lane = column) and rows 2w, 2w + 1
// of the U block (lane + 32 q = column); the L block's rows are read
// kVec<T> entries at a time.
template <typename T, int BS, int O>
__device__ __forceinline__ void panel_blocks(T* __restrict__ A,
                                             const T* __restrict__ LI,
                                             const T* __restrict__ UI) {
  constexpr int REST = BS - O - kPb;
  constexpr int RL = REST / kWarps;
  constexpr int CU = REST / 32;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* AL = A + (O + kPb + w * RL) * BS + O;      // this warp's L rows
  T* AU = A + O * BS + O + kPb + lane;          // U block, this lane
  T accL[RL], accU[2][CU];
#pragma unroll
  for (int q = 0; q < RL; ++q) accL[q] = T(0);
#pragma unroll
  for (int q = 0; q < CU; ++q) accU[0][q] = accU[1][q] = T(0);
  constexpr int V = kVec<T>;
#pragma unroll 2
  for (int m0 = 0; m0 < kPb; m0 += V) {
    T al[RL][V];
#pragma unroll
    for (int q = 0; q < RL; ++q) ldv(AL + q * BS + m0, al[q]);
#pragma unroll
    for (int mm = 0; mm < V; ++mm) {
      const int m = m0 + mm;
      const T u = UI[m * kPad + lane];
#pragma unroll
      for (int q = 0; q < RL; ++q) accL[q] = fma(al[q][mm], u, accL[q]);
      const T l0 = LI[(2 * w) * kPad + m], l1 = LI[(2 * w + 1) * kPad + m];
#pragma unroll
      for (int q = 0; q < CU; ++q) {
        const T v = AU[m * BS + 32 * q];
        accU[0][q] = fma(l0, v, accU[0][q]);
        accU[1][q] = fma(l1, v, accU[1][q]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < RL; ++q) AL[q * BS + lane] = accL[q];
#pragma unroll
  for (int q = 0; q < CU; ++q) {
    AU[(2 * w) * BS + 32 * q] = accU[0][q];
    AU[(2 * w + 1) * BS + 32 * q] = accU[1][q];
  }
  __syncthreads();
}

// (c) A[O+32:, O+32:] -= L . U over k = 32, in ascending k: warp w owns
// REST / 16 whole rows (their L entries read kVec<T> at a time), lane +
// 32 c the columns.
template <typename T, int BS, int O>
__device__ __forceinline__ void trailing(T* __restrict__ A) {
  constexpr int REST = BS - O - kPb;
  constexpr int RT = REST / kWarps;
  constexpr int CT = REST / 32;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* L = A + (O + kPb + w * RT) * BS + O;       // this warp's rows, col O
  T* U = A + O * BS + O + kPb + lane;           // U block, this lane
  T* C = L + kPb + lane;                        // this warp's targets
  T acc[RT][CT];
#pragma unroll
  for (int q = 0; q < RT; ++q)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[q][c] = C[q * BS + 32 * c];
  constexpr int V = kVec<T>;
  for (int m0 = 0; m0 < kPb; m0 += V) {
    T l[RT][V];
#pragma unroll
    for (int q = 0; q < RT; ++q) ldv(L + q * BS + m0, l[q]);
#pragma unroll
    for (int mm = 0; mm < V; ++mm) {
      T u[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) u[c] = U[(m0 + mm) * BS + 32 * c];
#pragma unroll
      for (int q = 0; q < RT; ++q)
#pragma unroll
        for (int c = 0; c < CT; ++c)
          acc[q][c] = fma(-l[q][mm], u[c], acc[q][c]);
    }
  }
#pragma unroll
  for (int q = 0; q < RT; ++q)
#pragma unroll
    for (int c = 0; c < CT; ++c) C[q * BS + 32 * c] = acc[q][c];
  __syncthreads();
}

// The panels from column O on: 4 CTA barriers per panel, 1 for the last.
template <typename T, int BS, int O>
__device__ __forceinline__ void panels(T* A, T* S, T* LI, T* UI, T thresh,
                                       int& ntiny) {
  if (threadIdx.x < 32)
    ntiny += subtile_lu<T>(A + O * BS + O, BS, S, thresh);
  if (threadIdx.x < 64) {
    asm volatile("bar.sync 1, 64;" ::: "memory");   // warps 0-1: S is set
    subtile_inverses<T>(S, LI, UI);
  }
  __syncthreads();
  if constexpr (O + kPb < BS) {
    panel_blocks<T, BS, O>(A, LI, UI);
    trailing<T, BS, O>(A);
    panels<T, BS, O + kPb>(A, S, LI, UI, thresh, ntiny);
  }
}

template <typename T, int BS>
__device__ __forceinline__ void tile_lu_bs(T* __restrict__ g,
                                           T* __restrict__ gl,
                                           T* __restrict__ gu, T thresh,
                                           int32_t* __restrict__ tiny) {
  extern __shared__ __align__(16) unsigned char tile_lu_smem[];
  constexpr int bb = BS * BS;
  constexpr int msk = BS - 1;
  constexpr int lg = BS == 32 ? 5 : BS == 64 ? 6 : 7;
  static_assert((1 << lg) == BS, "bs is 32, 64 or 128");
  T* A = reinterpret_cast<T*>(tile_lu_smem);   // the tile, then Z
  T* S = A + bb;                                // staged subtile LU
  T* LI = S + kSub;                             // its L^{-1}
  T* UI = LI + kSub;                            // its U^{-1}
  T* cb = UI + kSub;                            // [2][2][BS] factor columns
  T* dg = cb + 4 * BS;                          // [BS] the pivots
  const int tid = threadIdx.x;

  for (int e = tid; e < bb; e += kTileThreads) A[e] = g[e];
  int ntiny = 0;
  __syncthreads();
  panels<T, BS, 0>(A, S, LI, UI, thresh, ntiny);
  if (tid == 0 && ntiny) atomicAdd(tiny, ntiny);

  // The sweeps build Z: L^{-1} strictly below the diagonal, (I + C)^{-1}
  // strictly above it, and the diagonal of ones they share. Step s: warps
  // 0-7 eliminate row j = s of L^{-1} from the rows below (its columns
  // <= j) with column j of L; warps 8-15 row j = BS-1-s of (I + C)^{-1}
  // from the rows above (its columns >= j) with column j of C. Each
  // factor column is staged in cb one step ahead, read from the LU stored
  // in g. Warp w % 8 takes rows w % 8 + 8 k, lane + 32 q the columns, over
  // the chunks of 32 columns that hold active ones only, four rows at a
  // time (all loads before the stores).
  const int t = tid & (kTileThreads / 2 - 1);  // thread within its half
  const bool lower = tid < kTileThreads / 2;
  for (int e = tid; e < bb; e += kTileThreads) g[e] = A[e];
  if (t < BS) {
    if (lower) {
      dg[t] = A[t * BS + t];
      cb[t] = A[t * BS];                             // L[t][0]
    } else {
      cb[BS + t] = A[t * BS + BS - 1] / A[bb - 1];   // C[t][BS-1]
    }
  }
  __syncthreads();
  for (int e = tid; e < bb; e += kTileThreads)
    A[e] = (e >> lg) == (e & msk) ? T(1) : T(0);
  __syncthreads();

  T* Z = A;
  const int hw = (tid >> 5) & 7, lane = tid & 31;
  for (int s = 0; s < BS - 1; ++s) {
    const int j = lower ? s : BS - 1 - s;
    const int i0 = lower ? j + 1 + hw : hw, i1 = lower ? BS : j;
    const T* f = cb + ((s & 1) * 2 + !lower) * BS;
    // the next step's factor column: loaded now, staged after this step
    const int jn = lower ? j + 1 : j - 1;
    T fn = T(0);
    if (t < BS && s + 2 < BS)
      fn = lower ? g[t * BS + jn] : g[t * BS + jn] / dg[jn];
    const int qa = lower ? 0 : j >> 5, qb = lower ? j >> 5 : BS / 32 - 1;
    for (int q = qa; q <= qb; ++q) {
      const int c = lane + 32 * q;
      const bool act = lower ? c <= j : c >= j;
      const T rj = Z[j * BS + c];
      T* zc = Z + c;
      int i = i0;
      for (; i + 24 < i1; i += 32) {
        T fk[4], r[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          fk[k] = f[i + 8 * k];
          r[k] = zc[(i + 8 * k) * BS];
        }
        if (act)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            zc[(i + 8 * k) * BS] = fma(-fk[k], rj, r[k]);
      }
      for (; i < i1; i += 8) {
        const T fi = f[i], r = zc[i * BS];
        if (act) zc[i * BS] = fma(-fi, rj, r);
      }
    }
    if (t < BS) cb[(((s + 1) & 1) * 2 + !lower) * BS + t] = fn;
    __syncthreads();
  }

  for (int e = tid; e < bb; e += kTileThreads) {
    const int i = e >> lg, c = e & msk;
    gl[e] = c < i ? Z[e] : c == i ? T(1) : T(0);
    gu[e] = c >= i ? Z[e] / dg[i] : T(0);
  }
}

// Not inlined: each CTA calls it once, and the three block sizes are
// compiled into it.
template <typename T>
__device__ __noinline__ void tile_lu(T* __restrict__ pool,
                                     T* __restrict__ linv,
                                     T* __restrict__ uinv,
                                     const int32_t* __restrict__ slots,
                                     const int32_t* __restrict__ steps,
                                     int bs, T thresh,
                                     int32_t* __restrict__ tiny) {
  const int64_t bb = (int64_t)bs * bs;
  T* g = pool + slots[blockIdx.x] * bb;
  T* gl = linv + steps[blockIdx.x] * bb;
  T* gu = uinv + steps[blockIdx.x] * bb;
  switch (bs) {
    case 32: tile_lu_bs<T, 32>(g, gl, gu, thresh, tiny); break;
    case 64: tile_lu_bs<T, 64>(g, gl, gu, thresh, tiny); break;
    case 128: tile_lu_bs<T, 128>(g, gl, gu, thresh, tiny); break;
    default: break;
  }
}

}  // namespace slu_tile
