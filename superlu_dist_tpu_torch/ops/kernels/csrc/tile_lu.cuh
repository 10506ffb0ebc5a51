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
//   sign(p)*thresh (complex: (p/|p|)*thresh; +thresh at p == 0) and is
//   counted (ReplaceTinyPivot, reference pdgstrf2.c). The compact LU goes
//   back into the tile,
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
// the pivots: 79 KiB in float, 158 KiB in double and complex64 at bs = 128.
//
// Complex (cplx.cuh's element type; the threshold stays real, and a tiny
// pivot keeps its phase) differs in two places:
// - registers: warp 0's 32 x 32 LU and the subtile's inverses keep their
//   rows and columns in the padded subtiles in shared memory instead of
//   32 complex registers a lane (512 threads may hold 128 registers each;
//   complex64 held there spilled 44 bytes, as double spills 88), and the
//   trailing update takes a warp's rows in two passes; every sum keeps
//   its order;
// - shared memory at bs = 128 in complex128: the tile alone is 256 KiB,
//   over the 227 KiB
//   a CTA may have. There the forward LU works on the tile in place in
//   the pool (device memory, which L2 holds for the CTA), with only the
//   subtiles, factor columns and pivots in shared memory (61 KiB), and
//   the sweeps build their packed inverses in place in linv[step], which
//   the last pass splits into L^{-1} and U^{-1}. tile_in_shared<T>(bs)
//   tells the two layouts apart.
//
// The caller launches kTileThreads threads with tile_lu_smem_bytes<T>(bs)
// of dynamic shared memory, CTA b for the tile of slots[b], bs in {32,
// 64, 128}. The last stores of linv[steps[b]] and uinv[steps[b]] are not
// followed by a barrier: synchronise before reading the inverses back.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cplx.cuh"

namespace slu_tile {

using slu_cplx::cplx;
using slu_cplx::ld16v;
using slu_cplx::replace_tiny;
using slu_cplx::shfl;
template <typename T>
using real_t = slu_cplx::real_t<T>;

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
__device__ __forceinline__ void ldv(const cplx<float>* p,
                                    cplx<float> (&v)[2]) {
  ld16v(p, v);
}
__device__ __forceinline__ void ldv(const cplx<double>* p,
                                    cplx<double> (&v)[1]) {
  ld16v(p, v);
}

// the shared memory a CTA may have on an H100
constexpr size_t kMaxSmem = 227 * 1024;

// whether the tile of T at block size bs fits in shared memory beside the
// rest (else it stays in the pool: complex128 at bs = 128)
template <typename T>
__host__ __device__ constexpr bool tile_in_shared(int bs) {
  return ((size_t)bs * bs + 3 * kSub + 5 * bs) * sizeof(T) <= kMaxSmem;
}

template <typename T>
__host__ __device__ constexpr size_t tile_lu_smem_bytes(int bs) {
  return ((tile_in_shared<T>(bs) ? (size_t)bs * bs : 0) + 3 * kSub +
          5 * bs) * sizeof(T);
}

// whether T keeps warp 0's subtile rows and the inverses' columns in
// shared memory rather than in registers (the complex types)
template <typename T>
constexpr bool kRowsShared = slu_cplx::is_cplx<T>;

// (a1) Warp 0: the 32x32 subtile D (row stride ld) is factored in place,
// lane i holding row i in registers, the pivot row passed by shuffles; S
// receives a padded copy of its LU. Returns the count of replaced pivots
// (in lane 0). Not inlined: every panel and block size share the code.
template <typename T>
__device__ __noinline__ int subtile_lu(T* __restrict__ D, int ld,
                                       T* __restrict__ S,
                                       real_t<T> thresh) {
  const int lane = threadIdx.x;
  int ntiny = 0;
  // rows of D are read across lanes through S: both accesses conflict-free
#pragma unroll
  for (int i = 0; i < kPb; ++i) S[i * kPad + lane] = D[i * ld + lane];
  __syncwarp();
  if constexpr (kRowsShared<T>) {
    // lane i updates row i of S in place; row j is read by broadcast
    T* a = S + lane * kPad;
    for (int j = 0; j < kPb; ++j) {
      T p = S[j * kPad + j];
      if (replace_tiny(p, thresh) && lane == 0) ++ntiny;
      const T l = a[j] / p;
      __syncwarp();   // every lane has read the pivot
      if (lane == j) a[j] = p;
      if (lane > j) {
        a[j] = l;
        for (int c = j + 1; c < kPb; ++c)
          a[c] = fma(-l, S[j * kPad + c], a[c]);
      }
      __syncwarp();
    }
  } else {
    T a[kPb];
#pragma unroll
    for (int c = 0; c < kPb; ++c) a[c] = S[lane * kPad + c];
#pragma unroll
    for (int j = 0; j < kPb; ++j) {
      T p = shfl(kFull, a[j], j);
      if (replace_tiny(p, thresh) && lane == 0) ++ntiny;
      const T l = a[j] / p;
      if (lane == j) a[j] = p;
      if (lane > j) a[j] = l;
#pragma unroll
      for (int c = j + 1; c < kPb; ++c) {
        const T u = shfl(kFull, a[c], j);
        if (lane > j) a[c] = fma(-l, u, a[c]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kPb; ++c) S[lane * kPad + c] = a[c];
  }
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
  if constexpr (kRowsShared<T>) {
    // column c of the inverse in place in LI or UI, the same sums in the
    // same order
    T* x = (threadIdx.x < 32 ? LI : UI) + c;
    for (int i = 0; i < kPb; ++i) x[i * kPad] = i == c ? T(1) : T(0);
    if (threadIdx.x < 32) {
      for (int k = 0; k < kPb - 1; ++k) {
        const T xk = x[k * kPad];
        for (int i = k + 1; i < kPb; ++i)
          x[i * kPad] = fma(-S[i * kPad + k], xk, x[i * kPad]);
      }
    } else {
      for (int k = kPb - 1; k >= 0; --k) {
        const T xk = x[k * kPad] / S[k * kPad + k];
        x[k * kPad] = xk;
        for (int i = 0; i < k; ++i)
          x[i * kPad] = fma(-S[i * kPad + k], xk, x[i * kPad]);
      }
    }
  } else {
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
        for (int i = 0; i < k; ++i)
          x[i] = fma(-S[i * kPad + k], x[k], x[i]);
      }
#pragma unroll
      for (int i = 0; i < kPb; ++i) UI[i * kPad + c] = x[i];
    }
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
  // complex keeps one step of loads in flight (two spilled complex64)
  constexpr int PU = kRowsShared<T> ? 1 : 2;
#pragma unroll (PU)
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
  constexpr int RW = REST / kWarps;             // this warp's rows
  constexpr int CT = REST / 32;
  // rows per pass: complex128 takes a warp's rows in two passes
  constexpr int RT = kRowsShared<T> && RW % 2 == 0 ? RW / 2 : RW;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* U = A + O * BS + O + kPb + lane;           // U block, this lane
#pragma unroll 1
  for (int r0 = 0; r0 < RW; r0 += RT) {
    T* L = A + (O + kPb + w * RW + r0) * BS + O;  // the pass's rows, col O
    T* C = L + kPb + lane;                        // this pass's targets
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
  }
  __syncthreads();
}

// The panels from column O on: 4 CTA barriers per panel, 1 for the last.
template <typename T, int BS, int O>
__device__ __forceinline__ void panels(T* A, T* S, T* LI, T* UI,
                                       real_t<T> thresh, int& ntiny) {
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
                                           T* __restrict__ gu,
                                           real_t<T> thresh,
                                           int32_t* __restrict__ tiny) {
  extern __shared__ __align__(16) unsigned char tile_lu_smem[];
  constexpr int bb = BS * BS;
  constexpr int msk = BS - 1;
  constexpr int lg = BS == 32 ? 5 : BS == 64 ? 6 : 7;
  static_assert((1 << lg) == BS, "bs is 32, 64 or 128");
  // the tile in shared memory, or in place in the pool (the header says
  // when)
  constexpr bool kSh = tile_in_shared<T>(BS);
  T* base = reinterpret_cast<T*>(tile_lu_smem);
  T* A = kSh ? base : g;                        // the tile
  T* S = kSh ? base + bb : base;                // staged subtile LU
  T* LI = S + kSub;                             // its L^{-1}
  T* UI = LI + kSub;                            // its U^{-1}
  T* cb = UI + kSub;                            // [2][2][BS] factor columns
  T* dg = cb + 4 * BS;                          // [BS] the pivots
  const int tid = threadIdx.x;

  if constexpr (kSh)
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
  // the chunks of 32 columns that hold active ones only, KB rows at a
  // time (all loads before the stores; four, two for complex).
  const int t = tid & (kTileThreads / 2 - 1);  // thread within its half
  const bool lower = tid < kTileThreads / 2;
  if constexpr (kSh)
    for (int e = tid; e < bb; e += kTileThreads) g[e] = A[e];
  if (t < BS) {
    if (lower) {
      dg[t] = A[t * BS + t];
      cb[t] = A[t * BS];                             // L[t][0]
    } else {
      cb[BS + t] = A[t * BS + BS - 1] / A[bb - 1];   // C[t][BS-1]
    }
  }
  // Z: in the tile's shared memory, or in place in linv[step]
  T* Z = kSh ? A : gl;
  constexpr int KB = kRowsShared<T> ? 2 : 4;
  __syncthreads();
  for (int e = tid; e < bb; e += kTileThreads)
    Z[e] = (e >> lg) == (e & msk) ? T(1) : T(0);
  __syncthreads();

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
      for (; i + 8 * (KB - 1) < i1; i += 8 * KB) {
        T fk[KB], r[KB];
#pragma unroll
        for (int k = 0; k < KB; ++k) {
          fk[k] = f[i + 8 * k];
          r[k] = zc[(i + 8 * k) * BS];
        }
        if (act)
#pragma unroll
          for (int k = 0; k < KB; ++k)
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
    const T z = Z[e];
    gl[e] = c < i ? z : c == i ? T(1) : T(0);
    gu[e] = c >= i ? z / dg[i] : T(0);
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
                                     int bs, real_t<T> thresh,
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
