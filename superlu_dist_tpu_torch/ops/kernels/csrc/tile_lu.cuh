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
// Design, as _lu_tile_blocked: (1) the forward LU, right-looking in
// panels of kPb = 32 columns. Per panel: (a) warp 0 factors the 32x32
// diagonal subtile alone, lane i holding row i in registers and the pivot
// row passed by __shfl_sync, then warps 0 and 1 (joined by a named
// barrier, not a CTA one) form the subtile's inverses li_p and ui_p, a
// column per lane, and keep them in shared memory to the end; (b) all 16
// warps form the L block below, A[rest, p] . ui_p, and the U block to the
// right, li_p . A[p, rest], into registers, then write them in place after
// a barrier; (c) the trailing update A[rest, rest] -= L . U with k = 32,
// each warp a register tile of whole rows. (2) The compact LU goes back to
// the pool and each li_p, ui_p into the diagonal blocks of linv[step],
// uinv[step], then a barrier. (3) The inverses' other blocks by block
// substitution over the P = bs / 32 panels, as flk.py:409-430 build them:
//   L^{-1}(p, r) = L(p, p)^{-1} . (-sum_{q = r}^{p-1} L(p, q) . L^{-1}(q, r)),
//   U^{-1}(p, r) = U(p, p)^{-1} . (-sum_{q = p+1}^{r} U(p, q) . U^{-1}(q, r)),
// q ascending, by block distance |p - r| = 1 .. P - 1: the blocks at one
// distance are independent, two warps each (a half of its columns), the
// even warps on L^{-1} and the odd ones on U^{-1}, a barrier between
// distances. A lane holds 16 rows of a column of the sum in registers
// (strides known at compile time; float sums in double, rounded once),
// writes them to the mirrored block (r, p) of its output, which is zero
// in the result; one lane a column then solves with the diagonal block by
// substitution, as the plain version does (complex, whose column would
// spill a lane's registers, multiplies by li_p or ui_p as flk.py does),
// and the sum's block is zeroed. A tile with pivot growth showed why: the
// product by the computed li_p and float sums lost to the plain version's
// accuracy on the card. Barriers per tile (CTA-wide): 1 + (4P - 3) + (P -
// 1) = 5P - 3, i.e. 17 at bs = 128, 7 at 64 and 2 at 32 (two unblocked
// sweeps of bs - 1 steps had 143, 71 and 35), and P named ones for warps
// 0-1. Arithmetic is IEEE on the CUDA cores, each sum in a fixed order
// (ascending k within ascending q), no atomics in a sum.
//
// Shared memory (tile_lu_smem_bytes): the tile, the staged subtile LU
// (32 x 33, padded) and the 2P subtile inverses (32 x 32 each): 100 KiB
// in float, 200 KiB in double and complex64 at bs = 128, of the 227 KiB
// a CTA may have. L^{-1} and U^{-1} are built in device memory, where
// they end, read back by the later distances through L1 and L2.
//
// Complex (cplx.cuh's element type; the threshold stays real, and a tiny
// pivot keeps its phase) differs in three places:
// - registers: warp 0's 32 x 32 LU and the subtile's inverses keep their
//   rows and columns in shared memory instead of 32 complex registers a
//   lane (512 threads may hold 128 registers each; complex64 held there
//   spilled 44 bytes, as double spills 88), and the trailing update takes
//   a warp's rows in two passes; every sum keeps its order;
// - complex128's block substitution takes a lane's 16 rows in two passes
//   of 8 (32 registers of sums, as the other types' one pass);
// - shared memory at bs = 128 in complex128: the tile alone is 256 KiB,
//   over the 227 KiB a CTA may have. There the forward LU works on the
//   tile in place in the pool (device memory, which L2 holds for the CTA),
//   with only the staged LU and the 8 subtile inverses in shared memory
//   (144.5 KiB). tile_in_shared<T>(bs) tells the two layouts apart.
//
// tools/diag_lu_phases.py cuts a launch at the line that adds the tiny
// count (the forward LU done) and at the comment that opens (e), the
// block substitution (the LU and the diagonal inverses stored).
//
// The caller launches kTileThreads threads with tile_lu_smem_bytes<T>(bs)
// of dynamic shared memory, CTA b for the tile of slots[b], bs in {32,
// 64, 128}. The last stores of linv[steps[b]] and uinv[steps[b]] are not
// followed by a barrier: synchronise before reading the inverses back.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
constexpr int kSq = kPb * kPb;          // a subtile inverse (unpadded)
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

// the staged subtile LU and the 2 (bs / kPb) subtile inverses, elements
__host__ __device__ constexpr size_t subtile_elems(int bs) {
  return kSub + 2 * (size_t)(bs / kPb) * kSq;
}

// whether the tile of T at block size bs fits in shared memory beside the
// rest (else it stays in the pool: complex128 at bs = 128)
template <typename T>
__host__ __device__ constexpr bool tile_in_shared(int bs) {
  return ((size_t)bs * bs + subtile_elems(bs)) * sizeof(T) <= kMaxSmem;
}

template <typename T>
__host__ __device__ constexpr size_t tile_lu_smem_bytes(int bs) {
  return ((tile_in_shared<T>(bs) ? (size_t)bs * bs : 0) +
          subtile_elems(bs)) * sizeof(T);
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
// into UI (both 32 x 32, row major), each a substitution in registers
// with the factor's entries read by broadcast.
template <typename T>
__device__ __noinline__ void subtile_inverses(const T* __restrict__ S,
                                              T* __restrict__ LI,
                                              T* __restrict__ UI) {
  const int c = threadIdx.x & 31;
  if constexpr (kRowsShared<T>) {
    // column c of the inverse in place in LI or UI, the same sums in the
    // same order
    T* x = (threadIdx.x < 32 ? LI : UI) + c;
    for (int i = 0; i < kPb; ++i) x[i * kPb] = i == c ? T(1) : T(0);
    if (threadIdx.x < 32) {
      for (int k = 0; k < kPb - 1; ++k) {
        const T xk = x[k * kPb];
        for (int i = k + 1; i < kPb; ++i)
          x[i * kPb] = fma(-S[i * kPad + k], xk, x[i * kPb]);
      }
    } else {
      for (int k = kPb - 1; k >= 0; --k) {
        const T xk = x[k * kPb] / S[k * kPad + k];
        x[k * kPb] = xk;
        for (int i = 0; i < k; ++i)
          x[i * kPb] = fma(-S[i * kPad + k], xk, x[i * kPb]);
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
      for (int i = 0; i < kPb; ++i) LI[i * kPb + c] = x[i];
    } else {
#pragma unroll
      for (int k = kPb - 1; k >= 0; --k) {
        x[k] = x[k] / S[k * kPad + k];
#pragma unroll
        for (int i = 0; i < k; ++i)
          x[i] = fma(-S[i * kPad + k], x[k], x[i]);
      }
#pragma unroll
      for (int i = 0; i < kPb; ++i) UI[i * kPb + c] = x[i];
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
      const T u = UI[m * kPb + lane];
#pragma unroll
      for (int q = 0; q < RL; ++q) accL[q] = fma(al[q][mm], u, accL[q]);
      const T l0 = LI[(2 * w) * kPb + m], l1 = LI[(2 * w + 1) * kPb + m];
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
// Panel p's inverses go to LI + p kSq and UI + p kSq.
template <typename T, int BS, int O>
__device__ __forceinline__ void panels(T* A, T* S, T* LI, T* UI,
                                       real_t<T> thresh, int& ntiny) {
  T* li = LI + (O / kPb) * kSq;
  T* ui = UI + (O / kPb) * kSq;
  if (threadIdx.x < 32)
    ntiny += subtile_lu<T>(A + O * BS + O, BS, S, thresh);
  if (threadIdx.x < 64) {
    asm volatile("bar.sync 1, 64;" ::: "memory");   // warps 0-1: S is set
    subtile_inverses<T>(S, li, ui);
  }
  __syncthreads();
  if constexpr (O + kPb < BS) {
    panel_blocks<T, BS, O>(A, li, ui);
    trailing<T, BS, O>(A);
    panels<T, BS, O + kPb>(A, S, LI, UI, thresh, ntiny);
  }
}

// rows of a pass of inverse_block (a lane's 16, or 8 in complex128: at
// most 32 registers of sums) and entries of the right factor's column a
// lane loads a step ahead of their products (at most 32 registers in
// flight)
template <typename T>
constexpr int kRp = sizeof(T) == 16 ? kPb / 4 : kPb / 2;
template <typename T>
constexpr int kKc = sizeof(T) == 16 ? 2 : 8;

// the type inverse_block sums in: double for float (the sum is rounded
// to float once, where it is stored; a block's sum has up to 96 terms,
// and a tile with growth cancels them), T otherwise
template <typename T>
using acc_t = typename std::conditional<std::is_same<T, float>::value,
                                        double, T>::type;

// acc[i] += (NEG ? -1 : 1) . M[i][k] . x[k * LDX], i < R, k ascending over
// 0 .. 31: M's rows (row stride LDM, 16-byte aligned) read kVec<T>
// entries at a time by broadcast; x is this lane's column, kKc<T> entries
// loaded a step ahead of their products.
template <typename T, int R, int LDM, int LDX, bool NEG>
__device__ __forceinline__ void mac(acc_t<T> (&acc)[R], const T* M,
                                    const T* x) {
  using S = acc_t<T>;
  constexpr int V = kVec<T>, KC = kKc<T>;
  T xv[KC];
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) xv[kk] = x[kk * LDX];
#pragma unroll
  for (int k0 = 0; k0 < kPb; k0 += KC) {
    T xn[KC];
    if (k0 + KC < kPb)
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) xn[kk] = x[(k0 + KC + kk) * LDX];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k1 = 0; k1 < KC; k1 += V) {
        T m[V];
        ldv(M + i * LDM + k0 + k1, m);
#pragma unroll
        for (int kk = 0; kk < V; ++kk)
          acc[i] = fma(S(NEG ? -m[kk] : m[kk]), S(xv[k1 + kk]), acc[i]);
      }
    if (k0 + KC < kPb)
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) xv[kk] = xn[kk];
  }
}

// whether inverse_block solves with the diagonal block by substitution,
// a lane's column in registers (float and double; a lane's 32 complex
// entries spill), or multiplies by its inverse
template <typename T>
constexpr bool kSolve = !slu_cplx::is_cplx<T>;

// (e) One 32 x 32 block (p, r) of an inverse Z (device memory, row stride
// BS), half h of its columns by one warp:
//   Z(p, r) = F(p, p)^{-1} . (-sum_{q = qa}^{qb} F(p, q) . Z(q, r)),
// q ascending, with F the tile's compact LU (row stride BS): L's blocks
// (F(p, p) unit lower) for L^{-1}, U's for U^{-1} (up). Lane l takes
// column 16 h + l % 16 and rows 16 (l / 16) .. + 15 of the sum, kRp<T>
// at a time, which goes through the mirrored block Z(r, p), zero in the
// result. Then lanes 0-15 each solve F(p, p) x = sum for their column by
// substitution, as the plain version does (complex: E_p . sum, E the
// side's subtile inverses in shared memory), and the sum's block is
// zeroed. Z(q, r) for q = r is the diagonal block stored before.
template <typename T, int BS>
__device__ __forceinline__ void inverse_block(const T* A, T* Z, const T* E,
                                              bool up, int p, int r,
                                              int qa, int qb, int h) {
  constexpr int R = kRp<T>;
  const int lane = threadIdx.x & 31;
  const int c = 16 * h + (lane & 15), r1 = (kPb / 2) * (lane >> 4);
  T* sum = Z + (r * kPb) * BS + p * kPb + c;
  T* out = Z + (p * kPb) * BS + r * kPb + c;
#pragma unroll 1
  for (int r0 = r1; r0 < r1 + kPb / 2; r0 += R) {
    acc_t<T> acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = acc_t<T>(0);
#pragma unroll 1
    for (int q = qa; q <= qb; ++q)
      mac<T, R, BS, BS, true>(acc, A + (p * kPb + r0) * BS + q * kPb,
                              Z + (q * kPb) * BS + r * kPb + c);
#pragma unroll
    for (int i = 0; i < R; ++i) sum[(r0 + i) * BS] = T(acc[i]);
  }
  __syncwarp();
  if constexpr (kSolve<T>) {
    if (lane < 16) {
      const T* F = A + (p * kPb) * BS + p * kPb;    // the diagonal block
      T x[kPb];
#pragma unroll
      for (int i = 0; i < kPb; ++i) x[i] = sum[i * BS];
      if (!up) {
#pragma unroll
        for (int k = 0; k < kPb - 1; ++k)
#pragma unroll
          for (int i = k + 1; i < kPb; ++i)
            x[i] = fma(-F[i * BS + k], x[k], x[i]);
      } else {
#pragma unroll
        for (int k = kPb - 1; k >= 0; --k) {
          x[k] = x[k] / F[k * BS + k];
#pragma unroll
          for (int i = 0; i < k; ++i)
            x[i] = fma(-F[i * BS + k], x[k], x[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kPb; ++i) out[i * BS] = x[i];
    }
  } else {
#pragma unroll 1
    for (int r0 = r1; r0 < r1 + kPb / 2; r0 += R) {
      T acc[R];
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] = T(0);
      mac<T, R, kPb, BS, false>(acc, E + p * kSq + r0 * kPb, sum);
#pragma unroll
      for (int i = 0; i < R; ++i) out[(r0 + i) * BS] = acc[i];
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = r1; i < r1 + kPb / 2; ++i) sum[i * BS] = T(0);
}

template <typename T, int BS>
__device__ __forceinline__ void tile_lu_bs(T* __restrict__ g,
                                           T* __restrict__ gl,
                                           T* __restrict__ gu,
                                           real_t<T> thresh,
                                           int32_t* __restrict__ tiny) {
  extern __shared__ __align__(16) unsigned char tile_lu_smem[];
  constexpr int bb = BS * BS;
  constexpr int P = BS / kPb;
  static_assert(P * kPb == BS && P <= 4, "bs is 32, 64 or 128");
  // the tile in shared memory, or in place in the pool (the header says
  // when)
  constexpr bool kSh = tile_in_shared<T>(BS);
  T* base = reinterpret_cast<T*>(tile_lu_smem);
  T* A = kSh ? base : g;                        // the tile
  T* S = kSh ? base + bb : base;                // staged subtile LU
  T* LI = S + kSub;                             // [P] panels' L^{-1}
  T* UI = LI + P * kSq;                         // [P] panels' U^{-1}
  const int tid = threadIdx.x;

  if constexpr (kSh)
    for (int e = tid; e < bb; e += kTileThreads) A[e] = g[e];
  int ntiny = 0;
  __syncthreads();
  panels<T, BS, 0>(A, S, LI, UI, thresh, ntiny);
  if (tid == 0 && ntiny) atomicAdd(tiny, ntiny);

  // The compact LU back to the pool; each panel's inverses into the
  // diagonal blocks, with their exact zeros and unit diagonal, which (e)
  // reads after the barrier.
  if constexpr (kSh)
    for (int e = tid; e < bb; e += kTileThreads) g[e] = A[e];
  for (int e = tid; e < P * kSq; e += kTileThreads) {
    const int p = e / kSq, i = (e / kPb) % kPb, c = e % kPb;
    const int o = (p * kPb + i) * BS + p * kPb + c;
    gl[o] = c > i ? T(0) : c == i ? T(1) : LI[e];
    gu[o] = c < i ? T(0) : UI[e];
  }
  if constexpr (P > 1) __syncthreads();
  // (e) the block substitution, stage by stage
  const int w = tid >> 5, j = w >> 2;
  const bool up = w & 1;                        // odd warps: U^{-1}
  for (int d = 1; d < P; ++d) {
    if (j < P - d) {
      const int p = up ? j : j + d, r = up ? j + d : j;
      inverse_block<T, BS>(A, up ? gu : gl, up ? UI : LI, up, p, r,
                           up ? p + 1 : r, up ? r : p - 1, (w >> 1) & 1);
    }
    if (d + 1 < P) __syncthreads();
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
