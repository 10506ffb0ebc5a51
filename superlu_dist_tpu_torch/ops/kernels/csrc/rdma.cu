// rdma.cu: the 2D block-cyclic factor and triangular sweeps of a Pr x Pc
// grid of ranks, with every broadcast made as a store ("put") into the
// peer rank's buffer by the kernel that produced the block.
//
// Replaces: superlu_dist_tpu/parallel/dist2d_rdma.py
//   - _rdma_kernel (called by _rdma_call), the whole 2D factor of one rank
//     as one kernel, by three entries run per elimination level:
//       rdma_diag  (A): tile LU and inverses of the level's owned diagonal
//                       steps; linv put to the row peers' lC[pos], uinv to
//                       the column peers' uC[pos];
//       rdma_panel (B): L panels L . uC[pil] put to the row peers' lB[pos],
//                       U panels lC[pil] . U to the column peers' uB[pos];
//       rdma_schur (C): T -= lB[lpos] . uB[upos] into the local targets;
//   - _rdma_solve_kernel (called by _rdma_solve_call), one L or U sweep of
//     one rank, by three entries run per solve level:
//       rdma_solve_chunks: each chunk of a rank's chain into a row position
//                          summed into the rank's chunk scratch C;
//       rdma_solve_sum:    a rank's partial P[pos] = -(its chunks' sums, in
//                          chunk order), put to the diagonal owner's
//                          slots[pos * npeer + my index] by a non-owner;
//       rdma_solve_diag:   the owner's x_I = op(dinv) . (X[I] + P[pos] +
//                          the peers' slots, in grid order), put to every
//                          rank's X[I].
//     The solve entries take a transpose flag (the TPU kernel has none; the
//     JAX package solves A^T x = b on its XLA grid executor): op(M) = M^T
//     for every product and diagonal inverse, and the partials of row J,
//     which come from blocks (I, J) of grid column J mod pc, gather down
//     that column (npeer = pr, my index = my grid row) instead of along
//     the grid row (npeer = pc, my index = my grid column). A transposed
//     solve runs a U^T sweep with uinv, then an L^T sweep with linv; the
//     flag never conjugates (the driver solves A^H x = b through
//     conjugation).
//
// Layers. The same entries run the 3D grid's factor and sweeps
// (parallel/dist3d.py): rank d = (z * pr + r) * pc + c of a pz x pr x pc
// grid, ndev = pz * pr * pc ranks in one pointer table. Every entry takes
// pr beside pc; a factor's puts stay inside the layer of the producing
// rank (its peers are offset by (d / (pr * pc)) * pr * pc), since each
// layer factors its own subtrees and the ancestors are reduced over the
// layers by the host between phases. In a sweep the partials of a row
// come from every layer: npeer = pz * pc (pz * pr transposed), a rank's
// index among them z * pc + c (z * pr + r), own[j] is the owner's index
// of that kind, and the owner sums its peers' slots in that (z, c) or
// (z, r) order. With pz = 1 each formula is the 2D one.
//
// On the TPU one pallas_call per rank walks grid=(nlvl,) in order, and
// counted DMA waits and a dissemination barrier fence each level. Here each
// phase of each level is one launch on one stream that covers the jobs of
// all ranks (blockIdx.x picks a job, the job names its rank); the kernel
// boundary is the counted wait and the barrier. Every rank's buffers are
// reached through a device table of pointers, tab[kind * ndev + rank], so
// a put is an ordinary store into another rank's buffer, the same store
// that reaches a peer card over NVLink once peer access is on. Each put
// also adds one to the receiver's counter for (level, kind) with atomicAdd;
// the host holds these counts against the TPU's receive tapes
// (build_rdma_recv_tapes, and rcv_part / rcv_x of the solve tapes).
//
// What bounds them on an H100. The factor: operations, 2*bs^3 per Schur
// product and per panel, (4/3)*bs^3 per tile (four times as many real
// operations in complex), at the card's 67 TFLOP/s (FP32 on the CUDA
// cores; FP64 on the tensor cores, float64's bytes then weigh as much);
// each put moves one bs x bs block more (4 + 4 + 2 + 2 = 12 puts
// per step and panel on a 2 x 2 grid), which is bytes far below the
// operations' time. The sweeps: bytes, each stored block read once per
// sweep for 2*bs^2*nrhs operations, and the put bytes (a partial per
// non-owner and an x row per peer per solved row) beside them.
//
// Design. Phase A runs slu_tile::tile_lu (tile_lu.cuh, shared with
// diag_lu.cu) on the owner's pool block, with its inverses stored into
// the owner's linvL/uinvL rows; after a barrier the CTA copies them into
// the lC/uC rows of the peers (and its own). Phase B is the band product
// of schur.cu's trsm (panel.cuh: one CTA per (panel, band of whole rows or
// columns), the band and the received inverse streamed through a cp.async
// ring), whose band, left in registers, is stored once into the owner's
// pool and once into each peer's broadcast buffer. Phase C groups a
// level's products by target (host sort, tape order kept within a
// target): one CTA per (target, band of whole columns) runs chain.cuh's
// schur_band (the body of schur.cu's `schur`) from the rank's lB / uB and
// stores once; a target belongs to one rank, so ranks never race and no
// atomics touch the blocks. Both take chain.cuh's geometry: bands of 64
// when the launch fills the card, else of 16. The solve runs
// solve_gemm.cu's two passes (rows.cuh): the host cuts each (rank,
// position) chain into chunks in tape order (sweep.py::chunk_chains,
// sized per level to fill the card), pass 1 runs one CTA per (chunk,
// tile of kRT right-hand sides) through rows.cuh's chunk_sum, and pass 2
// one CTA per (rank, position, tile) that sums the position's chunks in
// chunk order and puts the partial once, so the receive counts stay
// those of the TPU. The owner's CTA of pass 3 adds its partial and then
// the peers' slots in grid order into a tile staged in shared memory, and
// multiplies it by op(dinv) through rows.cuh's Map (solve_gemm.cu's pass
// 2), so a result repeats bit for bit.
//
// Element types. Every entry is instantiated for float, double and
// cplx.cuh's complex64 and complex128 (the _f32, _f64, _c64 and _c128
// entries; the TPU kernels are float32 only): the headers are templates
// on T, the threshold is real_t<T>, puts copy bs * bs * sizeof(T) bytes,
// the panels and Schur products take chain.cuh's geometry for T (double
// and complex64 their rolled k loop, complex128 bands of 16 with 4 x 4
// tiles), the tiles of right-hand sides rows.cuh's kRTof<T>, and the
// diagonal tile stays in the pool where it does not fit in shared memory
// (complex128 at bs = 128, tile_lu.cuh's in-pool path: its inverses are
// in linv/uinv in device memory either way, and the puts copy them from
// there after a barrier). A complex product is four real FMAs in a fixed
// order, so complex factors and solves repeat bit for bit too.

#include "chain.cuh"
#include "rows.cuh"
#include "tile_lu.cuh"

namespace {

using slu_rows::kRT;
using slu_rows::kThreads;
using slu_rows::Map;
using slu_tile::kTileThreads;
template <typename T>
using real_t = slu_cplx::real_t<T>;

// kinds of the factor's pointer table; the counters of a rank are
// int32[nlvl][4], its tiny-pivot count int32[1]
enum { F_POOL = 0, F_LINV, F_UINV, F_LC, F_UC, F_LB, F_UB, F_CNT, F_TINY };
enum { R_LI = 0, R_UI = 1, R_L = 2, R_U = 3, R_NFACTOR = 4 };
// kinds of a sweep's pointer table; the counters are int32[nlvl][2]
enum { S_POOL = 0, S_DINV, S_X, S_P, S_SLOTS, S_CNT, S_C };
enum { R_PART = 0, R_X = 1, R_NSOLVE = 2 };

template <typename P>
__device__ __forceinline__ P* buf(const uint64_t* tab, int kind, int ndev,
                                  int rank) {
  return reinterpret_cast<P*>(tab[kind * ndev + rank]);
}

// rank d's place in its layer of a pr x pc grid: the layer's first rank,
// its layer z, its grid row and column
struct Place {
  int base, z, r, c;
  __device__ __forceinline__ Place(int d, int pr, int pc) {
    const int lay = pr * pc;
    z = d / lay;
    base = z * lay;
    r = (d - base) / pc;
    c = d % pc;
  }
};

// dst[0:nbytes] = src[0:nbytes] by the whole CTA, 16 bytes a thread;
// nbytes % 16 == 0
__device__ __forceinline__ void copy_bytes(void* dst, const void* src,
                                           int64_t nbytes) {
  for (int64_t e = threadIdx.x; e < nbytes / 16; e += blockDim.x)
    reinterpret_cast<float4*>(dst)[e] =
        reinterpret_cast<const float4*>(src)[e];
}

// ---- A: owned diagonal steps ----------------------------------------------
// CTA j's inverses, stored by tile_lu into its owner's linv/uinv rows
// inv[j], copied into the lC / uC rows pos[j] of the grid row / column
// peers (and its own), each receiver's counter bumped. A function of its
// own that reads everything again from the kernel's arguments: tile_lu is
// not inlined, and whatever the kernel kept live across that call would
// take registers from it (complex64's tile_lu spilled 20 bytes so).
template <typename T>
__device__ __noinline__ void put_inverses(const uint64_t* tab, int ndev,
                                          int pr, int pc,
                                          const int32_t* rank,
                                          const int32_t* pos,
                                          const int32_t* inv, int bs,
                                          int level) {
  const int j = blockIdx.x;
  const int d = rank[j];
  const Place me(d, pr, pc);
  const int64_t bb = (int64_t)bs * bs;
  const T* gl = buf<T>(tab, F_LINV, ndev, d) + inv[j] * bb;
  const T* gu = buf<T>(tab, F_UINV, ndev, d) + inv[j] * bb;
  const int64_t p = pos[j] * bb;
  const int64_t nbytes = bb * (int64_t)sizeof(T);
  const int row = me.base + me.r * pc, col = me.base + me.c;
  for (int c = 0; c < pc; ++c)       // linv -> lC[pos] along the grid row
    copy_bytes(buf<T>(tab, F_LC, ndev, row + c) + p, gl, nbytes);
  for (int r = 0; r < pr; ++r)       // uinv -> uC[pos] down the column
    copy_bytes(buf<T>(tab, F_UC, ndev, col + r * pc) + p, gu, nbytes);
  if (threadIdx.x == 0) {
    for (int c = 0; c < pc; ++c)
      if (c != me.c)
        atomicAdd(buf<int32_t>(tab, F_CNT, ndev, row + c) +
                      level * R_NFACTOR + R_LI, 1);
    for (int r = 0; r < pr; ++r)
      if (r != me.r)
        atomicAdd(buf<int32_t>(tab, F_CNT, ndev, col + r * pc) +
                      level * R_NFACTOR + R_UI, 1);
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
rdma_diag_kernel(const uint64_t* __restrict__ tab, int ndev, int pr, int pc,
                 const int32_t* __restrict__ rank,
                 const int32_t* __restrict__ loc,
                 const int32_t* __restrict__ pos,
                 const int32_t* __restrict__ inv, int bs,
                 real_t<T> thresh, int level) {
  const int d = rank[blockIdx.x];
  // job j is CTA j: tile_lu reads loc[j] and inv[j]
  slu_tile::tile_lu<T>(buf<T>(tab, F_POOL, ndev, d),
                       buf<T>(tab, F_LINV, ndev, d),
                       buf<T>(tab, F_UINV, ndev, d), loc, inv, bs, thresh,
                       buf<int32_t>(tab, F_TINY, ndev, d));
  __syncthreads();   // the inverses are stored; read them back
  put_inverses<T>(tab, ndev, pr, pc, rank, pos, inv, bs, level);
}

// ---- B: owned panels ------------------------------------------------------
// side 0: an L panel, Y = L . uC[pil], put along the grid row into lB[pos];
// side 1: a U panel, Y = lC[pil] . U, put down the grid column into uB[pos].
// One CTA per (job, band of whole rows (side 0) or columns (side 1)):
// panel.cuh's band product, stored into the owner's pool and each peer's
// buffer from registers. Each orientation's body is a function of its own
// (not inlined), as flk.cu's are.
template <class G, bool LEFT, typename T>
__device__ __noinline__ void panel_band(const uint64_t* tab, int ndev,
                                        int pr, int pc, int d, int64_t loc,
                                        int64_t pos, int64_t pil,
                                        int level) {
  using P = typename G::template Band<LEFT>;
  extern __shared__ float4 smem4[];
  const Place me(d, pr, pc);
  const int g = threadIdx.x / P::CT;
  const int c0 = (threadIdx.x % P::CT) * P::W;
  const int64_t bb = (int64_t)G::BS * G::BS;
  const int64_t off = LEFT ? (int64_t)blockIdx.y * G::BM
                           : (int64_t)blockIdx.y * G::BM * G::BS;
  T* X = buf<T>(tab, F_POOL, ndev, d) + loc * bb + off;
  const T* D = buf<T>(tab, LEFT ? F_LC : F_UC, ndev, d) + pil * bb;
  T acc[4][P::TW];
  slu_panel::band_product<P>(reinterpret_cast<T*>(smem4), LEFT ? D : X,
                             LEFT ? X : D, g, c0, acc);
  // every read of the band was a copy that has landed; only now is it
  // written
  slu_panel::store_tile<P, G::BS>(X, g, c0, acc);
  const int npeer = LEFT ? pr : pc;
  for (int q = 0; q < npeer; ++q) {
    const int e = me.base + (LEFT ? q * pc + me.c : me.r * pc + q);
    slu_panel::store_tile<P, G::BS>(
        buf<T>(tab, LEFT ? F_UB : F_LB, ndev, e) + pos * bb + off, g, c0,
        acc);
  }
  if (blockIdx.y == 0 && threadIdx.x == 0)
    for (int q = 0; q < npeer; ++q) {
      if (q == (LEFT ? me.r : me.c)) continue;
      const int e = me.base + (LEFT ? q * pc + me.c : me.r * pc + q);
      atomicAdd(buf<int32_t>(tab, F_CNT, ndev, e) + level * R_NFACTOR +
                    (LEFT ? R_U : R_L), 1);
    }
}

template <class G, typename T>
__global__ void __launch_bounds__(G::NT)
rdma_panel_kernel(const uint64_t* __restrict__ tab, int ndev, int pr,
                  int pc,
                  const int32_t* __restrict__ rank,
                  const int32_t* __restrict__ loc,
                  const int32_t* __restrict__ pos,
                  const int32_t* __restrict__ pil,
                  const int32_t* __restrict__ side, int level) {
  const int j = blockIdx.x;
  if (side[j] == 0)
    panel_band<G, false, T>(tab, ndev, pr, pc, rank[j], loc[j], pos[j],
                            pil[j], level);
  else
    panel_band<G, true, T>(tab, ndev, pr, pc, rank[j], loc[j], pos[j],
                           pil[j], level);
}

// ---- C: owned Schur products, grouped by target ---------------------------
// One CTA per (target, band of whole columns): chain.cuh's Schur band from
// the rank's broadcast buffers lB / uB into its pool.
template <class G, typename T>
__global__ void __launch_bounds__(G::NT)
rdma_schur_kernel(const uint64_t* __restrict__ tab, int ndev,
                  const int32_t* __restrict__ rank,
                  const int32_t* __restrict__ tloc,
                  const int32_t* __restrict__ cptr,
                  const int32_t* __restrict__ cl,
                  const int32_t* __restrict__ cu) {
  const int t = blockIdx.x;
  const int d = rank[t];
  slu_chain::schur_band<G>(
      buf<T>(tab, F_POOL, ndev, d) + tloc[t] * ((int64_t)G::BS * G::BS),
      buf<T>(tab, F_LB, ndev, d), buf<T>(tab, F_UB, ndev, d), cl, cu,
      cptr[t], cptr[t + 1]);
}

// ---- solve pass 1: one chunk of a rank's chain into its scratch row ------
template <typename T, int BS, bool kTrans, int RT>
__global__ void __launch_bounds__(kThreads, 2)
rdma_solve_chunks_kernel(const uint64_t* __restrict__ tab, int ndev,
                         const int32_t* __restrict__ qrank,
                         const int32_t* __restrict__ qrow,
                         const int32_t* __restrict__ qcptr,
                         const int32_t* __restrict__ cloc,
                         const int32_t* __restrict__ csrc, int nrhs) {
  const int q = blockIdx.x;
  const int d = qrank[q];
  const int c0 = blockIdx.y * RT;
  T* C = buf<T>(tab, S_C, ndev, d) + (int64_t)qrow[q] * BS * nrhs + c0;
  slu_rows::chunk_sum<T, BS, kTrans, RT>(
      buf<T>(tab, S_POOL, ndev, d), buf<T>(tab, S_X, ndev, d), qcptr[q],
      qcptr[q + 1], cloc, csrc, c0, nrhs,
      [&](int i, int c, T v) { C[i * nrhs + c] = v; });
}

// ---- solve pass 2: a rank's partial of one row position, and its put -----
// own[j] is the owner's index among the row's npeer partials: z * pc + its
// grid column (z * pr + its grid row when transposed), z its layer.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rdma_solve_sum_kernel(const uint64_t* __restrict__ tab, int ndev, int pr,
                      int pc,
                      const int32_t* __restrict__ rank,
                      const int32_t* __restrict__ pos,
                      const int32_t* __restrict__ send,
                      const int32_t* __restrict__ own,
                      const int32_t* __restrict__ chunkptr,
                      const int32_t* __restrict__ qrow, int bs, int nrhs,
                      int level, int transpose) {
  const int j = blockIdx.x;
  const int d = rank[j];
  const Place pl(d, pr, pc);
  const int pz = ndev / (pr * pc);
  const int npeer = pz * (transpose ? pr : pc);
  const int me = transpose ? pl.z * pr + pl.r : pl.z * pc + pl.c;
  const int64_t rb = (int64_t)bs * nrhs;
  const int c0 = blockIdx.y * kRT;
  const int rt = min(kRT, nrhs - c0);
  const int nq = chunkptr[j + 1] - chunkptr[j];
  const T* C =
      nq ? buf<T>(tab, S_C, ndev, d) + qrow[chunkptr[j]] * rb + c0 : nullptr;
  T* P = buf<T>(tab, S_P, ndev, d) + pos[j] * rb + c0;
  const int owner =
      transpose ? (own[j] / pr) * pr * pc + (own[j] % pr) * pc + pl.c
                : (own[j] / pc) * pr * pc + pl.r * pc + own[j] % pc;
  T* S = send[j] ? buf<T>(tab, S_SLOTS, ndev, owner) +
                       ((int64_t)pos[j] * npeer + me) * rb + c0
                 : nullptr;
  for (int e = threadIdx.x; e < bs * rt; e += blockDim.x) {
    const int64_t o = (int64_t)(e / rt) * nrhs + e % rt;
    T v = T(0);
#pragma unroll 8
    for (int q = 0; q < nq; ++q) v -= C[q * rb + o];   // loads run ahead
    P[o] = v;
    if (S) S[o] = v;
  }
  if (send[j] && blockIdx.y == 0 && threadIdx.x == 0)
    atomicAdd(buf<int32_t>(tab, S_CNT, ndev, owner) + level * R_NSOLVE +
                  R_PART, 1);
}

// ---- solve pass 3: the owner's diagonal apply and x broadcast -------------
// The owner's tile t = X[I] + P + the peers' slots (in grid order) is
// staged in shared memory, then x = op(dinv) . t by rows.cuh's Map, as
// solve_gemm.cu's rows_kernel applies its diagonal, and x is stored into
// every rank's X[I].
template <typename T, int BS, bool kTrans, int RT>
__global__ void __launch_bounds__(kThreads, 2)
rdma_solve_diag_kernel(const uint64_t* __restrict__ tab, int ndev, int pr,
                       int pc,
                       const int32_t* __restrict__ rank,
                       const int32_t* __restrict__ row,
                       const int32_t* __restrict__ pos,
                       const int32_t* __restrict__ inv, int nrhs,
                       int level) {
  using M = Map<T, BS, kTrans>;
  const int j = blockIdx.x;
  const int d = rank[j];
  const Place pl(d, pr, pc);
  const int npeer = ndev / (pr * pc) * (kTrans ? pr : pc);
  const int me = kTrans ? pl.z * pr + pl.r : pl.z * pc + pl.c;
  const int c0 = blockIdx.y * RT;
  const int rt = min(RT, nrhs - c0);
  const int64_t rb = (int64_t)BS * nrhs;
  const int64_t I = row[j];
  T* ys = slu_rows::dyn_smem<T>();     // BS x RT, ys[k * RT + c]
  T* red = ys + BS * RT;               // the product's partial sums
  const T* X = buf<T>(tab, S_X, ndev, d) + I * rb + c0;
  const T* P = buf<T>(tab, S_P, ndev, d) + pos[j] * rb + c0;
  const T* S = buf<T>(tab, S_SLOTS, ndev, d) + pos[j] * npeer * rb + c0;
  for (int e = threadIdx.x; e < BS * rt; e += kThreads) {
    const int i = e / rt, c = e - i * rt;
    const int64_t o = (int64_t)i * nrhs + c;
    T v = X[o] + P[o];
    for (int q = 0; q < npeer; ++q)  // the peers' partials, (z, c) order
      if (q != me) v += S[q * rb + o];
    ys[i * RT + c] = v;
  }
  __syncthreads();
  T acc[M::kOut][RT] = {};
  M::template accumulate<RT>(
      buf<T>(tab, S_DINV, ndev, d) + inv[j] * (int64_t)BS * BS, rt,
      [&](int k, int c) { return ys[k * RT + c]; }, acc);
  M::template reduce<RT>(acc, rt, red, [&](int i, int c, T v) {
    const int64_t o = I * rb + c0 + (int64_t)i * nrhs + c;
    for (int e2 = 0; e2 < ndev; ++e2)   // x_I into every rank's X[I]
      buf<T>(tab, S_X, ndev, e2)[o] = v;
  });
  if (blockIdx.y == 0 && threadIdx.x == 0)
    for (int e2 = 0; e2 < ndev; ++e2)
      if (e2 != d)
        atomicAdd(buf<int32_t>(tab, S_CNT, ndev, e2) + level * R_NSOLVE +
                      R_X, 1);
}

// ---- launches ------------------------------------------------------------
template <typename T>
int rdma_diag(const void* tab, int ndev, int pr, int pc, const void* rank,
              const void* loc, const void* pos, const void* inv, int count,
              int bs, real_t<T> thresh, int level, void* stream) {
  const size_t smem = slu_tile::tile_lu_smem_bytes<T>(bs);
  cudaError_t err = cudaFuncSetAttribute(
      rdma_diag_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (count == 0) return 0;
  rdma_diag_kernel<T><<<count, kTileThreads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)tab, ndev, pr, pc, (const int32_t*)rank,
      (const int32_t*)loc, (const int32_t*)pos, (const int32_t*)inv, bs,
      thresh, level);
  return (int)cudaGetLastError();
}

template <typename T>
int rdma_panel(const void* tab, int ndev, int pr, int pc, const void* rank,
               const void* loc, const void* pos, const void* pil,
               const void* side, int count, int bs, int level, int wide,
               void* stream) {
  if (count == 0) return 0;
  // the band product's ring of panel.cuh's four stages
  return slu_chain::by_geometry<T, false>(bs, count, wide, [&](auto geo) {
    using G = decltype(geo);
    static_assert(G::STAGES == G::template Band<true>::STAGES, "ring");
    return slu_chain::launch<G>(
        rdma_panel_kernel<G, T>, count, (cudaStream_t)stream,
        (const uint64_t*)tab, ndev, pr, pc, (const int32_t*)rank,
        (const int32_t*)loc, (const int32_t*)pos, (const int32_t*)pil,
        (const int32_t*)side, level);
  });
}

template <typename T>
int rdma_schur(const void* tab, int ndev, const void* rank, const void* tloc,
               const void* cptr, const void* cl, const void* cu, int count,
               int bs, int wide, void* stream) {
  if (count == 0) return 0;
  return slu_chain::by_geometry<T, false>(bs, count, wide, [&](auto geo) {
    using G = decltype(geo);
    return slu_chain::launch<G>(
        rdma_schur_kernel<G, T>, count, (cudaStream_t)stream,
        (const uint64_t*)tab, ndev, (const int32_t*)rank,
        (const int32_t*)tloc, (const int32_t*)cptr, (const int32_t*)cl,
        (const int32_t*)cu);
  });
}

struct SolveArgs {
  const uint64_t* tab;
  int ndev, pr, pc;
  const int32_t *a, *b, *c, *e, *f;   // the entry's job lists, in order
  int count, nrhs, level;
  cudaStream_t stream;
};

template <typename T, int BS, bool kTrans, int RT>
struct ChunksLaunch {
  static void go(const SolveArgs& a) {
    using M = Map<T, BS, kTrans>;
    constexpr size_t smem = M::template red_elems<RT>() * sizeof(T);
    static_assert(smem <= 48 * 1024, "shared memory");
    const dim3 grid(a.count, (a.nrhs + RT - 1) / RT);
    rdma_solve_chunks_kernel<T, BS, kTrans, RT>
        <<<grid, kThreads, smem, a.stream>>>(a.tab, a.ndev, a.a, a.b, a.c,
                                             a.e, a.f, a.nrhs);
  }
};

template <typename T, int BS, bool kTrans, int RT>
struct DiagLaunch {
  static void go(const SolveArgs& a) {
    using M = Map<T, BS, kTrans>;
    constexpr size_t smem =
        (BS * RT + M::template red_elems<RT>()) * sizeof(T);
    static_assert(smem <= 48 * 1024, "shared memory");
    const dim3 grid(a.count, (a.nrhs + RT - 1) / RT);
    rdma_solve_diag_kernel<T, BS, kTrans, RT>
        <<<grid, kThreads, smem, a.stream>>>(a.tab, a.ndev, a.pr, a.pc, a.a,
                                             a.b, a.c, a.e, a.nrhs,
                                             a.level);
  }
};

// launch L<T, bs, transpose, RT> (RT = 1 for one right-hand side, else
// rows.cuh's kRTof<T>); returns the launch's cudaError_t
template <template <typename, int, bool, int> class L, typename T, int BS>
void by_flags(const SolveArgs& a, int transpose) {
  constexpr int RT = slu_rows::kRTof<T>;
  if (transpose)
    a.nrhs == 1 ? L<T, BS, true, 1>::go(a) : L<T, BS, true, RT>::go(a);
  else
    a.nrhs == 1 ? L<T, BS, false, 1>::go(a) : L<T, BS, false, RT>::go(a);
}

template <template <typename, int, bool, int> class L, typename T>
int dispatch(const SolveArgs& a, int bs, int transpose) {
  if (a.count == 0) return 0;
  switch (bs) {
    case 32: by_flags<L, T, 32>(a, transpose); break;
    case 64: by_flags<L, T, 64>(a, transpose); break;
    case 128: by_flags<L, T, 128>(a, transpose); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int rdma_solve_sum(const void* tab, int ndev, int pr, int pc,
                   const void* rank, const void* pos, const void* send,
                   const void* own, const void* chunkptr, const void* qrow,
                   int count, int bs, int nrhs, int level, int transpose,
                   void* stream) {
  if (count == 0) return 0;
  const dim3 grid(count, (nrhs + kRT - 1) / kRT);
  rdma_solve_sum_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)tab, ndev, pr, pc, (const int32_t*)rank,
      (const int32_t*)pos, (const int32_t*)send, (const int32_t*)own,
      (const int32_t*)chunkptr, (const int32_t*)qrow, bs, nrhs, level,
      transpose);
  return (int)cudaGetLastError();
}

}  // namespace

// The entries of one element type T with suffix SFX, over the ndev ranks
// of a pz x pr x pc grid (pz = ndev / (pr * pc); a 2D grid is pz = 1):
//   slu_rdma_diag_SFX:  phase A of a level over `count` diagonal jobs;
//   slu_rdma_panel_SFX: phase B over `count` panel jobs (`wide` < 0
//     chooses the band geometry, 0 / 1 force bands of 16 / 64);
//   slu_rdma_schur_SFX: phase C over `count` targets (cl, cu whole);
//   slu_rdma_solve_chunks_SFX: pass 1 of a solve level over `count`
//     chunks (the level's slice of qrank, qrow, qcptr): chunk q's products
//     qcptr[q] .. qcptr[q+1] of cloc/csrc, each op(pool block) . X[src],
//     summed into row qrow[q] of rank qrank[q]'s chunk scratch;
//   slu_rdma_solve_sum_SFX: pass 2 over `count` partial jobs (the level's
//     slice of rank, pos, send, own, chunkptr): job j's partial is minus
//     the sum of its chunks chunkptr[j] .. chunkptr[j+1] (scratch rows
//     from qrow) in chunk order;
//   slu_rdma_solve_diag_SFX: pass 3 over `count` solved rows.
// Each returns the cudaError_t of its launch.
#define SLU_RDMA_ENTRIES(SFX, T)                                              \
  extern "C" int slu_rdma_diag_##SFX(                                         \
      const void* tab, int ndev, int pr, int pc, const void* rank,            \
      const void* loc, const void* pos, const void* inv, int count, int bs,   \
      real_t<T> thresh, int level, void* stream) {                            \
    return rdma_diag<T>(tab, ndev, pr, pc, rank, loc, pos, inv, count, bs,    \
                        thresh, level, stream);                               \
  }                                                                           \
  extern "C" int slu_rdma_panel_##SFX(                                        \
      const void* tab, int ndev, int pr, int pc, const void* rank,            \
      const void* loc, const void* pos, const void* pil, const void* side,    \
      int count, int bs, int level, int wide, void* stream) {                 \
    return rdma_panel<T>(tab, ndev, pr, pc, rank, loc, pos, pil, side,        \
                         count, bs, level, wide, stream);                     \
  }                                                                           \
  extern "C" int slu_rdma_schur_##SFX(                                        \
      const void* tab, int ndev, const void* rank, const void* tloc,          \
      const void* cptr, const void* cl, const void* cu, int count, int bs,    \
      int wide, void* stream) {                                               \
    return rdma_schur<T>(tab, ndev, rank, tloc, cptr, cl, cu, count, bs,      \
                         wide, stream);                                       \
  }                                                                           \
  extern "C" int slu_rdma_solve_chunks_##SFX(                                 \
      const void* tab, int ndev, const void* qrank, const void* qrow,         \
      const void* qcptr, const void* cloc, const void* csrc, int count,       \
      int bs, int nrhs, int transpose, void* stream) {                        \
    const SolveArgs a{(const uint64_t*)tab, ndev, 0, 0,                       \
                      (const int32_t*)qrank, (const int32_t*)qrow,            \
                      (const int32_t*)qcptr, (const int32_t*)cloc,            \
                      (const int32_t*)csrc, count, nrhs, 0,                   \
                      (cudaStream_t)stream};                                  \
    return dispatch<ChunksLaunch, T>(a, bs, transpose);                       \
  }                                                                           \
  extern "C" int slu_rdma_solve_sum_##SFX(                                    \
      const void* tab, int ndev, int pr, int pc, const void* rank,            \
      const void* pos, const void* send, const void* own,                     \
      const void* chunkptr, const void* qrow, int count, int bs, int nrhs,    \
      int level, int transpose, void* stream) {                               \
    return rdma_solve_sum<T>(tab, ndev, pr, pc, rank, pos, send, own,         \
                             chunkptr, qrow, count, bs, nrhs, level,          \
                             transpose, stream);                              \
  }                                                                           \
  extern "C" int slu_rdma_solve_diag_##SFX(                                   \
      const void* tab, int ndev, int pr, int pc, const void* rank,            \
      const void* row, const void* pos, const void* inv, int count, int bs,   \
      int nrhs, int level, int transpose, void* stream) {                     \
    const SolveArgs a{(const uint64_t*)tab, ndev, pr, pc,                     \
                      (const int32_t*)rank, (const int32_t*)row,              \
                      (const int32_t*)pos, (const int32_t*)inv, nullptr,      \
                      count, nrhs, level, (cudaStream_t)stream};              \
    return dispatch<DiagLaunch, T>(a, bs, transpose);                         \
  }

SLU_RDMA_ENTRIES(f32, float)
SLU_RDMA_ENTRIES(f64, double)
SLU_RDMA_ENTRIES(c64, slu_cplx::cplx<float>)
SLU_RDMA_ENTRIES(c128, slu_cplx::cplx<double>)
