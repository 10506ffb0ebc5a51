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
//                          slots[pos * pc + my column] by a non-owner;
//       rdma_solve_diag:   the owner's x_I = dinv . (X[I] + P[pos] + the
//                          peers' slots, in column order), put to every
//                          rank's X[I].
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
// product and per panel, (4/3)*bs^3 per tile, at the FP32 67 TFLOP/s of the
// CUDA cores; each put moves one bs x bs block more (4 + 4 + 2 + 2 = 12 puts
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
// the peers' slots in column order, so a result repeats bit for bit.
// float32 only, as the TPU kernels are.

#include "chain.cuh"
#include "rows.cuh"
#include "tile_lu.cuh"

namespace {

using slu_rows::kRT;
using slu_rows::kThreads;
using slu_rows::rows_times;
using slu_tile::kTileThreads;

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

// dst[0:n] = src[0:n] by the whole CTA, 16 bytes a thread; n % 4 == 0
__device__ __forceinline__ void copy_block(float* dst, const float* src,
                                           int64_t n) {
  for (int64_t e = threadIdx.x; e < n / 4; e += blockDim.x)
    reinterpret_cast<float4*>(dst)[e] =
        reinterpret_cast<const float4*>(src)[e];
}

// ---- A: owned diagonal steps ----------------------------------------------
__global__ void __launch_bounds__(kTileThreads)
rdma_diag_kernel(const uint64_t* __restrict__ tab, int ndev, int pc,
                 const int32_t* __restrict__ rank,
                 const int32_t* __restrict__ loc,
                 const int32_t* __restrict__ pos,
                 const int32_t* __restrict__ inv, int bs,
                 float thresh, int level) {
  const int j = blockIdx.x;
  const int d = rank[j];
  const int pr = ndev / pc, myr = d / pc, myc = d % pc;
  const int64_t bb = (int64_t)bs * bs;
  float* linv = buf<float>(tab, F_LINV, ndev, d);
  float* uinv = buf<float>(tab, F_UINV, ndev, d);
  // job j is CTA j: tile_lu reads loc[j] and inv[j]
  slu_tile::tile_lu<float>(buf<float>(tab, F_POOL, ndev, d), linv, uinv,
                           loc, inv, bs, thresh,
                           buf<int32_t>(tab, F_TINY, ndev, d));
  __syncthreads();   // the inverses are stored; read them back
  const float* gl = linv + inv[j] * bb;
  const float* gu = uinv + inv[j] * bb;
  const int64_t p = pos[j] * bb;
  for (int c = 0; c < pc; ++c)       // linv -> lC[pos] along the grid row
    copy_block(buf<float>(tab, F_LC, ndev, myr * pc + c) + p, gl, bb);
  for (int r = 0; r < pr; ++r)       // uinv -> uC[pos] down the column
    copy_block(buf<float>(tab, F_UC, ndev, r * pc + myc) + p, gu, bb);
  if (threadIdx.x == 0) {
    for (int c = 0; c < pc; ++c)
      if (c != myc)
        atomicAdd(buf<int32_t>(tab, F_CNT, ndev, myr * pc + c) +
                      level * R_NFACTOR + R_LI, 1);
    for (int r = 0; r < pr; ++r)
      if (r != myr)
        atomicAdd(buf<int32_t>(tab, F_CNT, ndev, r * pc + myc) +
                      level * R_NFACTOR + R_UI, 1);
  }
}

// ---- B: owned panels ------------------------------------------------------
// side 0: an L panel, Y = L . uC[pil], put along the grid row into lB[pos];
// side 1: a U panel, Y = lC[pil] . U, put down the grid column into uB[pos].
// One CTA per (job, band of whole rows (side 0) or columns (side 1)):
// panel.cuh's band product, stored into the owner's pool and each peer's
// buffer from registers. Each orientation's body is a function of its own
// (not inlined), as flk.cu's are.
template <class G, bool LEFT>
__device__ __noinline__ void panel_band(const uint64_t* tab, int ndev,
                                           int pc, int d, int64_t loc,
                                           int64_t pos, int64_t pil,
                                           int level) {
  using P = typename G::template Band<LEFT>;
  extern __shared__ float4 smem4[];
  const int pr = ndev / pc, myr = d / pc, myc = d % pc;
  const int g = threadIdx.x / P::CT;
  const int c0 = (threadIdx.x % P::CT) * P::W;
  const int64_t bb = (int64_t)G::BS * G::BS;
  const int64_t off = LEFT ? (int64_t)blockIdx.y * G::BM
                           : (int64_t)blockIdx.y * G::BM * G::BS;
  float* X = buf<float>(tab, F_POOL, ndev, d) + loc * bb + off;
  const float* D =
      buf<float>(tab, LEFT ? F_LC : F_UC, ndev, d) + pil * bb;
  float acc[4][P::TW];
  slu_panel::band_product<P>(reinterpret_cast<float*>(smem4),
                             LEFT ? D : X, LEFT ? X : D, g, c0, acc);
  // every read of the band was a copy that has landed; only now is it
  // written
  slu_panel::store_tile<P, G::BS>(X, g, c0, acc);
  const int npeer = LEFT ? pr : pc;
  for (int q = 0; q < npeer; ++q) {
    const int e = LEFT ? q * pc + myc : myr * pc + q;
    slu_panel::store_tile<P, G::BS>(
        buf<float>(tab, LEFT ? F_UB : F_LB, ndev, e) + pos * bb + off, g,
        c0, acc);
  }
  if (blockIdx.y == 0 && threadIdx.x == 0)
    for (int q = 0; q < npeer; ++q) {
      if (q == (LEFT ? myr : myc)) continue;
      const int e = LEFT ? q * pc + myc : myr * pc + q;
      atomicAdd(buf<int32_t>(tab, F_CNT, ndev, e) + level * R_NFACTOR +
                    (LEFT ? R_U : R_L), 1);
    }
}

template <class G>
__global__ void __launch_bounds__(G::NT)
rdma_panel_kernel(const uint64_t* __restrict__ tab, int ndev, int pc,
                  const int32_t* __restrict__ rank,
                  const int32_t* __restrict__ loc,
                  const int32_t* __restrict__ pos,
                  const int32_t* __restrict__ pil,
                  const int32_t* __restrict__ side, int level) {
  const int j = blockIdx.x;
  if (side[j] == 0)
    panel_band<G, false>(tab, ndev, pc, rank[j], loc[j], pos[j], pil[j],
                         level);
  else
    panel_band<G, true>(tab, ndev, pc, rank[j], loc[j], pos[j], pil[j],
                        level);
}

// ---- C: owned Schur products, grouped by target ---------------------------
// One CTA per (target, band of whole columns): chain.cuh's Schur band from
// the rank's broadcast buffers lB / uB into its pool.
template <class G>
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
      buf<float>(tab, F_POOL, ndev, d) + tloc[t] * ((int64_t)G::BS * G::BS),
      buf<float>(tab, F_LB, ndev, d), buf<float>(tab, F_UB, ndev, d), cl,
      cu, cptr[t], cptr[t + 1]);
}

// ---- solve pass 1: one chunk of a rank's chain into its scratch row ------
template <int BS, int RT>
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
  float* C = buf<float>(tab, S_C, ndev, d) + (int64_t)qrow[q] * BS * nrhs +
             c0;
  slu_rows::chunk_sum<float, BS, false, RT>(
      buf<float>(tab, S_POOL, ndev, d), buf<float>(tab, S_X, ndev, d),
      qcptr[q], qcptr[q + 1], cloc, csrc, c0, nrhs,
      [&](int i, int c, float v) { C[i * nrhs + c] = v; });
}

// ---- solve pass 2: a rank's partial of one row position, and its put -----
__global__ void __launch_bounds__(kThreads)
rdma_solve_sum_kernel(const uint64_t* __restrict__ tab, int ndev, int pc,
                      const int32_t* __restrict__ rank,
                      const int32_t* __restrict__ pos,
                      const int32_t* __restrict__ send,
                      const int32_t* __restrict__ dstc,
                      const int32_t* __restrict__ chunkptr,
                      const int32_t* __restrict__ qrow, int bs, int nrhs,
                      int level) {
  const int j = blockIdx.x;
  const int d = rank[j];
  const int myr = d / pc, myc = d % pc;
  const int64_t rb = (int64_t)bs * nrhs;
  const int c0 = blockIdx.y * kRT;
  const int rt = min(kRT, nrhs - c0);
  const int nq = chunkptr[j + 1] - chunkptr[j];
  const float* C = nq ? buf<float>(tab, S_C, ndev, d) +
                            qrow[chunkptr[j]] * rb + c0
                      : nullptr;
  float* P = buf<float>(tab, S_P, ndev, d) + pos[j] * rb + c0;
  const int owner = myr * pc + dstc[j];
  float* S = send[j] ? buf<float>(tab, S_SLOTS, ndev, owner) +
                           ((int64_t)pos[j] * pc + myc) * rb + c0
                     : nullptr;
  for (int e = threadIdx.x; e < bs * rt; e += blockDim.x) {
    const int64_t o = (int64_t)(e / rt) * nrhs + e % rt;
    float v = 0.0f;
#pragma unroll 8
    for (int q = 0; q < nq; ++q) v -= C[q * rb + o];   // loads run ahead
    P[o] = v;
    if (S) S[o] = v;
  }
  if (send[j] && blockIdx.y == 0 && threadIdx.x == 0)
    atomicAdd(buf<int32_t>(tab, S_CNT, ndev, owner) + level * R_NSOLVE +
                  R_PART, 1);
}

template <int BS, int RT>
int launch_chunks(const uint64_t* tab, int ndev, const int32_t* qrank,
                  const int32_t* qrow, const int32_t* qcptr,
                  const int32_t* cloc, const int32_t* csrc, int count,
                  int nrhs, cudaStream_t stream) {
  using M = slu_rows::Map<float, BS, false>;
  constexpr size_t smem = M::template red_elems<RT>() * sizeof(float);
  static_assert(smem <= 48 * 1024, "shared memory");
  const dim3 grid(count, (nrhs + RT - 1) / RT);
  rdma_solve_chunks_kernel<BS, RT><<<grid, kThreads, smem, stream>>>(
      tab, ndev, qrank, qrow, qcptr, cloc, csrc, nrhs);
  return (int)cudaGetLastError();
}

template <int BS>
int chunks_by_rt(const uint64_t* tab, int ndev, const int32_t* qrank,
                 const int32_t* qrow, const int32_t* qcptr,
                 const int32_t* cloc, const int32_t* csrc, int count,
                 int nrhs, cudaStream_t stream) {
  return nrhs == 1
             ? launch_chunks<BS, 1>(tab, ndev, qrank, qrow, qcptr, cloc, csrc,
                                    count, nrhs, stream)
             : launch_chunks<BS, kRT>(tab, ndev, qrank, qrow, qcptr, cloc,
                                      csrc, count, nrhs, stream);
}

// ---- solve: the owner's diagonal apply and x broadcast --------------------
__global__ void __launch_bounds__(kThreads)
rdma_solve_diag_kernel(const uint64_t* __restrict__ tab, int ndev, int pc,
                       const int32_t* __restrict__ rank,
                       const int32_t* __restrict__ row,
                       const int32_t* __restrict__ pos,
                       const int32_t* __restrict__ inv, int bs, int nrhs,
                       int level) {
  const int j = blockIdx.x;
  const int d = rank[j];
  const int myc = d % pc;
  float* tile = slu_rows::dyn_smem<float>();  // kRT x bs, column major
  float* out = tile + kRT * bs;               // kRT x bs, column major
  const int64_t rb = (int64_t)bs * nrhs;
  const int c0 = blockIdx.y * kRT;
  const int rt = min(kRT, nrhs - c0);
  const int64_t I = row[j];
  const float* X = buf<float>(tab, S_X, ndev, d) + I * rb + c0;
  const float* P = buf<float>(tab, S_P, ndev, d) + pos[j] * rb + c0;
  const float* S = buf<float>(tab, S_SLOTS, ndev, d);

  for (int e = threadIdx.x; e < bs * rt; e += blockDim.x) {
    const int r = e / rt, c = e - r * rt;
    const int64_t o = (int64_t)r * nrhs + c;
    float v = X[o] + P[o];
    for (int q = 0; q < pc; ++q)     // the peers' partials, column order
      if (q != myc) v += S[((int64_t)pos[j] * pc + q) * rb + c0 + o];
    tile[c * bs + r] = v;
  }
  __syncthreads();
  rows_times(buf<float>(tab, S_DINV, ndev, d) + inv[j] * (int64_t)bs * bs,
             tile, bs, rt, [&](int r, const float* s) {
               for (int c = 0; c < rt; ++c) out[c * bs + r] = s[c];
             });
  __syncthreads();
  for (int e2 = 0; e2 < ndev; ++e2) {   // x_I into every rank's X[I]
    float* Xe = buf<float>(tab, S_X, ndev, e2) + I * rb + c0;
    for (int e = threadIdx.x; e < bs * rt; e += blockDim.x) {
      const int r = e / rt, c = e - r * rt;
      Xe[(int64_t)r * nrhs + c] = out[c * bs + r];
    }
  }
  if (blockIdx.y == 0 && threadIdx.x == 0)
    for (int e2 = 0; e2 < ndev; ++e2)
      if (e2 != d)
        atomicAdd(buf<int32_t>(tab, S_CNT, ndev, e2) + level * R_NSOLVE +
                      R_X, 1);
}

}  // namespace

extern "C" int slu_rdma_diag(const void* tab, int ndev, int pc,
                             const void* rank, const void* loc,
                             const void* pos, const void* inv, int count,
                             int bs, float thresh, int level, void* stream) {
  const size_t smem = slu_tile::tile_lu_smem_bytes<float>(bs);
  cudaError_t err = cudaFuncSetAttribute(
      rdma_diag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (count == 0) return 0;
  rdma_diag_kernel<<<count, kTileThreads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)tab, ndev, pc, (const int32_t*)rank,
      (const int32_t*)loc, (const int32_t*)pos, (const int32_t*)inv, bs,
      thresh, level);
  return (int)cudaGetLastError();
}

extern "C" int slu_rdma_panel(const void* tab, int ndev, int pc,
                              const void* rank, const void* loc,
                              const void* pos, const void* pil,
                              const void* side, int count, int bs, int level,
                              int wide, void* stream) {
  if (count == 0) return 0;
  // the band product's ring of panel.cuh's four stages
  return slu_chain::by_geometry<float, false>(bs, count, wide, [&](auto geo) {
    using G = decltype(geo);
    static_assert(G::STAGES == G::template Band<true>::STAGES, "ring");
    return slu_chain::launch<G>(
        rdma_panel_kernel<G>, count, (cudaStream_t)stream,
        (const uint64_t*)tab, ndev, pc, (const int32_t*)rank,
        (const int32_t*)loc, (const int32_t*)pos, (const int32_t*)pil,
        (const int32_t*)side, level);
  });
}

extern "C" int slu_rdma_schur(const void* tab, int ndev, const void* rank,
                              const void* tloc, const void* cptr,
                              const void* cl, const void* cu, int count,
                              int bs, int wide, void* stream) {
  if (count == 0) return 0;
  return slu_chain::by_geometry<float, false>(bs, count, wide, [&](auto geo) {
    using G = decltype(geo);
    return slu_chain::launch<G>(
        rdma_schur_kernel<G>, count, (cudaStream_t)stream,
        (const uint64_t*)tab, ndev, (const int32_t*)rank,
        (const int32_t*)tloc, (const int32_t*)cptr, (const int32_t*)cl,
        (const int32_t*)cu);
  });
}

// Pass 1 of a solve level over `count` chunks (the level's slice of
// qrank, qrow, qcptr): chunk q's products qcptr[q] .. qcptr[q+1] of
// cloc/csrc summed into row qrow[q] of rank qrank[q]'s chunk scratch.
extern "C" int slu_rdma_solve_chunks(const void* tab, int ndev,
                                     const void* qrank, const void* qrow,
                                     const void* qcptr, const void* cloc,
                                     const void* csrc, int count, int bs,
                                     int nrhs, void* stream) {
  if (count == 0) return 0;
  auto go = [&](auto launch) {
    return launch((const uint64_t*)tab, ndev, (const int32_t*)qrank,
                  (const int32_t*)qrow, (const int32_t*)qcptr,
                  (const int32_t*)cloc, (const int32_t*)csrc, count, nrhs,
                  (cudaStream_t)stream);
  };
  switch (bs) {
    case 32: return go(chunks_by_rt<32>);
    case 64: return go(chunks_by_rt<64>);
    case 128: return go(chunks_by_rt<128>);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Pass 2 over `count` partial jobs (the level's slice of rank, pos, send,
// dstc, chunkptr): job j's partial is minus the sum of its chunks
// chunkptr[j] .. chunkptr[j+1] (scratch rows from qrow) in chunk order.
extern "C" int slu_rdma_solve_sum(const void* tab, int ndev, int pc,
                                  const void* rank, const void* pos,
                                  const void* send, const void* dstc,
                                  const void* chunkptr, const void* qrow,
                                  int count, int bs, int nrhs, int level,
                                  void* stream) {
  if (count == 0) return 0;
  const dim3 grid(count, (nrhs + kRT - 1) / kRT);
  rdma_solve_sum_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)tab, ndev, pc, (const int32_t*)rank,
      (const int32_t*)pos, (const int32_t*)send, (const int32_t*)dstc,
      (const int32_t*)chunkptr, (const int32_t*)qrow, bs, nrhs, level);
  return (int)cudaGetLastError();
}

extern "C" int slu_rdma_solve_diag(const void* tab, int ndev, int pc,
                                   const void* rank, const void* row,
                                   const void* pos, const void* inv,
                                   int count, int bs, int nrhs, int level,
                                   void* stream) {
  if (count == 0) return 0;
  const dim3 grid(count, (nrhs + kRT - 1) / kRT);
  const size_t smem = (size_t)2 * kRT * bs * sizeof(float);
  rdma_solve_diag_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)tab, ndev, pc, (const int32_t*)rank,
      (const int32_t*)row, (const int32_t*)pos, (const int32_t*)inv, bs, nrhs,
      level);
  return (int)cudaGetLastError();
}
