// flk.cu: the fused left-looking factor over write-once targets, one
// group of targets of one elimination level per launch (two when the
// group's chains are cut into chunks).
//
// Replaces: superlu_dist_tpu/ops/kernels/flk.py::_flk_kernel (called by
// _flk_seg_call), the TPU's single-call factor that serves ILU(k) plans
// and executor="flk". Its FIN_DIAG finalize (the tile LU with inverses)
// is the separate diag_lu kernel (diag_lu.cu).
//
// What it computes, for each target t of the launch (a stored block T at
// pool slot tslot[t], owned by elimination step tstep[t]):
//   T <- T - sum over t's contributions p of L(I,j) . U(j,K)
//        with (cl[p], cu[p]) in the plan's order,
//   then, by tfin[t]: nothing (a diagonal block, which diag_lu factors
//   next), T . uinv[step] (an L panel) or linv[step] . T (a U panel).
// Every contribution into a target of step k comes from a step at a
// strictly lower elimination level (flk.py:29-32), so one launch per
// level and group on one stream replaces the TPU's sequential grid and
// its window hazard analysis: per level, the diagonal targets, then
// diag_lu, then the L and U panel targets.
//
// What bounds it on an H100: operations, 2*bs^3 per block product in FP32
// on the CUDA cores (67 TFLOP/s peak); and at the top of the elimination
// tree, where a group holds a few targets, the longest chain of products
// that one CTA walks.
//
// Design: chain.cuh's staged chain product, one CTA per (chunk, band of
// whole columns, or rows for an L panel). The host cuts each target's
// chain into chunks of at most 4 products in plan order
// (flk.py::build_flk_tapes, as sweep.py::chunk_chains cuts the solve's
// chains; shorter in a group whose bands would not fill the card), so
// that no CTA walks a long chain while the card idles.
//   slu_flk_chunks_f32 (pass 1): a target of one chunk is finished here
//     (its band loaded, its chain, its finalize, stored once); a chunk of
//     a target of several writes 0 - (its products) to its row of the
//     scratch buffer;
//   slu_flk_sum_f32 (pass 2): each target of several chunks: T plus its
//     chunks' rows in chunk order, then its finalize, stored once.
// Sums run in a fixed order (chunks in plan order, products in plan order
// within a chunk), with no atomics, so a factor repeats bit for bit.
//
// The _bf16 entries are the low pass of gemm_precision "default" (the TPU
// kernel's dot() at precision "default", flk.py:439-441 there: the chain
// product :532 and the panel finalizes :557 and :563 in one bf16 pass
// with float32 accumulation): the same kernels on chain.cuh's ChainMma
// geometry, the chain's products and the finalize on the tensor cores
// (mma.cuh). Pass 1's scratch rows stay float32 and pass 2 sums them in
// the same order. Bounded by the same operations at the bf16 tensor-core
// peak (989 TFLOP/s dense); this first version builds its fragments from
// the float32 chunks with scalar shared-memory loads, which bound it
// instead. diag_lu, between the two groups of a level, stays at full
// precision (flk.py:360-362 there).

#include "chain.cuh"

namespace {

using slu_chain::chain_band;
using slu_chain::FIN_L;
using slu_chain::FIN_NONE;
using slu_panel::load_tile;
using slu_panel::store_tile;

// the band's offset within its block: BM columns (LEFT) or BM rows
template <class G, bool LEFT>
__device__ __forceinline__ int64_t band_off() {
  return LEFT ? (int64_t)blockIdx.y * G::BM
              : (int64_t)blockIdx.y * G::BM * G::BS;
}

// The body of one orientation. The kernels below choose an orientation per
// CTA and call one of two such bodies; each is a function of its own (not
// inlined): with both inlined into one kernel, the H100 build gave wrong
// sums under high occupancy (bs 64, bands of 16, three or more CTAs on an
// SM), which the bodies as separate functions do not.
template <class G, bool LEFT>
__device__ __noinline__ void chunk_band(
    float* pool, const float* linv, const float* uinv, float* scratch,
    int t, int row, int p0, int p1, const int32_t* tslot,
    const int32_t* tstep, int fin, const int32_t* cl, const int32_t* cu) {
  using P = typename G::template Band<LEFT>;
  extern __shared__ float4 smem4[];
  const int g = threadIdx.x / P::CT;
  const int c0 = (threadIdx.x % P::CT) * P::W;
  const int64_t bb = (int64_t)G::BS * G::BS;
  const int64_t off = band_off<G, LEFT>();
  float* X = (row < 0 ? pool + (int64_t)tslot[t] * bb
                      : scratch + (int64_t)row * bb) + off;
  float acc[4][P::TW];
  if (row < 0) {
    load_tile<P, G::BS>(X, g, c0, acc);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < P::TW; ++j) acc[i][j] = 0.f;
  }
  const float* inv = row >= 0 || fin == FIN_NONE
                         ? nullptr
                         : (LEFT ? linv : uinv) + (int64_t)tstep[t] * bb;
  chain_band<G, LEFT>(
      reinterpret_cast<float*>(smem4), p1 - p0, inv,
      [&](int p, const float*& Ag, const float*& Bg) {
        const float* L = pool + (int64_t)cl[p0 + p] * bb;
        const float* U = pool + (int64_t)cu[p0 + p] * bb;
        Ag = LEFT ? L : L + off;
        Bg = LEFT ? U + off : U;
      },
      g, c0, acc);
  store_tile<P, G::BS>(X, g, c0, acc);
}

// This warp's first row and column of the band in the bf16 pass (G a
// ChainMma): panel.cuh's PanelMma tiles of Band<LEFT>.
template <class G, bool LEFT>
__device__ __forceinline__ void warp_origin(int& r0, int& c0) {
  using Q = typename G::template Mma<LEFT>;
  const int warp = threadIdx.x >> 5;
  r0 = (warp / Q::WC) * 16 * Q::WM;
  c0 = (warp % Q::WC) * 8 * Q::WN;
}

// chunk_band in the bf16 pass: the band in the C layout, the chain on
// chain_band_mma.
template <class G, bool LEFT>
__device__ __noinline__ void chunk_band_mma(
    float* pool, const float* linv, const float* uinv, float* scratch,
    int t, int row, int p0, int p1, const int32_t* tslot,
    const int32_t* tstep, int fin, const int32_t* cl, const int32_t* cu) {
  using Q = typename G::template Mma<LEFT>;
  extern __shared__ float4 smem4[];
  int r0, c0;
  warp_origin<G, LEFT>(r0, c0);
  const int64_t bb = (int64_t)G::BS * G::BS;
  const int64_t off = band_off<G, LEFT>();
  float* X = (row < 0 ? pool + (int64_t)tslot[t] * bb
                      : scratch + (int64_t)row * bb) + off;
  float acc[Q::WM][Q::WN][4];
#pragma unroll
  for (int i = 0; i < Q::WM; ++i)
#pragma unroll
    for (int j = 0; j < Q::WN; ++j) {
      if (row < 0) {
        slu_mma::load_c<G::BS>(X, r0 + 16 * i, c0 + 8 * j, acc[i][j]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      }
    }
  const float* inv = row >= 0 || fin == FIN_NONE
                         ? nullptr
                         : (LEFT ? linv : uinv) + (int64_t)tstep[t] * bb;
  slu_chain::chain_band_mma<G, LEFT>(
      reinterpret_cast<float*>(smem4), p1 - p0, inv,
      [&](int p, const float*& Ag, const float*& Bg) {
        const float* L = pool + (int64_t)cl[p0 + p] * bb;
        const float* U = pool + (int64_t)cu[p0 + p] * bb;
        Ag = LEFT ? L : L + off;
        Bg = LEFT ? U + off : U;
      },
      r0, c0, acc);
#pragma unroll
  for (int i = 0; i < Q::WM; ++i)
#pragma unroll
    for (int j = 0; j < Q::WN; ++j)
      slu_mma::store_c<G::BS>(X, r0 + 16 * i, c0 + 8 * j, acc[i][j]);
}

// pass 1: one CTA per (chunk q, band); chunk q belongs to target qtgt[q],
// holds the products qcptr[q] .. qcptr[q+1] and writes scratch row
// qrow[q], or the target itself when qrow[q] < 0
template <class G>
__global__ void __launch_bounds__(G::NT)
flk_chunks_kernel(float* pool, const float* __restrict__ linv,
                  const float* __restrict__ uinv, float* scratch,
                  const int32_t* __restrict__ qtgt,
                  const int32_t* __restrict__ qrow,
                  const int32_t* __restrict__ qcptr,
                  const int32_t* __restrict__ tslot,
                  const int32_t* __restrict__ tstep,
                  const int32_t* __restrict__ tfin,
                  const int32_t* __restrict__ cl,
                  const int32_t* __restrict__ cu) {
  const int q = blockIdx.x;
  const int t = qtgt[q];
  const int fin = tfin[t];
  const int row = qrow[q];
  // only an L panel's finalize needs bands of rows; a partial sum (no
  // finalize) takes bands of columns, as pass 2 reads whole scratch rows
  if constexpr (G::BF16) {
    if (fin == FIN_L && row < 0)
      chunk_band_mma<G, false>(pool, linv, uinv, scratch, t, row, qcptr[q],
                               qcptr[q + 1], tslot, tstep, fin, cl, cu);
    else
      chunk_band_mma<G, true>(pool, linv, uinv, scratch, t, row, qcptr[q],
                              qcptr[q + 1], tslot, tstep, fin, cl, cu);
  } else {
    if (fin == FIN_L && row < 0)
      chunk_band<G, false>(pool, linv, uinv, scratch, t, row, qcptr[q],
                           qcptr[q + 1], tslot, tstep, fin, cl, cu);
    else
      chunk_band<G, true>(pool, linv, uinv, scratch, t, row, qcptr[q],
                          qcptr[q + 1], tslot, tstep, fin, cl, cu);
  }
}

template <class G, bool LEFT>
__device__ __noinline__ void sum_band(float* pool, const float* linv,
                                         const float* uinv,
                                         const float* scratch, int t,
                                         int row, int n,
                                         const int32_t* tslot,
                                         const int32_t* tstep, int fin) {
  using P = typename G::template Band<LEFT>;
  extern __shared__ float4 smem4[];
  const int g = threadIdx.x / P::CT;
  const int c0 = (threadIdx.x % P::CT) * P::W;
  const int64_t bb = (int64_t)G::BS * G::BS;
  const int64_t off = band_off<G, LEFT>();
  float* X = pool + (int64_t)tslot[t] * bb + off;
  const float* S = scratch + (int64_t)row * bb + off;
  float acc[4][P::TW];
  load_tile<P, G::BS>(X, g, c0, acc);
#pragma unroll 4
  for (int q = 0; q < n; ++q) {   // the chunks in chunk order
    float s[4][P::TW];
    load_tile<P, G::BS>(S + q * bb, g, c0, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < P::TW; ++j) acc[i][j] += s[i][j];
  }
  const float* inv = fin == FIN_NONE
                         ? nullptr
                         : (LEFT ? linv : uinv) + (int64_t)tstep[t] * bb;
  chain_band<G, LEFT>(
      reinterpret_cast<float*>(smem4), 0, inv,
      [](int, const float*&, const float*&) {}, g, c0, acc);
  store_tile<P, G::BS>(X, g, c0, acc);
}

// sum_band in the bf16 pass: the chunks' rows added in chunk order in the
// C layout, then the finalize on chain_band_mma.
template <class G, bool LEFT>
__device__ __noinline__ void sum_band_mma(float* pool, const float* linv,
                                          const float* uinv,
                                          const float* scratch, int t,
                                          int row, int n,
                                          const int32_t* tslot,
                                          const int32_t* tstep, int fin) {
  using Q = typename G::template Mma<LEFT>;
  extern __shared__ float4 smem4[];
  int r0, c0;
  warp_origin<G, LEFT>(r0, c0);
  const int64_t bb = (int64_t)G::BS * G::BS;
  const int64_t off = band_off<G, LEFT>();
  float* X = pool + (int64_t)tslot[t] * bb + off;
  const float* S = scratch + (int64_t)row * bb + off;
  float acc[Q::WM][Q::WN][4];
#pragma unroll
  for (int i = 0; i < Q::WM; ++i)
#pragma unroll
    for (int j = 0; j < Q::WN; ++j)
      slu_mma::load_c<G::BS>(X, r0 + 16 * i, c0 + 8 * j, acc[i][j]);
  // rolled: unrolled by 4 it spilled 8 bytes (bs 64, bands of 64 rows)
#pragma unroll 1
  for (int q = 0; q < n; ++q) {   // the chunks in chunk order
#pragma unroll
    for (int i = 0; i < Q::WM; ++i)
#pragma unroll
      for (int j = 0; j < Q::WN; ++j) {
        float s[4];
        slu_mma::load_c<G::BS>(S + q * bb, r0 + 16 * i, c0 + 8 * j, s);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += s[e];
      }
  }
  const float* inv = fin == FIN_NONE
                         ? nullptr
                         : (LEFT ? linv : uinv) + (int64_t)tstep[t] * bb;
  slu_chain::chain_band_mma<G, LEFT>(
      reinterpret_cast<float*>(smem4), 0, inv,
      [](int, const float*&, const float*&) {}, r0, c0, acc);
#pragma unroll
  for (int i = 0; i < Q::WM; ++i)
#pragma unroll
    for (int j = 0; j < Q::WN; ++j)
      slu_mma::store_c<G::BS>(X, r0 + 16 * i, c0 + 8 * j, acc[i][j]);
}

// pass 2: one CTA per (target mtgt[j] of several chunks, band); its
// chunks are the mcnt[j] scratch rows from mrow[j]
template <class G>
__global__ void __launch_bounds__(G::NT)
flk_sum_kernel(float* pool, const float* __restrict__ linv,
               const float* __restrict__ uinv,
               const float* __restrict__ scratch,
               const int32_t* __restrict__ mtgt,
               const int32_t* __restrict__ mrow,
               const int32_t* __restrict__ mcnt,
               const int32_t* __restrict__ tslot,
               const int32_t* __restrict__ tstep,
               const int32_t* __restrict__ tfin) {
  const int j = blockIdx.x;
  const int t = mtgt[j];
  const int fin = tfin[t];
  if constexpr (G::BF16) {
    if (fin == FIN_L)
      sum_band_mma<G, false>(pool, linv, uinv, scratch, t, mrow[j], mcnt[j],
                             tslot, tstep, fin);
    else
      sum_band_mma<G, true>(pool, linv, uinv, scratch, t, mrow[j], mcnt[j],
                            tslot, tstep, fin);
  } else {
    if (fin == FIN_L)
      sum_band<G, false>(pool, linv, uinv, scratch, t, mrow[j], mcnt[j],
                         tslot, tstep, fin);
    else
      sum_band<G, true>(pool, linv, uinv, scratch, t, mrow[j], mcnt[j],
                        tslot, tstep, fin);
  }
}

using I = const int32_t*;

}  // namespace

// Pass 1 over `count` chunks (int32 device arrays qtgt, qrow, qcptr at
// the group's first chunk; tslot, tstep, tfin, cl, cu whole). `wide` < 0
// chooses the band geometry by chain.cuh's rule, 0 / 1 force bands of 16
// / 64. Returns the cudaError_t of the launch.
extern "C" int slu_flk_chunks_f32(void* pool, const void* linv,
                                  const void* uinv, void* scratch,
                                  const void* qtgt, const void* qrow,
                                  const void* qcptr, const void* tslot,
                                  const void* tstep, const void* tfin,
                                  const void* cl, const void* cu, int count,
                                  int bs, int wide, void* stream) {
  if (count == 0) return 0;
  return slu_chain::by_geometry<float, true>(bs, count, wide, [&](auto geo) {
    using G = decltype(geo);
    return slu_chain::launch<G>(
        flk_chunks_kernel<G>, count, (cudaStream_t)stream, (float*)pool,
        (const float*)linv, (const float*)uinv, (float*)scratch, (I)qtgt,
        (I)qrow, (I)qcptr, (I)tslot, (I)tstep, (I)tfin, (I)cl, (I)cu);
  });
}

// Pass 2 over `count` targets of several chunks (mtgt, mrow, mcnt at the
// group's first such target).
extern "C" int slu_flk_sum_f32(void* pool, const void* linv,
                               const void* uinv, const void* scratch,
                               const void* mtgt, const void* mrow,
                               const void* mcnt, const void* tslot,
                               const void* tstep, const void* tfin, int count,
                               int bs, int wide, void* stream) {
  if (count == 0) return 0;
  return slu_chain::by_geometry<float, true>(bs, count, wide, [&](auto geo) {
    using G = decltype(geo);
    return slu_chain::launch<G>(
        flk_sum_kernel<G>, count, (cudaStream_t)stream, (float*)pool,
        (const float*)linv, (const float*)uinv, (const float*)scratch,
        (I)mtgt, (I)mrow, (I)mcnt, (I)tslot, (I)tstep, (I)tfin);
  });
}

// slu_flk_chunks_f32 in the bf16 pass.
extern "C" int slu_flk_chunks_bf16(void* pool, const void* linv,
                                   const void* uinv, void* scratch,
                                   const void* qtgt, const void* qrow,
                                   const void* qcptr, const void* tslot,
                                   const void* tstep, const void* tfin,
                                   const void* cl, const void* cu, int count,
                                   int bs, int wide, void* stream) {
  if (count == 0) return 0;
  return slu_chain::by_geometry<float, true>(bs, count, wide, [&](auto geo) {
    using G = slu_chain::ChainMma<decltype(geo)>;
    return slu_chain::launch<G>(
        flk_chunks_kernel<G>, count, (cudaStream_t)stream, (float*)pool,
        (const float*)linv, (const float*)uinv, (float*)scratch, (I)qtgt,
        (I)qrow, (I)qcptr, (I)tslot, (I)tstep, (I)tfin, (I)cl, (I)cu);
  });
}

// slu_flk_sum_f32 in the bf16 pass.
extern "C" int slu_flk_sum_bf16(void* pool, const void* linv,
                                const void* uinv, const void* scratch,
                                const void* mtgt, const void* mrow,
                                const void* mcnt, const void* tslot,
                                const void* tstep, const void* tfin,
                                int count, int bs, int wide, void* stream) {
  if (count == 0) return 0;
  return slu_chain::by_geometry<float, true>(bs, count, wide, [&](auto geo) {
    using G = slu_chain::ChainMma<decltype(geo)>;
    return slu_chain::launch<G>(
        flk_sum_kernel<G>, count, (cudaStream_t)stream, (float*)pool,
        (const float*)linv, (const float*)uinv, (const float*)scratch,
        (I)mtgt, (I)mrow, (I)mcnt, (I)tslot, (I)tstep, (I)tfin);
  });
}
