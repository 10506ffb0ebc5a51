// passes.cuh: the two passes over chains of block products cut into
// chunks, shared by flk.cu (flk's target groups, both passes) and tck.cu
// (tck's phase B in the bf16 pass).
//
// What they compute, for each target t (a block T at pool slot tslot[t])
// whose chain of products p, each L(cl[p]) . U(cu[p]), the host cut into
// chunks in chain order (flk.py::build_flk_tapes, tck.py::_chain_tapes):
//   pass 1, one CTA per (chunk q, band): a target of one chunk is finished
//     here, T <- T - (its products), then its finalize (FIN_L T . uinv,
//     FIN_U linv . T, none for FIN_NONE), stored once; a chunk of a target
//     of several writes 0 - (its products) to its scratch row qrow[q];
//   pass 2, one CTA per (target of several chunks, band): T plus its
//     chunks' rows in chunk order, then its finalize, stored once.
// Sums run in a fixed order (chunks in chain order, products in chain
// order within a chunk, each product's k ascending), with no atomics, so a
// factor repeats bit for bit. chain.cuh says how a band is owned.
//
// The FP32 pass (flk.cu's _f32 entries): chain.cuh's staged chain product
// (chain_band), every thread loading and multiplying, a cp.async ring and
// one __syncthreads per chunk.
//
// The bf16 pass (flk.cu's and tck.cu's _bf16 entries: the TPU kernels'
// dot() at precision "default", flk.py:439-441 and tck.py:226-228 there,
// one bf16 pass with float32 accumulation): the same passes, chunks, ring
// and order on ChainMma, every product and the finalize on the tensor
// cores through mma.cuh's m16n8k16 bf16 tiles. The band is held in the C
// layout (a warp owns whole 16 x 8 tiles: panel.cuh's PanelMma, 2 x 4
// tiles a warp in bands of 64, 1 x 4 in bands of 16 rows, 2 x 2 in bands
// of 16 columns), the staged rows of B are N + 4 floats apart, and the
// band as the finalize's operand is kept with rows of BS + 4 floats: as A
// (rows of the band) or transposed as B (a column of the band per row),
// so that its fragments and the inverse's are read without bank
// conflicts and the bands of 64 with a finalize keep two CTAs an SM (113
// KiB). Operands are rounded to bf16 as their fragments are built; the
// sums, the pool, the scratch rows and the band stay float32. The
// kernels take tstep and tfin null for targets without a finalize (tck's
// phase B), so flk's FP32 kernels above stay as they were.
//
// Hopper versions of this product were built and measured against it on
// an H100 80GB HBM3 at 700 W (tools/flk_ab.py --bf16 and tools/tck_ab.py
// --bf16; PERF.md §6, PR 24), and dropped: a producer warp issuing TMA 2D
// boxes of each chunk (waves.cuh's tensor maps, 128/64-byte swizzle) into
// an mbarrier ring of up to 8 stages, consumer warps releasing a stage by
// one arrival each (no barrier of the CTA per chunk), fragments from the
// swizzled float boxes, the band rounded to bf16 once for the finalize.
// With 8 consumer warps (one CTA an SM) it ran 7-18% slower than this
// ring (flk_bf16 4.06 against 3.78 ms on lap3d32, 25.30 against 21.48 on
// lap3d50); with 4 warps of 32 x 64 tiles (two CTAs an SM) it tied (3.73
// against 3.75; 21.79 against 21.35, tck's phase B 11.30 against 11.21),
// winning on the groups of finalizes alone and losing on the chained
// products; as persistent CTAs streaming every chunk of pass 1 through
// one ring it spilled and ran 1.25-1.43x slower (4.76 against 3.82;
// 30.34 against 21.27). This ring's time (the step-1 split of a band
// product on an SM, 5.3 us on lap3d32's five costliest groups) is per-CTA
// work more than barriers: its barriers-only cut still takes 2.4 us (the
// band loaded and stored, the launch and the ring's fill), fragments and
// mma 1.7, bytes in flight 2.2. A design that beats it has to cut those
// (a cluster sharing the A block between a chunk's two bands, half the
// bytes in flight) without more registers.

#pragma once

#include "chain.cuh"
#include "mma.cuh"

namespace {

using slu_chain::chain_band;
using slu_chain::FIN_L;
using slu_chain::FIN_NONE;
using slu_panel::cp_async_commit;
using slu_panel::cp_async_wait;
using slu_panel::load_tile;
using slu_panel::stage_chunk;
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
  if (fin == FIN_L && row < 0)
    chunk_band<G, false>(pool, linv, uinv, scratch, t, row, qcptr[q],
                         qcptr[q + 1], tslot, tstep, fin, cl, cu);
  else
    chunk_band<G, true>(pool, linv, uinv, scratch, t, row, qcptr[q],
                        qcptr[q + 1], tslot, tstep, fin, cl, cu);
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
  if (fin == FIN_L)
    sum_band<G, false>(pool, linv, uinv, scratch, t, mrow[j], mcnt[j],
                       tslot, tstep, fin);
  else
    sum_band<G, true>(pool, linv, uinv, scratch, t, mrow[j], mcnt[j],
                      tslot, tstep, fin);
}

// ---------------------------------------------------------------------------
// The bf16 pass (the header says how it is laid out)
// ---------------------------------------------------------------------------

// The bf16 pass's geometry of a float Chain G with a finalize: the warp
// tiles of either orientation (Mma<LEFT>), a ring stage that holds either
// orientation's chunk with B rows padded, and the band as the finalize's
// operand with rows of LDT floats.
template <class G>
struct ChainMma : G {
  static_assert(G::HAS_FIN && G::template Band<true>::W == 4,
                "the bf16 pass is float's, with a finalize");
  template <bool LEFT>
  using Mma = slu_panel::PanelMma<typename G::template Band<LEFT>>;
  static constexpr int kStage = Mma<true>::kStage > Mma<false>::kStage
                                    ? Mma<true>::kStage
                                    : Mma<false>::kStage;
  static constexpr int LDT = G::BS + 4;
  static constexpr int kFin = G::BM * LDT;
  static constexpr size_t kBytes =
      (size_t)(G::STAGES * kStage + kFin) * sizeof(float);
  static_assert(kBytes <= 113 * 1024, "shared memory: two CTAs per SM");
};

// chain_band in the bf16 pass (G a ChainMma): the same chunks, ring and
// order; acc holds this warp's tiles of the band in the C layout (rows
// r0 + 16 i, columns c0 + 8 j of Band<LEFT>).
template <class G, bool LEFT, typename Src>
__device__ __forceinline__ void chain_band_mma(
    float* smem, int np, const float* inv, Src src, int r0, int c0,
    float (&acc)[G::template Mma<LEFT>::WM][G::template Mma<LEFT>::WN][4]) {
  using P = typename G::template Band<LEFT>;
  using Q = typename G::template Mma<LEFT>;
  constexpr int ST = G::STAGES, KC = P::KC, WM = Q::WM, WN = Q::WN;
  constexpr int NK = G::BS / KC;   // chunks per product
  float* fin = smem + ST * G::kStage;
  const bool has_fin = inv != nullptr;
  const int nchunks = (np + (has_fin ? 1 : 0)) * NK;

  // the band as the finalize's operand: B transposed (LEFT: row q of fin
  // is column q of the band) or A (rows of the band), rows LDT apart
  auto put_fin = [&]() {
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        if constexpr (LEFT)
          slu_mma::store_ct<G::LDT>(fin, r0 + 16 * i, c0 + 8 * j, acc[i][j]);
        else
          slu_mma::store_c<G::LDT>(fin, r0 + 16 * i, c0 + 8 * j, acc[i][j]);
      }
  };
  auto load = [&](int c) {
    const int p = c / NK;
    const float* Ag = LEFT ? inv : nullptr;
    const float* Bg = LEFT ? nullptr : inv;
    if (p < np) src(p, Ag, Bg);
    stage_chunk<P, Q::LDB>(smem + (c % ST) * G::kStage, Ag, Bg,
                           (c % NK) * KC);
  };

  if (has_fin && np == 0) put_fin();   // read after the first barrier
#pragma unroll
  for (int c = 0; c < ST - 1; ++c) {
    if (c < nchunks) load(c);
    cp_async_commit();
  }
  float prod[WM][WN][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) prod[i][j][e] = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<ST - 2>();   // chunk c has landed
    __syncthreads();           // ... for every thread; stage c-1 is free
    if (c + ST - 1 < nchunks) load(c + ST - 1);
    cp_async_commit();
    const int p = c / NK;
    const float* st = smem + (c % ST) * G::kStage;
    if (p < np) {
      slu_mma::mma_chunk<KC, P::LDA, Q::LDB, WM, WN>(st, st + P::kA, r0, c0,
                                                    prod);
    } else {
      const int k0 = (c % NK) * KC;
      if constexpr (LEFT)
        slu_mma::mma_chunk<KC, P::LDA, G::LDT, WM, WN, true>(
            st, fin + k0, r0, c0, prod);
      else
        slu_mma::mma_chunk<KC, G::LDT, Q::LDB, WM, WN>(
            fin + k0, st + P::kA, r0, c0, prod);
    }
    if (c % NK == NK - 1) {   // product p (or the finalize) is complete
#pragma unroll
      for (int i = 0; i < WM; ++i)
#pragma unroll
        for (int j = 0; j < WN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][j][e] =
                p < np ? acc[i][j][e] - prod[i][j][e] : prod[i][j][e];
            prod[i][j][e] = 0.f;
          }
      if (has_fin && p == np - 1) put_fin();   // read after the next barrier
    }
  }
}

// This warp's first row and column of the band in the bf16 pass (G a
// ChainMma): panel.cuh's PanelMma tiles of Band<LEFT>.
template <class G, bool LEFT>
__device__ __forceinline__ void mma_origin(int& r0, int& c0) {
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
  mma_origin<G, LEFT>(r0, c0);
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
  chain_band_mma<G, LEFT>(
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
  mma_origin<G, LEFT>(r0, c0);
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
  chain_band_mma<G, LEFT>(
      reinterpret_cast<float*>(smem4), 0, inv,
      [](int, const float*&, const float*&) {}, r0, c0, acc);
#pragma unroll
  for (int i = 0; i < Q::WM; ++i)
#pragma unroll
    for (int j = 0; j < Q::WN; ++j)
      slu_mma::store_c<G::BS>(X, r0 + 16 * i, c0 + 8 * j, acc[i][j]);
}

// pass 1 and pass 2 of the bf16 pass on ChainMma (the grids and tapes of
// flk_chunks_kernel and flk_sum_kernel; tstep and tfin may be null)
template <class G>
__global__ void __launch_bounds__(G::NT)
chunks_mma_kernel(float* pool, const float* __restrict__ linv,
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
  const int fin = tfin != nullptr ? tfin[t] : FIN_NONE;
  const int row = qrow[q];
  if (fin == FIN_L && row < 0)
    chunk_band_mma<G, false>(pool, linv, uinv, scratch, t, row, qcptr[q],
                             qcptr[q + 1], tslot, tstep, fin, cl, cu);
  else
    chunk_band_mma<G, true>(pool, linv, uinv, scratch, t, row, qcptr[q],
                            qcptr[q + 1], tslot, tstep, fin, cl, cu);
}

template <class G>
__global__ void __launch_bounds__(G::NT)
sum_mma_kernel(float* pool, const float* __restrict__ linv,
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
  const int fin = tfin != nullptr ? tfin[t] : FIN_NONE;
  if (fin == FIN_L)
    sum_band_mma<G, false>(pool, linv, uinv, scratch, t, mrow[j], mcnt[j],
                           tslot, tstep, fin);
  else
    sum_band_mma<G, true>(pool, linv, uinv, scratch, t, mrow[j], mcnt[j],
                          tslot, tstep, fin);
}

// Pass 1 of the bf16 pass over `count` chunks (as flk.cu's
// slu_flk_chunks_f32; tstep and tfin null where no target has a
// finalize).
inline int chunks_bf16(void* pool, const void* linv, const void* uinv,
                       void* scratch, const void* qtgt, const void* qrow,
                       const void* qcptr, const void* tslot,
                       const void* tstep, const void* tfin, const void* cl,
                       const void* cu, int count, int bs, int wide,
                       void* stream) {
  using I = const int32_t*;
  if (count == 0) return 0;
  return slu_chain::by_geometry<float, true>(bs, count, wide, [&](auto geo) {
    using G = ChainMma<decltype(geo)>;
    return slu_chain::launch<G>(
        chunks_mma_kernel<G>, count, (cudaStream_t)stream, (float*)pool,
        (const float*)linv, (const float*)uinv, (float*)scratch, (I)qtgt,
        (I)qrow, (I)qcptr, (I)tslot, (I)tstep, (I)tfin, (I)cl, (I)cu);
  });
}

// Pass 2 of the bf16 pass over `count` targets of several chunks (as
// flk.cu's slu_flk_sum_f32; tstep and tfin null where no target has a
// finalize).
inline int sum_bf16(void* pool, const void* linv, const void* uinv,
                    const void* scratch, const void* mtgt, const void* mrow,
                    const void* mcnt, const void* tslot, const void* tstep,
                    const void* tfin, int count, int bs, int wide,
                    void* stream) {
  using I = const int32_t*;
  if (count == 0) return 0;
  return slu_chain::by_geometry<float, true>(bs, count, wide, [&](auto geo) {
    using G = ChainMma<decltype(geo)>;
    return slu_chain::launch<G>(
        sum_mma_kernel<G>, count, (cudaStream_t)stream, (float*)pool,
        (const float*)linv, (const float*)uinv, (const float*)scratch,
        (I)mtgt, (I)mrow, (I)mcnt, (I)tslot, (I)tstep, (I)tfin);
  });
}

}  // namespace
