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
// with float32 accumulation): the same two passes on passes.cuh's bf16
// chain product (ChainMma: the products and the finalize on the tensor
// cores, mma.cuh). Pass 1's scratch rows stay float32 and pass 2 sums them
// in the same order. Bounded by the same operations at the bf16
// tensor-core peak (989 TFLOP/s dense) or by the bytes of the distinct
// blocks a group reads and writes; its fragments are built from the
// float32 chunks with shared-memory loads (passes.cuh says what a Hopper
// ring of TMA boxes did against it). diag_lu,
// between the two groups of a level, stays at full precision
// (flk.py:360-362 there).
//
// The kernels and their bodies live in passes.cuh, which tck.cu shares.

#include "passes.cuh"

namespace {

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
  return chunks_bf16(pool, linv, uinv, scratch, qtgt, qrow, qcptr, tslot,
                     tstep, tfin, cl, cu, count, bs, wide, stream);
}

// slu_flk_sum_f32 in the bf16 pass.
extern "C" int slu_flk_sum_bf16(void* pool, const void* linv,
                                const void* uinv, const void* scratch,
                                const void* mtgt, const void* mrow,
                                const void* mcnt, const void* tslot,
                                const void* tstep, const void* tfin,
                                int count, int bs, int wide, void* stream) {
  return sum_bf16(pool, linv, uinv, scratch, mtgt, mrow, mcnt, tslot, tstep,
                  tfin, count, bs, wide, stream);
}
