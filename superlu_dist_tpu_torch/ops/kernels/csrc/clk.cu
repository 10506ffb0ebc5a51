// clk.cu: the left-looking column factor: the update in source-ready
// waves, and the L-part TRSM.
//
// Replaces: superlu_dist_tpu/ops/kernels/clk.py::_clk_kernel (called by
// _clk_seg_call), the column-resident left-looking factor of the TPU.
// Its diagonal LU is the separate diag_lu kernel (diag_lu.cu).
//
// What it computes, for each block column k of one elimination level
// (pool slots of column k are contiguous: U(j,k) for ascending j, the
// diagonal block, then L(i,k) for ascending i):
//   clk_update: every stored block (i,k) becomes
//                 (i,k) - sum of L(i,j) . U(j,k)
//               over the column's U blocks U(j,k) with j < i and L(i,j)
//               stored, and every U block is then finalized as
//                 U(i,k) <- linv(i) . U(i,k)
//               (the exact-LU fill closure guarantees every (i,k) that
//               the sum reaches is stored).
//   clk_trsm:   L(i,k) <- L(i,k) . uinv(k) for every L block of the level.
// Column k depends only on columns of lower levels, so the columns of one
// level run in parallel; the level order replaces the TPU's sequential
// grid, one launch per phase per level on one stream.
//
// What bounds it on an H100: operations, 2*bs^3 per block product in
// FP32 on the CUDA cores (67 TFLOP/s peak), and at the top of the
// elimination tree the dependencies inside a column: U(i,k) can be
// finalized only after every U(j,k) that it depends on (L(i,j) stored).
//
// Design of clk_update: waves.cuh's update in source-ready waves (shared
// with tck.cu's phase A): one launch per wave, one CTA per (target,
// strip of TN scalar columns), the operands streamed through a cp.async
// ring; a target's sum runs by source wave, then ascending j, where the
// JAX kernel runs by ascending j alone.
//
// clk_trsm is panel.cuh's band-times-inverse kernel (shared with
// schur.cu's trsm): one CTA per (L block, band of whole rows), the band
// and the inverse streamed through a cp.async ring, the band written back
// in place once all of it has been read. Offsets are computed in 64 bits
// (slot * bs^2 passes 2^31 near n = 885k).
//
// The _bf16 entries are the low pass of gemm_precision "default" (the TPU
// kernel's dot() at precision "default", clk.py:257-259 there: the U
// finalize, the pair GEMM and the L-part TRSM in one bf16 pass with
// float32 accumulation), the products on the tensor cores (mma.cuh).
// Bounded by the bytes of its pool blocks (their operations at the bf16
// tensor-core peak, 989 TFLOP/s dense, take about a sixth of that).
// clk_update's is waves.cuh's wave_mma_kernel: a producer warp, bulk
// copies on mbarriers, and per wave the strip width and ring depth that
// the host chooses (clk.py::wave_geoms); clk_trsm's is panel.cuh's
// trsm_mma_kernel: one CTA per (L block, band of rows), uinv(k) rounded
// to bf16 once in shared memory.

#include "panel.cuh"
#include "waves.cuh"

namespace {

// clk_update's columns per strip: 8 and 32 were no faster on an H100
// (superlu_dist_tpu_torch/tools/clk_strip_ab.py rewrites this line)
constexpr int TN = 16;

}  // namespace

// The update of one level: `nwaves` launches, wave w over the targets
// wptr[w] .. wptr[w+1] (wptr is a host array of nwaves + 1 entries).
extern "C" int slu_clk_waves_f32(void* pool, const void* linv,
                                 const void* tslot, const void* tstep,
                                 const void* tfin, const void* pptr,
                                 const void* cl, const void* cu,
                                 const void* wptr, int nwaves, int bs,
                                 void* stream) {
  return slu_waves::waves_f32<TN>(pool, linv, tslot, tstep, tfin, pptr, cl,
                                  cu, wptr, nwaves, bs, stream);
}

// slu_clk_waves_f32 in the bf16 pass, wave w at the geometry geom[w]
// (a host array: strip width << 8 | ring depth); the pool holds `nslots`
// blocks and linv `ninv`.
extern "C" int slu_clk_waves_bf16(void* pool, const void* linv,
                                  const void* tslot, const void* tstep,
                                  const void* tfin, const void* pptr,
                                  const void* cl, const void* cu,
                                  const void* wptr, const void* geom,
                                  int nwaves, int bs, int64_t nslots,
                                  int64_t ninv, void* stream) {
  return slu_waves::waves_bf16(pool, linv, tslot, tstep, tfin, pptr, cl, cu,
                               wptr, geom, nwaves, bs, nslots, ninv, stream);
}

// L(i,k) <- L(i,k) . uinv(k) over the level's L blocks: the same function
// as schur.cu's trsm with left = 0, launched and counted apart.
extern "C" int slu_clk_trsm_f32(void* pool, const void* uinv,
                                const void* lslots, const void* lsteps,
                                int count, int bs, void* stream) {
  return slu_panel::trsm<float>(pool, uinv, lslots, lsteps, count, bs, 0,
                                stream);
}

// slu_clk_trsm_f32 in the bf16 pass.
extern "C" int slu_clk_trsm_bf16(void* pool, const void* uinv,
                                 const void* lslots, const void* lsteps,
                                 int count, int bs, void* stream) {
  return slu_panel::trsm_bf16(pool, uinv, lslots, lsteps, count, bs,
                              stream);
}
