// flk.cu: the fused left-looking factor over write-once targets, one
// group of targets of one elimination level per launch.
//
// Replaces: superlu_dist_tpu/ops/kernels/flk.py::_flk_kernel (called by
// _flk_seg_call), the TPU's single-call factor that serves ILU(k) plans
// and executor="flk". Its FIN_DIAG finalize (the tile LU with inverses)
// is the separate diag_lu kernel (diag_lu.cu).
//
// What it computes, for each target t of the launch (a stored block T at
// pool slot tslot[t], owned by elimination step tstep[t]):
//   T <- T - sum over t's contributions p of L(I,j) . U(j,K)
//        with (cl[p], cu[p]) over cptr[t] .. cptr[t+1], in that order,
//   then, by tfin[t]: nothing (a diagonal block, which diag_lu factors
//   next), T . uinv[step] (an L panel) or linv[step] . T (a U panel).
// Every contribution into a target of step k comes from a step at a
// strictly lower elimination level (flk.py:29-32), so one launch per
// level and group on one stream replaces the TPU's sequential grid and
// its window hazard analysis: per level, the diagonal targets, then
// diag_lu, then the L and U panel targets.
//
// What bounds it on an H100: operations, 2*bs^3 per block product in FP32
// on the CUDA cores (67 TFLOP/s peak), and at the top of the elimination
// tree the length of one target's contribution chain, which one CTA walks.
//
// Design: one CTA per (target, strip of 16 scalar columns, or rows for an
// L panel), bs threads, each owning a 4x4 tile of the strip in registers
// (strip.cuh). A target is read once and written once; the strips of a
// target and the targets of a level are independent, so there are no
// atomics and every sum runs in the plan's fixed order.

#include "strip.cuh"

namespace {

__global__ void __launch_bounds__(slu_strip::kMaxBs)
flk_kernel(float* pool, const float* __restrict__ linv,
           const float* __restrict__ uinv, const int32_t* __restrict__ tslot,
           const int32_t* __restrict__ tstep,
           const int32_t* __restrict__ tfin,
           const int32_t* __restrict__ cptr, const int32_t* __restrict__ cl,
           const int32_t* __restrict__ cu, int bs) {
  const int t = blockIdx.x;
  slu_strip::strip_update<float>(pool, linv, uinv, tslot[t], tstep[t],
                                 tfin[t], cl, cu, cptr[t], cptr[t + 1], bs,
                                 blockIdx.y);
}

}  // namespace

extern "C" int slu_flk_f32(void* pool, const void* linv, const void* uinv,
                           const void* tslot, const void* tstep,
                           const void* tfin, const void* cptr,
                           const void* cl, const void* cu, int count, int bs,
                           void* stream) {
  if (count == 0) return 0;
  const dim3 grid(count, bs / slu_strip::kStrip);
  flk_kernel<<<grid, bs, 0, (cudaStream_t)stream>>>(
      (float*)pool, (const float*)linv, (const float*)uinv,
      (const int32_t*)tslot, (const int32_t*)tstep, (const int32_t*)tfin,
      (const int32_t*)cptr, (const int32_t*)cl, (const int32_t*)cu, bs);
  return (int)cudaGetLastError();
}
