// schur.cu: the two device phases of the level-by-level (right-looking)
// factor executor after the diagonal batch: the panel TRSMs and the Schur
// update of one elimination level.
//
// Replaces: superlu_dist_tpu/ops/kernels/pallas_exec.py
//   - _trsm_kernel (make_trsm_call), both flags, by `trsm`:
//       left = 0 (L panels):  X <- X . dinv[step]
//       left = 1 (U panels):  X <- dinv[step] . X
//     in place over a list of (slot, step);
//   - _schur_kernel (make_schur_call) and _schur_kernel_db
//     (make_schur_call_db), which compute the same function with single-
//     and double-buffered DMA windows, by one kernel `schur`:
//       T <- T - sum of L . U over the level's (L slot, U slot) pairs of
//       each target T.
// The TPU kernels walk window-scheduled lanes on a sequential grid, and
// the host keeps two lanes of a window (and, double-buffered, of adjacent
// windows) off one target; the single-buffered form still lost
// contributions on shared root targets (pallas_exec.py:407-412). Here the
// level's triples are grouped by target (a CSR over targets): one CTA owns
// one strip of one target and sums its products in the plan's order, with
// no atomics, so a target shared by many steps of the level cannot lose a
// contribution. A level's targets belong to ancestor steps, so no target
// is an L or U source of the same level.
//
// What bounds them on an H100: operations, 2*bs^3 per block product or
// panel (FP32 on the CUDA cores, 67 TFLOP/s peak; FP64, which float64
// factors run, 67 TFLOP/s on the tensor cores, of which these kernels
// reach at most the CUDA cores' 34).
//
// Design: `schur` is strip.cuh's strip update, one CTA of bs threads per
// (target, strip of 16 scalar columns). `trsm` is panel.cuh's band-times-
// inverse kernel (shared with clk.cu's clk_trsm): one CTA per (panel, band
// of whole rows or columns), the band and the inverse staged in shared
// memory by cp.async. Both are templates on the element type; the _f32
// and _f64 entries launch the float and double instantiations.

#include "panel.cuh"
#include "strip.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(slu_strip::kMaxBs)
schur_kernel(T* pool, const int32_t* __restrict__ tslot,
             const int32_t* __restrict__ cptr,
             const int32_t* __restrict__ cl, const int32_t* __restrict__ cu,
             int bs) {
  const int t = blockIdx.x;
  slu_strip::strip_update<T>(pool, nullptr, nullptr, tslot[t], 0,
                             slu_strip::FIN_NONE, cl, cu, cptr[t],
                             cptr[t + 1], bs, blockIdx.y);
}

template <typename T>
int launch_schur(void* pool, const void* tslot, const void* cptr,
                 const void* cl, const void* cu, int count, int bs,
                 void* stream) {
  if (count == 0) return 0;
  const dim3 grid(count, bs / slu_strip::kStrip);
  schur_kernel<T><<<grid, bs, 0, (cudaStream_t)stream>>>(
      (T*)pool, (const int32_t*)tslot, (const int32_t*)cptr,
      (const int32_t*)cl, (const int32_t*)cu, bs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int slu_schur_f32(void* pool, const void* tslot, const void* cptr,
                             const void* cl, const void* cu, int count,
                             int bs, void* stream) {
  return launch_schur<float>(pool, tslot, cptr, cl, cu, count, bs, stream);
}

extern "C" int slu_schur_f64(void* pool, const void* tslot, const void* cptr,
                             const void* cl, const void* cu, int count,
                             int bs, void* stream) {
  return launch_schur<double>(pool, tslot, cptr, cl, cu, count, bs, stream);
}

extern "C" int slu_trsm_f32(void* pool, const void* dinv, const void* slots,
                            const void* steps, int count, int bs, int left,
                            void* stream) {
  return slu_panel::trsm<float>(pool, dinv, slots, steps, count, bs, left,
                                stream);
}

extern "C" int slu_trsm_f64(void* pool, const void* dinv, const void* slots,
                            const void* steps, int count, int bs, int left,
                            void* stream) {
  return slu_panel::trsm<double>(pool, dinv, slots, steps, count, bs, left,
                                 stream);
}
