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
// one band of one target and sums its products in the plan's order, with
// no atomics, so a target shared by many steps of the level cannot lose a
// contribution and a factor repeats bit for bit. A level's targets belong
// to ancestor steps, so no target is an L or U source of the same level.
//
// What bounds them on an H100: operations, 2*bs^3 per block product or
// panel (FP32 on the CUDA cores, 67 TFLOP/s peak; FP64, which float64
// factors run, 67 TFLOP/s on the tensor cores, of which these kernels
// reach at most the CUDA cores' 34).
//
// Design: `schur` is chain.cuh's Schur band (schur_band, shared with
// rdma.cu's rdma_schur): one CTA per (target, band of whole columns), both
// operands of each product streamed through one cp.async ring that runs
// across product boundaries, the band in registers, loaded and stored
// once, in chain.cuh's geometry (by_geometry; `wide` forces it). A level's
// chains are short (at most 17 products on lap3d32, 27 on lap3d50), so
// they are not cut into chunks. `trsm` is panel.cuh's band-times-inverse
// kernel (shared with clk.cu's clk_trsm): one CTA per (panel, band of
// whole rows or columns), the band and the inverse staged in shared
// memory by cp.async. Both are templates on the element type; the _f32,
// _f64, _c64 and _c128 entries launch the float, double, complex64 and
// complex128 instantiations (cplx.cuh; complex128 in its own geometry,
// chain.cuh and panel.cuh say why). A complex product is 8 real flops a
// multiply-add, four times a real one.
//
// The _batch entries run one level over every member of a stacked pool
// (member m's pool starts m * pool_stride elements in, its inverses m *
// inv_stride), with one set of lists for all members: the member is
// blockIdx.z (at most 65,535 a launch) and only moves the pointers, and
// the geometry is chosen from one member's count, so each member computes
// bit for bit what the unbatched entry computes on it alone.

#include "chain.cuh"

namespace {

template <class G, typename T>
__global__ void __launch_bounds__(G::NT)
schur_kernel(T* pool, const int32_t* __restrict__ tslot,
             const int32_t* __restrict__ cptr,
             const int32_t* __restrict__ cl,
             const int32_t* __restrict__ cu) {
  const int t = blockIdx.x;
  slu_chain::schur_band<G>(pool + tslot[t] * ((int64_t)G::BS * G::BS), pool,
                           pool, cl, cu, cptr[t], cptr[t + 1]);
}

// The Schur update of `count` targets (the level's slice of tslot and
// cptr; cl, cu whole). `wide` < 0 chooses the band geometry by chain.cuh's
// rule, 0 / 1 force bands of 16 / 64. Returns the cudaError_t of the
// launch.
template <typename T>
int launch_schur(void* pool, const void* tslot, const void* cptr,
                 const void* cl, const void* cu, int count, int bs, int wide,
                 void* stream) {
  if (count == 0) return 0;
  return slu_chain::by_geometry<T, false>(bs, count, wide, [&](auto geo) {
    using G = decltype(geo);
    return slu_chain::launch<G>(
        schur_kernel<G, T>, count, (cudaStream_t)stream, (T*)pool,
        (const int32_t*)tslot, (const int32_t*)cptr, (const int32_t*)cl,
        (const int32_t*)cu);
  });
}

template <class G, typename T>
__global__ void __launch_bounds__(G::NT)
schur_batch_kernel(T* pool, int64_t pool_stride,
                   const int32_t* __restrict__ tslot,
                   const int32_t* __restrict__ cptr,
                   const int32_t* __restrict__ cl,
                   const int32_t* __restrict__ cu) {
  const int t = blockIdx.x;
  T* mp = pool + (int64_t)blockIdx.z * pool_stride;
  slu_chain::schur_band<G>(mp + tslot[t] * ((int64_t)G::BS * G::BS), mp, mp,
                           cl, cu, cptr[t], cptr[t + 1]);
}

template <typename T>
int launch_schur_batch(void* pool, const void* tslot, const void* cptr,
                       const void* cl, const void* cu, int count, int bs,
                       int members, long long pool_stride, void* stream) {
  if (members < 0 || members > 65535) return (int)cudaErrorInvalidValue;
  if (count == 0 || members == 0) return 0;
  // the bands slu_schur_* choose when not forced (wide < 0), so that each
  // member computes what the unbatched entry computes on it alone
  return slu_chain::by_geometry<T, false>(bs, count, -1, [&](auto geo) {
    using G = decltype(geo);
    const auto kernel = schur_batch_kernel<G, T>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kBytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3((unsigned)count, G::BANDS, (unsigned)members), G::NT,
             G::kBytes, (cudaStream_t)stream>>>(
        (T*)pool, (int64_t)pool_stride, (const int32_t*)tslot,
        (const int32_t*)cptr, (const int32_t*)cl, (const int32_t*)cu);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" int slu_schur_f32(void* pool, const void* tslot, const void* cptr,
                             const void* cl, const void* cu, int count,
                             int bs, int wide, void* stream) {
  return launch_schur<float>(pool, tslot, cptr, cl, cu, count, bs, wide,
                             stream);
}

extern "C" int slu_schur_f64(void* pool, const void* tslot, const void* cptr,
                             const void* cl, const void* cu, int count,
                             int bs, int wide, void* stream) {
  return launch_schur<double>(pool, tslot, cptr, cl, cu, count, bs, wide,
                              stream);
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

extern "C" int slu_schur_c64(void* pool, const void* tslot, const void* cptr,
                             const void* cl, const void* cu, int count,
                             int bs, int wide, void* stream) {
  return launch_schur<slu_cplx::cplx<float>>(pool, tslot, cptr, cl, cu,
                                             count, bs, wide, stream);
}

extern "C" int slu_schur_c128(void* pool, const void* tslot,
                              const void* cptr, const void* cl,
                              const void* cu, int count, int bs, int wide,
                              void* stream) {
  return launch_schur<slu_cplx::cplx<double>>(pool, tslot, cptr, cl, cu,
                                              count, bs, wide, stream);
}

extern "C" int slu_trsm_c64(void* pool, const void* dinv, const void* slots,
                            const void* steps, int count, int bs, int left,
                            void* stream) {
  return slu_panel::trsm<slu_cplx::cplx<float>>(pool, dinv, slots, steps,
                                                count, bs, left, stream);
}

extern "C" int slu_trsm_c128(void* pool, const void* dinv, const void* slots,
                             const void* steps, int count, int bs, int left,
                             void* stream) {
  return slu_panel::trsm<slu_cplx::cplx<double>>(pool, dinv, slots, steps,
                                                 count, bs, left, stream);
}

#define SLU_SCHUR_BATCH(SFX, T)                                               \
  extern "C" int slu_schur_batch_##SFX(                                       \
      void* pool, const void* tslot, const void* cptr, const void* cl,        \
      const void* cu, int count, int bs, int members, long long pool_stride,  \
      void* stream) {                                                         \
    return launch_schur_batch<T>(pool, tslot, cptr, cl, cu, count, bs,        \
                                 members, pool_stride, stream);               \
  }                                                                           \
  extern "C" int slu_trsm_batch_##SFX(                                        \
      void* pool, const void* dinv, const void* slots, const void* steps,     \
      int count, int bs, int left, int members, long long pool_stride,        \
      long long inv_stride, void* stream) {                                   \
    if (members == 0) return 0;                                               \
    return slu_panel::trsm<T>(                                                \
        pool, dinv, slots, steps, count, bs, left, stream,                    \
        slu_panel::Members{members, (int64_t)pool_stride,                     \
                           (int64_t)inv_stride});                             \
  }

SLU_SCHUR_BATCH(f32, float)
SLU_SCHUR_BATCH(f64, double)
SLU_SCHUR_BATCH(c64, slu_cplx::cplx<float>)
SLU_SCHUR_BATCH(c128, slu_cplx::cplx<double>)
