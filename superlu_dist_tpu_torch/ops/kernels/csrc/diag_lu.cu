// diag_lu.cu: no-pivot LU with triangular inverses of a batch of
// diagonal tiles of the block pool.
//
// Replaces: superlu_dist_tpu/ops/kernels/flk.py::_lu_tile_blocked (with
// _lu_tile_inkernel), the device function that clk, tck and flk run on
// each diagonal block on the TPU.
//
// What it computes, per tile T = pool[slots[b]] (bs x bs, row major):
//   Doolittle LU without pivoting; a pivot with |p| < thresh becomes
//   sign(p)*thresh (+thresh at p == 0) and is counted (ReplaceTinyPivot,
//   reference pdgstrf2.c). The compact LU goes back into the tile,
//   L^{-1} into linv[steps[b]] and U^{-1} into uinv[steps[b]], and the
//   count of replaced pivots is added to *tiny.
//
// What bounds it on an H100: neither bytes (4 tiles of 64 KiB at bs=128)
// nor operations (~2.8 MFLOP a tile). It is latency on one SM: a launch of
// 1 tile takes as long as one of 130.
//
// Design: one CTA per tile, running slu_tile::tile_lu (tile_lu.cuh, shared
// with rdma.cu), as the TPU's _lu_tile_blocked: the forward LU in panels
// of 32 columns (one warp factors each 32x32 diagonal subtile with
// shuffles, two warps form its inverses and keep them, all 16 warps form
// the panel's L and U blocks and the trailing update from register
// tiles), then L^{-1} and U^{-1} by block substitution, two warps per
// 32x32 block, the blocks at one distance from the diagonal at once, each
// block's sum solved with its diagonal block by substitution. Barriers a tile: 16 at bs=128, 6 at 64, 2 at 32 (the
// earlier form's paired sweeps had 143, 71, 35; the element-by-element
// form 640 at 128). The tile, the staged subtile and the panels' inverses live in
// dynamic shared memory (100 KiB in float, 200 KiB in double at bs=128);
// the inverses are built in linv and uinv. The kernel is a template on the
// element type: the _f32, _f64, _c64 and _c128 entries launch float,
// double, complex64 and complex128 (cplx.cuh; a complex tiny pivot keeps
// its phase, and complex128 at bs=128 keeps the tile in the pool, as
// tile_lu.cuh says).
//
// The _batch entries factor the same tiles of every member of a stacked
// pool (members x pool_stride elements, linv and uinv members x
// inv_stride): the member is blockIdx.z and only moves the pointers (the
// pool's, the inverses', which hold each block's sum on its way, its
// threshold and its tiny counter), so each member computes bit
// for bit what the unbatched entry computes on it alone. One launch takes
// at most kMaxMembers members (gridDim.z); the caller launches larger
// batches in chunks of members.

#include "tile_lu.cuh"

namespace {

using slu_tile::kTileThreads;

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
diag_lu_kernel(T* __restrict__ pool, T* __restrict__ linv,
               T* __restrict__ uinv, const int32_t* __restrict__ slots,
               const int32_t* __restrict__ steps, int bs,
               slu_tile::real_t<T> thresh, int32_t* __restrict__ tiny) {
  slu_tile::tile_lu<T>(pool, linv, uinv, slots, steps, bs, thresh, tiny);
}

template <typename T>
int launch(void* pool, void* linv, void* uinv, const void* slots,
           const void* steps, int count, int bs, slu_tile::real_t<T> thresh,
           void* tiny, void* stream) {
  const size_t smem = slu_tile::tile_lu_smem_bytes<T>(bs);
  cudaError_t err = cudaFuncSetAttribute(
      diag_lu_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (count == 0) return 0;
  diag_lu_kernel<T><<<count, kTileThreads, smem, (cudaStream_t)stream>>>(
      (T*)pool, (T*)linv, (T*)uinv, (const int32_t*)slots,
      (const int32_t*)steps, bs, thresh, (int32_t*)tiny);
  return (int)cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
diag_lu_batch_kernel(T* __restrict__ pool, T* __restrict__ linv,
                     T* __restrict__ uinv, const int32_t* __restrict__ slots,
                     const int32_t* __restrict__ steps, int bs,
                     const slu_tile::real_t<T>* __restrict__ thresh,
                     int32_t* __restrict__ tiny, int64_t pool_stride,
                     int64_t inv_stride) {
  const int64_t m = blockIdx.z;
  slu_tile::tile_lu<T>(pool + m * pool_stride, linv + m * inv_stride,
                       uinv + m * inv_stride, slots, steps, bs, thresh[m],
                       tiny + m);
}

constexpr int kMaxMembers = 65535;

template <typename T>
int launch_batch(void* pool, void* linv, void* uinv, const void* slots,
                 const void* steps, int count, int bs, const void* thresh,
                 void* tiny, int members, long long pool_stride,
                 long long inv_stride, void* stream) {
  if (members < 0 || members > kMaxMembers)
    return (int)cudaErrorInvalidValue;
  const size_t smem = slu_tile::tile_lu_smem_bytes<T>(bs);
  cudaError_t err = cudaFuncSetAttribute(
      diag_lu_batch_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (count == 0 || members == 0) return 0;
  diag_lu_batch_kernel<T>
      <<<dim3(count, 1, members), kTileThreads, smem, (cudaStream_t)stream>>>(
          (T*)pool, (T*)linv, (T*)uinv, (const int32_t*)slots,
          (const int32_t*)steps, bs, (const slu_tile::real_t<T>*)thresh,
          (int32_t*)tiny, pool_stride, inv_stride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int slu_diag_lu_f32(void* pool, void* linv, void* uinv,
                               const void* slots, const void* steps,
                               int count, int bs, float thresh, void* tiny,
                               void* stream) {
  return launch<float>(pool, linv, uinv, slots, steps, count, bs, thresh,
                       tiny, stream);
}

extern "C" int slu_diag_lu_f64(void* pool, void* linv, void* uinv,
                               const void* slots, const void* steps,
                               int count, int bs, double thresh, void* tiny,
                               void* stream) {
  return launch<double>(pool, linv, uinv, slots, steps, count, bs, thresh,
                        tiny, stream);
}

extern "C" int slu_diag_lu_c64(void* pool, void* linv, void* uinv,
                               const void* slots, const void* steps,
                               int count, int bs, float thresh, void* tiny,
                               void* stream) {
  return launch<slu_tile::cplx<float>>(pool, linv, uinv, slots, steps, count,
                                       bs, thresh, tiny, stream);
}

extern "C" int slu_diag_lu_c128(void* pool, void* linv, void* uinv,
                                const void* slots, const void* steps,
                                int count, int bs, double thresh, void* tiny,
                                void* stream) {
  return launch<slu_tile::cplx<double>>(pool, linv, uinv, slots, steps,
                                        count, bs, thresh, tiny, stream);
}

// The stacked form: `thresh` is a device array of `members` thresholds (the
// element's real type), `tiny` of `members` int32 counters.
#define SLU_DIAG_LU_BATCH(SFX, T)                                           \
  extern "C" int slu_diag_lu_batch_##SFX(                                   \
      void* pool, void* linv, void* uinv, const void* slots,                \
      const void* steps, int count, int bs, const void* thresh, void* tiny, \
      int members, long long pool_stride, long long inv_stride,             \
      void* stream) {                                                       \
    return launch_batch<T>(pool, linv, uinv, slots, steps, count, bs,       \
                           thresh, tiny, members, pool_stride, inv_stride,  \
                           stream);                                         \
  }

SLU_DIAG_LU_BATCH(f32, float)
SLU_DIAG_LU_BATCH(f64, double)
SLU_DIAG_LU_BATCH(c64, slu_tile::cplx<float>)
SLU_DIAG_LU_BATCH(c128, slu_tile::cplx<double>)
