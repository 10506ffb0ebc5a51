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
// nor operations (~2.8 MFLOP a tile). It is latency: the elimination is a
// chain of bs dependent steps, each a rank-1 update with a barrier.
//
// Design: one CTA per tile, running slu_tile::tile_lu (tile_lu.cuh, shared
// with rdma.cu): the tile and the inverse being built live in dynamic
// shared memory, so the bs steps touch device memory only to load the tile
// and store the three results. The kernel is a template on the element
// type; the float instantiation keeps the inverse in shared memory, the
// double one (tile and inverse would exceed the 227 KiB a block may have)
// builds each inverse in place in its output block of linv / uinv.

#include "tile_lu.cuh"

namespace {

using slu_tile::kTileThreads;

template <typename T, bool kInvSmem>
__global__ void __launch_bounds__(kTileThreads)
diag_lu_kernel(T* __restrict__ pool, T* __restrict__ linv,
               T* __restrict__ uinv, const int32_t* __restrict__ slots,
               const int32_t* __restrict__ steps, int bs, int lg, T thresh,
               int32_t* __restrict__ tiny) {
  slu_tile::tile_lu<T, kInvSmem>(pool, linv, uinv, slots, steps, bs, lg,
                                 thresh, tiny);
}

template <typename T, bool kInvSmem>
int launch(void* pool, void* linv, void* uinv, const void* slots,
           const void* steps, int count, int bs, T thresh, void* tiny,
           void* stream) {
  const int lg = slu_tile::log2_bs(bs);
  const size_t smem = slu_tile::tile_lu_smem_bytes<T, kInvSmem>(bs);
  cudaError_t err = cudaFuncSetAttribute(
      diag_lu_kernel<T, kInvSmem>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (count == 0) return 0;
  diag_lu_kernel<T, kInvSmem><<<count, kTileThreads, smem,
                                (cudaStream_t)stream>>>(
      (T*)pool, (T*)linv, (T*)uinv, (const int32_t*)slots,
      (const int32_t*)steps, bs, lg, thresh, (int32_t*)tiny);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int slu_diag_lu_f32(void* pool, void* linv, void* uinv,
                               const void* slots, const void* steps,
                               int count, int bs, float thresh, void* tiny,
                               void* stream) {
  return launch<float, true>(pool, linv, uinv, slots, steps, count, bs,
                             thresh, tiny, stream);
}

extern "C" int slu_diag_lu_f64(void* pool, void* linv, void* uinv,
                               const void* slots, const void* steps,
                               int count, int bs, double thresh, void* tiny,
                               void* stream) {
  return launch<double, false>(pool, linv, uinv, slots, steps, count, bs,
                               thresh, tiny, stream);
}
