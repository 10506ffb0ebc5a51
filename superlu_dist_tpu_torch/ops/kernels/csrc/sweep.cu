// sweep.cu: one level of a block triangular sweep.
//
// Replaces: superlu_dist_tpu/ops/kernels/pallas_exec.py::_sweep_kernel
// (called through make_sweep_call), the TPU's whole-sweep solve kernel,
// whose op 0 is X[dst] -= pool[slot] . X[src] and op 1 is
// X[row] = dinv[row] . X[row].
//
// What it computes, for each block row I of one level of the L (or U)
// sweep, with X of shape (nb, bs, nrhs):
//   acc = X[I] - sum over I's contributions (slot, src) of pool[slot] . X[src]
//   X[I] = dinv[I] . acc
// Every contribution into I and I's diagonal apply sit in I's level, and
// every source row is at a lower level, so one launch per level on one
// stream keeps the sweep's order (the TPU relies on its sequential grid).
//
// What bounds it on an H100: bytes. Each stored block is read once per
// sweep and used for 2*bs^2*nrhs operations, far below the card's
// operations-per-byte balance.
//
// Design: one CTA per (block row, tile of up to kRT right-hand sides);
// each CTA owns its row, so there are no atomics and the result is
// deterministic. The accumulator and the source tile live in shared
// memory (column major, so the lanes of a warp read consecutive words);
// each warp walks rows of the block with coalesced loads and reduces
// across its lanes with shuffles (rows.cuh, shared with solve_gemm.cu).
// The kernel is a template on the element type: the _f32 entry serves
// float32 factors, the _f64 entry float64 ones; IEEE arithmetic in that
// type.

#include "rows.cuh"

namespace {

using slu_rows::kRT;
using slu_rows::kThreads;
using slu_rows::load_tile;
using slu_rows::rows_times;

template <typename T>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const T* __restrict__ pool, const T* __restrict__ dinv,
             T* __restrict__ X, const int32_t* __restrict__ rows,
             const int32_t* __restrict__ rowptr,
             const int32_t* __restrict__ cslot,
             const int32_t* __restrict__ csrc, int bs, int nrhs) {
  T* acc = slu_rows::dyn_smem<T>();   // kRT x bs, column major
  T* xs = acc + kRT * bs;             // kRT x bs, column major
  const int64_t bb = (int64_t)bs * bs;
  const int I = rows[blockIdx.x];
  const int c0 = blockIdx.y * kRT;
  const int rt = min(kRT, nrhs - c0);
  T* XI = X + (int64_t)I * bs * nrhs + c0;

  load_tile(acc, XI, bs, rt, nrhs);
  const int p0 = rowptr[blockIdx.x], p1 = rowptr[blockIdx.x + 1];
  for (int p = p0; p < p1; ++p) {
    load_tile(xs, X + (int64_t)csrc[p] * bs * nrhs + c0, bs, rt, nrhs);
    __syncthreads();
    rows_times(pool + (int64_t)cslot[p] * bb, xs, bs, rt,
               [&](int r, const T* s) {
                 for (int c = 0; c < rt; ++c) acc[c * bs + r] -= s[c];
               });
    __syncthreads();
  }
  __syncthreads();
  rows_times(dinv + (int64_t)I * bb, acc, bs, rt,
             [&](int r, const T* s) {
               for (int c = 0; c < rt; ++c) XI[(int64_t)r * nrhs + c] = s[c];
             });
}

template <typename T>
int launch(const void* pool, const void* dinv, void* X, const void* rows,
           const void* rowptr, const void* cslot, const void* csrc, int count,
           int bs, int nrhs, void* stream) {
  if (count == 0) return 0;
  const dim3 grid(count, (nrhs + kRT - 1) / kRT);
  const size_t smem = (size_t)2 * kRT * bs * sizeof(T);
  sweep_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)pool, (const T*)dinv, (T*)X, (const int32_t*)rows,
      (const int32_t*)rowptr, (const int32_t*)cslot, (const int32_t*)csrc,
      bs, nrhs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int slu_sweep_f32(const void* pool, const void* dinv, void* X,
                             const void* rows, const void* rowptr,
                             const void* cslot, const void* csrc, int count,
                             int bs, int nrhs, void* stream) {
  return launch<float>(pool, dinv, X, rows, rowptr, cslot, csrc, count, bs,
                       nrhs, stream);
}

extern "C" int slu_sweep_f64(const void* pool, const void* dinv, void* X,
                             const void* rows, const void* rowptr,
                             const void* cslot, const void* csrc, int count,
                             int bs, int nrhs, void* stream) {
  return launch<double>(pool, dinv, X, rows, rowptr, cslot, csrc, count, bs,
                        nrhs, stream);
}
