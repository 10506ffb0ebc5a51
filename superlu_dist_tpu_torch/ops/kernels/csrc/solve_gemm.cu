// solve_gemm.cu: the two per-level phases of a level-set triangular sweep,
// each with a transpose flag.
//
// Replaces: superlu_dist_tpu/ops/kernels/pallas_exec.py
//   - _solve_gemm_kernel (make_solve_gemm_call), both flags, by
//     `solve_gemm`: X[dst] -= op(pool[slot]) . X[src] over the level's
//     (slot, src, dst) triples;
//   - _diag_apply_kernel (make_diag_apply_call), both flags, by
//     `diag_apply`: X[I] = op(dinv[I]) . X[I] over the level's rows;
// with op(M) = M^T when `transpose` is set. The transposed solve
// (A^T x = b) runs both per level with transpose = 1: a forward U^T sweep
// with uinv, then a backward L^T sweep with linv.
//
// The TPU kernel reads, updates and writes back out_ref[dst] once per lane
// of a DMA window, so the host's window_schedule keeps two lanes of a
// window off one destination (pallas_exec.py:254-296). Here the level's
// triples form a CSR by destination: one CTA per (destination block row,
// tile of up to kRT right-hand sides) subtracts that row's products in
// tape order from an accumulator in shared memory and writes the row once.
// There are no atomics and the result is deterministic. Every source row
// and every destination's diagonal inverse belong to lower levels or to
// the level itself, so one launch per phase per level on one stream keeps
// the sweep's order (the TPU relies on its sequential grid).
//
// What bounds them on an H100: bytes. Each stored block is read once per
// sweep and used for 2*bs^2*nrhs operations, far below the card's
// operations-per-byte balance.
//
// Design: the product by M (transpose = 0) is a warp per row of M with a
// shuffle reduction (rows.cuh::rows_times, as in sweep.cu); the product
// by M^T (transpose = 1) gives each thread one output row i and a share
// of the k, so the threads of a warp read consecutive words of row k of M
// and no transpose in shared memory is needed; the shares meet in shared
// memory in a fixed order (rows.cuh::cols_times). diag_apply stages
// X[I] in shared memory first, since its product reads all of X[I] before
// any of it is written. Both kernels are templates on the element type
// (the _f32 entries serve float32 factors, the _f64 entries float64 ones);
// IEEE arithmetic in that type.

#include "rows.cuh"

namespace {

using slu_rows::cols_times;
using slu_rows::kRT;
using slu_rows::kThreads;
using slu_rows::load_tile;
using slu_rows::rows_times;

template <typename T, bool kTrans>
__global__ void __launch_bounds__(kThreads)
solve_gemm_kernel(const T* __restrict__ pool, T* __restrict__ X,
                  const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ rowptr,
                  const int32_t* __restrict__ cslot,
                  const int32_t* __restrict__ csrc, int bs, int nrhs) {
  const int p0 = rowptr[blockIdx.x], p1 = rowptr[blockIdx.x + 1];
  if (p0 == p1) return;          // a row of the level without contributions
  T* acc = slu_rows::dyn_smem<T>();   // kRT x bs, column major
  T* xs = acc + kRT * bs;             // kRT x bs, column major
  T* red = xs + kRT * bs;             // kRT x blockDim, cols_times' partials
  const int64_t bb = (int64_t)bs * bs;
  const int c0 = blockIdx.y * kRT;
  const int rt = min(kRT, nrhs - c0);
  T* XI = X + (int64_t)rows[blockIdx.x] * bs * nrhs + c0;

  load_tile(acc, XI, bs, rt, nrhs);
  for (int p = p0; p < p1; ++p) {
    load_tile(xs, X + (int64_t)csrc[p] * bs * nrhs + c0, bs, rt, nrhs);
    __syncthreads();
    const T* P = pool + (int64_t)cslot[p] * bb;
    if (kTrans) {
      cols_times(P, xs, bs, rt, red,
                 [&](int i, int c, T v) { acc[c * bs + i] -= v; });
    } else {
      rows_times(P, xs, bs, rt, [&](int r, const T* s) {
        for (int c = 0; c < rt; ++c) acc[c * bs + r] -= s[c];
      });
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < bs * rt; e += blockDim.x) {
    const int r = e / rt, c = e - r * rt;
    XI[(int64_t)r * nrhs + c] = acc[c * bs + r];
  }
}

template <typename T, bool kTrans>
__global__ void __launch_bounds__(kThreads)
diag_apply_kernel(const T* __restrict__ dinv, T* __restrict__ X,
                  const int32_t* __restrict__ rows, int bs, int nrhs) {
  T* xs = slu_rows::dyn_smem<T>();    // kRT x bs, column major
  T* red = xs + kRT * bs;             // kRT x blockDim, cols_times' partials
  const int I = rows[blockIdx.x];
  const int c0 = blockIdx.y * kRT;
  const int rt = min(kRT, nrhs - c0);
  T* XI = X + (int64_t)I * bs * nrhs + c0;
  const T* D = dinv + (int64_t)I * bs * bs;

  load_tile(xs, XI, bs, rt, nrhs);
  __syncthreads();
  if (kTrans) {
    cols_times(D, xs, bs, rt, red, [&](int i, int c, T v) {
      XI[(int64_t)i * nrhs + c] = v;
    });
  } else {
    rows_times(D, xs, bs, rt, [&](int r, const T* s) {
      for (int c = 0; c < rt; ++c) XI[(int64_t)r * nrhs + c] = s[c];
    });
  }
}

template <typename T>
int launch_solve_gemm(const void* pool, void* X, const void* rows,
                      const void* rowptr, const void* cslot,
                      const void* csrc, int count, int bs, int nrhs,
                      int transpose, void* stream) {
  if (count == 0) return 0;
  const dim3 grid(count, (nrhs + kRT - 1) / kRT);
  const size_t smem = (size_t)kRT * (2 * bs + kThreads) * sizeof(T);
  const auto s = (cudaStream_t)stream;
  const auto* P = (const T*)pool;
  const auto* R = (const int32_t*)rows;
  const auto* RP = (const int32_t*)rowptr;
  const auto* CS = (const int32_t*)cslot;
  const auto* SR = (const int32_t*)csrc;
  if (transpose)
    solve_gemm_kernel<T, true><<<grid, kThreads, smem, s>>>(
        P, (T*)X, R, RP, CS, SR, bs, nrhs);
  else
    solve_gemm_kernel<T, false><<<grid, kThreads, smem, s>>>(
        P, (T*)X, R, RP, CS, SR, bs, nrhs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_diag_apply(const void* dinv, void* X, const void* rows, int count,
                      int bs, int nrhs, int transpose, void* stream) {
  if (count == 0) return 0;
  const dim3 grid(count, (nrhs + kRT - 1) / kRT);
  const size_t smem = (size_t)kRT * (bs + kThreads) * sizeof(T);
  const auto s = (cudaStream_t)stream;
  if (transpose)
    diag_apply_kernel<T, true><<<grid, kThreads, smem, s>>>(
        (const T*)dinv, (T*)X, (const int32_t*)rows, bs, nrhs);
  else
    diag_apply_kernel<T, false><<<grid, kThreads, smem, s>>>(
        (const T*)dinv, (T*)X, (const int32_t*)rows, bs, nrhs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int slu_solve_gemm_f32(const void* pool, void* X, const void* rows,
                                  const void* rowptr, const void* cslot,
                                  const void* csrc, int count, int bs,
                                  int nrhs, int transpose, void* stream) {
  return launch_solve_gemm<float>(pool, X, rows, rowptr, cslot, csrc, count,
                                  bs, nrhs, transpose, stream);
}

extern "C" int slu_solve_gemm_f64(const void* pool, void* X, const void* rows,
                                  const void* rowptr, const void* cslot,
                                  const void* csrc, int count, int bs,
                                  int nrhs, int transpose, void* stream) {
  return launch_solve_gemm<double>(pool, X, rows, rowptr, cslot, csrc, count,
                                   bs, nrhs, transpose, stream);
}

extern "C" int slu_diag_apply_f32(const void* dinv, void* X, const void* rows,
                                  int count, int bs, int nrhs, int transpose,
                                  void* stream) {
  return launch_diag_apply<float>(dinv, X, rows, count, bs, nrhs, transpose,
                                  stream);
}

extern "C" int slu_diag_apply_f64(const void* dinv, void* X, const void* rows,
                                  int count, int bs, int nrhs, int transpose,
                                  void* stream) {
  return launch_diag_apply<double>(dinv, X, rows, count, bs, nrhs, transpose,
                                   stream);
}
