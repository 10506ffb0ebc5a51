// solve_gemm.cu: one level of a level-set triangular sweep in two passes,
// each with a transpose flag.
//
// Replaces: superlu_dist_tpu/ops/kernels/pallas_exec.py
//   - _solve_gemm_kernel (make_solve_gemm_call), both flags: the level's
//     products X[dst] -= op(pool[slot]) . X[src] over its (slot, src, dst)
//     triples, by pass 1 (`solve_gemm` entries) and pass 2's sum;
//   - _diag_apply_kernel (make_diag_apply_call), both flags:
//     X[I] = op(dinv[I]) . X[I] over the level's rows, by pass 2
//     (`solve_rows` entries, with the diagonal);
// with op(M) = M^T when `transpose` is set. The transposed solve
// (A^T x = b) runs both passes per level with transpose = 1: a forward U^T
// sweep with uinv, then a backward L^T sweep with linv.
//
// What bounds them on an H100: bytes. Each stored block is read once per
// sweep and used for 2*bs^2*nrhs operations, far below the card's
// operations-per-byte balance. So the design is about keeping enough
// blocks in flight: the top levels of a sweep hold one or two destination
// rows whose chains run to 80-100 products, and one CTA walking such a
// chain leaves the rest of the card idle.
//
// Design. The host cuts each destination's chain into chunks of at most c
// products in tape order (sweep.py::chunk_chains, c chosen per level so
// that a level with enough products fills the card with two CTAs per SM).
//   Pass 1: one CTA per (chunk, tile of right-hand sides) sums
//     S = sum over its chunk, in tape order, of op(pool[slot]) . X[src]
//     into the scratch P[chunk] (bs x nrhs, the layout of a row of X).
//     The block streams through registers in 16-byte loads (float4 or
//     double2), eight in flight per thread, with the 256 threads of a CTA
//     on consecutive 16-byte words (for M^T each thread owns one 16-byte
//     column strip of the output and walks rows k; for M each thread owns
//     one output row and walks 16-byte strips of it). The partial sums of
//     the threads that share an output meet once per chunk, in shared
//     memory, in a fixed order.
//   Pass 2: one CTA per (destination row of the level, tile) computes
//     Y = X[I] - sum of the row's P[chunk] in chunk order and, with the
//     diagonal, X[I] = op(dinv[I]) . Y by the same product from Y staged
//     in shared memory: one read and one write of X[I] per level. Without
//     the diagonal it writes X[I] = Y (the standalone solve_gemm); without
//     partials it is the standalone diag_apply.
// No atomics: a fixed chunking and fixed summation orders give bit-equal
// results from run to run. Every source row and every destination's
// diagonal inverse belong to lower levels or to the level itself, so the
// two launches per level on one stream keep the sweep's order (the TPU
// relies on its sequential grid). Per-thread accumulators are sized for
// one right-hand side and for tiles of kRT = 8 (template RT; 4 for
// complex, rows.cuh's kRTof says why). Templates on the element type
// (float, double, complex64, complex128: IEEE arithmetic in the real
// type, cplx.cuh), the block size (32, 64, 128), the transpose flag, RT
// and (pass 2) the diagonal. The flag means op(M) = M^T for complex too,
// not the conjugate transpose: the driver solves A^H x = b as
// conj(x) = A^{-T} conj(b).
//
// The _batch entries run one level's pass over every member of a stacked
// batch with one set of tapes: member m's pool, diagonal inverses, X and
// scratch P start m times their stride in (int64 element offsets). The
// member is blockIdx.z (at most 65,535 a launch) and only moves the
// pointers, so each member computes bit for bit what the unbatched entry
// computes on it alone.

#include "rows.cuh"

namespace {

using slu_rows::kThreads;
using slu_rows::Map;

// ---- pass 1: a chunk's products into its partial sum ---------------------
template <typename T, int BS, bool kTrans, int RT>
__device__ __forceinline__ void chunk_body(const T* __restrict__ pool,
                                           const T* __restrict__ X,
                                           T* __restrict__ P,
                                           const int32_t* __restrict__ cptr,
                                           const int32_t* __restrict__ cslot,
                                           const int32_t* __restrict__ csrc,
                                           int nrhs) {
  const int q = blockIdx.x;
  const int c0 = blockIdx.y * RT;
  T* Pq = P + (int64_t)q * BS * nrhs + c0;
  slu_rows::chunk_sum<T, BS, kTrans, RT>(
      pool, X, cptr[q], cptr[q + 1], cslot, csrc, c0, nrhs,
      [&](int i, int c, T v) { Pq[i * nrhs + c] = v; });
}

template <typename T, int BS, bool kTrans, int RT>
__global__ void __launch_bounds__(kThreads, 2)
chunk_kernel(const T* __restrict__ pool, const T* __restrict__ X,
             T* __restrict__ P, const int32_t* __restrict__ cptr,
             const int32_t* __restrict__ cslot,
             const int32_t* __restrict__ csrc, int nrhs) {
  chunk_body<T, BS, kTrans, RT>(pool, X, P, cptr, cslot, csrc, nrhs);
}

template <typename T, int BS, bool kTrans, int RT>
__global__ void __launch_bounds__(kThreads, 2)
chunk_batch_kernel(const T* __restrict__ pool, const T* __restrict__ X,
                   T* __restrict__ P, const int32_t* __restrict__ cptr,
                   const int32_t* __restrict__ cslot,
                   const int32_t* __restrict__ csrc, int nrhs, int64_t ps,
                   int64_t xs, int64_t qs) {
  const int64_t m = blockIdx.z;
  chunk_body<T, BS, kTrans, RT>(pool + m * ps, X + m * xs, P + m * qs, cptr,
                                cslot, csrc, nrhs);
}

// ---- pass 2: a row's partials, then its diagonal --------------------------
template <typename T, int BS, bool kTrans, int RT, bool kDiag>
__device__ __forceinline__ void rows_body(const T* __restrict__ dinv,
                                          T* __restrict__ X,
                                          const T* __restrict__ P,
                                          const int32_t* __restrict__ rows,
                                          const int32_t* __restrict__ chunkptr,
                                          int q0, int nrhs) {
  using M = Map<T, BS, kTrans>;
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * RT;
  const int rt = min(RT, nrhs - c0);
  const int ne = BS * rt;
  const int64_t I = rows[b];
  T* XI = X + I * BS * nrhs + c0;
  T* ys = slu_rows::dyn_smem<T>();     // BS x RT, ys[k * RT + c]
  T* red = ys + BS * RT;               // slices, then the product's sums
  const int nq = chunkptr ? chunkptr[b + 1] - chunkptr[b] : 0;
  const int64_t ps = (int64_t)BS * nrhs;
  const T* Pb = nq ? P + (chunkptr[b] - q0) * ps + c0 : nullptr;
  // when a row's elements leave threads idle, ns slices of the chunk list
  // are summed side by side (each in chunk order) and then in slice order
  const int ns = min(nq, 2 * ne <= kThreads ? kThreads / ne : 1);
  if (ns > 1) {
    const int s = threadIdx.x / ne, e = threadIdx.x - s * ne;
    if (s < ns) {
      const int i = e / rt, c = e - i * rt;
      const T* p = Pb + i * nrhs + c;
      T part = T(0);
#pragma unroll 4
      for (int q = s * nq / ns; q < (s + 1) * nq / ns; ++q) part += p[q * ps];
      red[s * ne + e] = part;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < ne; e += kThreads) {
    const int i = e / rt, c = e - i * rt;
    const int o = i * nrhs + c;
    T y = XI[o];
    if (ns > 1) {
      for (int s = 0; s < ns; ++s) y -= red[s * ne + e];
    } else {
#pragma unroll 4
      for (int q = 0; q < nq; ++q) y -= Pb[q * ps + o];
    }
    if constexpr (kDiag)
      ys[i * RT + c] = y;
    else
      XI[o] = y;
  }
  if constexpr (kDiag) {
    __syncthreads();
    T acc[M::kOut][RT] = {};
    M::template accumulate<RT>(
        dinv + I * BS * BS, rt, [&](int k, int c) { return ys[k * RT + c]; },
        acc);
    M::template reduce<RT>(acc, rt, red, [&](int i, int c, T v) {
      XI[i * nrhs + c] = v;
    });
  }
}

template <typename T, int BS, bool kTrans, int RT, bool kDiag>
__global__ void __launch_bounds__(kThreads, 2)
rows_kernel(const T* __restrict__ dinv, T* __restrict__ X,
            const T* __restrict__ P, const int32_t* __restrict__ rows,
            const int32_t* __restrict__ chunkptr, int q0, int nrhs) {
  rows_body<T, BS, kTrans, RT, kDiag>(dinv, X, P, rows, chunkptr, q0, nrhs);
}

template <typename T, int BS, bool kTrans, int RT, bool kDiag>
__global__ void __launch_bounds__(kThreads, 2)
rows_batch_kernel(const T* __restrict__ dinv, T* __restrict__ X,
                  const T* __restrict__ P, const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ chunkptr, int q0, int nrhs,
                  int64_t is, int64_t xs, int64_t qs) {
  const int64_t m = blockIdx.z;
  rows_body<T, BS, kTrans, RT, kDiag>(dinv ? dinv + m * is : nullptr,
                                      X + m * xs, P ? P + m * qs : nullptr,
                                      rows, chunkptr, q0, nrhs);
}

// ---- launches ------------------------------------------------------------
struct ChunkArgs {
  const void* pool;
  const void* X;
  void* P;
  const int32_t* cptr;
  const int32_t* cslot;
  const int32_t* csrc;
  int count, nrhs;
  cudaStream_t stream;
  // a batched launch: members > 0 (gridDim.z) and the members' strides
  // of pool, X and P
  int members;
  int64_t ps, xs, qs;
};

struct RowArgs {
  const void* dinv;
  void* X;
  const void* P;
  const int32_t* rows;
  const int32_t* chunkptr;
  int q0, count, nrhs, diag;
  cudaStream_t stream;
  // a batched launch: members > 0 (gridDim.z) and the members' strides
  // of dinv, X and P
  int members;
  int64_t is, xs, qs;
};

template <typename T, int BS, bool kTrans, int RT>
struct ChunkLaunch {
  static void go(const ChunkArgs& a) {
    using M = Map<T, BS, kTrans>;
    constexpr size_t smem = M::template red_elems<RT>() * sizeof(T);
    static_assert(smem <= 48 * 1024, "shared memory");
    if (a.members == 0) {
      const dim3 grid(a.count, (a.nrhs + RT - 1) / RT);
      chunk_kernel<T, BS, kTrans, RT><<<grid, kThreads, smem, a.stream>>>(
          (const T*)a.pool, (const T*)a.X, (T*)a.P, a.cptr, a.cslot, a.csrc,
          a.nrhs);
    } else {
      const dim3 grid(a.count, (a.nrhs + RT - 1) / RT, a.members);
      chunk_batch_kernel<T, BS, kTrans, RT>
          <<<grid, kThreads, smem, a.stream>>>(
              (const T*)a.pool, (const T*)a.X, (T*)a.P, a.cptr, a.cslot,
              a.csrc, a.nrhs, a.ps, a.xs, a.qs);
    }
  }
};

template <typename T, int BS, bool kTrans, int RT>
struct RowLaunch {
  static void go(const RowArgs& a) {
    using M = Map<T, BS, kTrans>;
    constexpr size_t smem =
        (BS * RT + M::template red_elems<RT>()) * sizeof(T);
    static_assert(smem <= 48 * 1024, "shared memory");
    if (a.members == 0) {
      const dim3 grid(a.count, (a.nrhs + RT - 1) / RT);
      if (a.diag)
        rows_kernel<T, BS, kTrans, RT, true>
            <<<grid, kThreads, smem, a.stream>>>(
                (const T*)a.dinv, (T*)a.X, (const T*)a.P, a.rows, a.chunkptr,
                a.q0, a.nrhs);
      else
        rows_kernel<T, BS, kTrans, RT, false>
            <<<grid, kThreads, smem, a.stream>>>(
                (const T*)a.dinv, (T*)a.X, (const T*)a.P, a.rows, a.chunkptr,
                a.q0, a.nrhs);
    } else {
      const dim3 grid(a.count, (a.nrhs + RT - 1) / RT, a.members);
      if (a.diag)
        rows_batch_kernel<T, BS, kTrans, RT, true>
            <<<grid, kThreads, smem, a.stream>>>(
                (const T*)a.dinv, (T*)a.X, (const T*)a.P, a.rows, a.chunkptr,
                a.q0, a.nrhs, a.is, a.xs, a.qs);
      else
        rows_batch_kernel<T, BS, kTrans, RT, false>
            <<<grid, kThreads, smem, a.stream>>>(
                (const T*)a.dinv, (T*)a.X, (const T*)a.P, a.rows, a.chunkptr,
                a.q0, a.nrhs, a.is, a.xs, a.qs);
    }
  }
};

template <template <typename, int, bool, int> class L, typename T, int BS,
          bool kTrans, typename A>
void by_rt(const A& a) {
  if (a.nrhs == 1)
    L<T, BS, kTrans, 1>::go(a);
  else
    L<T, BS, kTrans, slu_rows::kRTof<T>>::go(a);
}

template <template <typename, int, bool, int> class L, typename T, int BS,
          typename A>
void by_trans(const A& a, int transpose) {
  if (transpose)
    by_rt<L, T, BS, true>(a);
  else
    by_rt<L, T, BS, false>(a);
}

// launch L<T, bs, transpose, RT> for a block size of CUDA_BLOCK_SIZES;
// returns the launch's cudaError_t
template <template <typename, int, bool, int> class L, typename T, typename A>
int dispatch(const A& a, int bs, int transpose) {
  if (a.count == 0) return 0;
  switch (bs) {
    case 32: by_trans<L, T, 32>(a, transpose); break;
    case 64: by_trans<L, T, 64>(a, transpose); break;
    case 128: by_trans<L, T, 128>(a, transpose); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int solve_gemm(const void* pool, const void* X, void* P, const void* cptr,
               const void* cslot, const void* csrc, int count, int bs,
               int nrhs, int transpose, void* stream) {
  const ChunkArgs a{pool, X, P, (const int32_t*)cptr, (const int32_t*)cslot,
                    (const int32_t*)csrc, count, nrhs, (cudaStream_t)stream,
                    0, 0, 0, 0};
  return dispatch<ChunkLaunch, T>(a, bs, transpose);
}

template <typename T>
int solve_gemm_batch(const void* pool, const void* X, void* P,
                     const void* cptr, const void* cslot, const void* csrc,
                     int count, int bs, int nrhs, int transpose, int members,
                     long long ps, long long xs, long long qs, void* stream) {
  if (members < 0 || members > 65535) return (int)cudaErrorInvalidValue;
  if (members == 0) return 0;
  const ChunkArgs a{pool, X, P, (const int32_t*)cptr, (const int32_t*)cslot,
                    (const int32_t*)csrc, count, nrhs, (cudaStream_t)stream,
                    members, ps, xs, qs};
  return dispatch<ChunkLaunch, T>(a, bs, transpose);
}

template <typename T>
int solve_rows(const void* dinv, void* X, const void* P, const void* rows,
               const void* chunkptr, int q0, int count, int bs, int nrhs,
               int transpose, int diag, void* stream) {
  const RowArgs a{dinv, X, P, (const int32_t*)rows, (const int32_t*)chunkptr,
                  q0, count, nrhs, diag, (cudaStream_t)stream, 0, 0, 0, 0};
  return dispatch<RowLaunch, T>(a, bs, transpose);
}

template <typename T>
int solve_rows_batch(const void* dinv, void* X, const void* P,
                     const void* rows, const void* chunkptr, int q0,
                     int count, int bs, int nrhs, int transpose, int diag,
                     int members, long long is, long long xs, long long qs,
                     void* stream) {
  if (members < 0 || members > 65535) return (int)cudaErrorInvalidValue;
  if (members == 0) return 0;
  const RowArgs a{dinv, X, P, (const int32_t*)rows, (const int32_t*)chunkptr,
                  q0, count, nrhs, diag, (cudaStream_t)stream,
                  members, is, xs, qs};
  return dispatch<RowLaunch, T>(a, bs, transpose);
}

}  // namespace

// Pass 1 over `count` chunks: P[q] = sum over chunk q's triples
// cptr[q]..cptr[q+1] of op(pool[cslot]) . X[csrc] (cptr is the level's
// slice, P holds `count` blocks of bs x nrhs).
extern "C" int slu_solve_gemm_f32(const void* pool, const void* X, void* P,
                                  const void* cptr, const void* cslot,
                                  const void* csrc, int count, int bs,
                                  int nrhs, int transpose, void* stream) {
  return solve_gemm<float>(pool, X, P, cptr, cslot, csrc, count, bs, nrhs,
                           transpose, stream);
}

extern "C" int slu_solve_gemm_f64(const void* pool, const void* X, void* P,
                                  const void* cptr, const void* cslot,
                                  const void* csrc, int count, int bs,
                                  int nrhs, int transpose, void* stream) {
  return solve_gemm<double>(pool, X, P, cptr, cslot, csrc, count, bs, nrhs,
                            transpose, stream);
}

extern "C" int slu_solve_gemm_c64(const void* pool, const void* X, void* P,
                                  const void* cptr, const void* cslot,
                                  const void* csrc, int count, int bs,
                                  int nrhs, int transpose, void* stream) {
  return solve_gemm<slu_rows::cplx<float>>(pool, X, P, cptr, cslot, csrc,
                                           count, bs, nrhs, transpose,
                                           stream);
}

extern "C" int slu_solve_gemm_c128(const void* pool, const void* X, void* P,
                                   const void* cptr, const void* cslot,
                                   const void* csrc, int count, int bs,
                                   int nrhs, int transpose, void* stream) {
  return solve_gemm<slu_rows::cplx<double>>(pool, X, P, cptr, cslot, csrc,
                                            count, bs, nrhs, transpose,
                                            stream);
}

// Pass 2 over `count` rows: Y = X[rows[b]] - sum of P[q - q0] for q in
// chunkptr[b]..chunkptr[b+1] (no partials when chunkptr is null), then
// X[rows[b]] = op(dinv[rows[b]]) . Y with `diag`, else X[rows[b]] = Y.
extern "C" int slu_solve_rows_f32(const void* dinv, void* X, const void* P,
                                  const void* rows, const void* chunkptr,
                                  int q0, int count, int bs, int nrhs,
                                  int transpose, int diag, void* stream) {
  return solve_rows<float>(dinv, X, P, rows, chunkptr, q0, count, bs, nrhs,
                           transpose, diag, stream);
}

extern "C" int slu_solve_rows_f64(const void* dinv, void* X, const void* P,
                                  const void* rows, const void* chunkptr,
                                  int q0, int count, int bs, int nrhs,
                                  int transpose, int diag, void* stream) {
  return solve_rows<double>(dinv, X, P, rows, chunkptr, q0, count, bs, nrhs,
                            transpose, diag, stream);
}

extern "C" int slu_solve_rows_c64(const void* dinv, void* X, const void* P,
                                  const void* rows, const void* chunkptr,
                                  int q0, int count, int bs, int nrhs,
                                  int transpose, int diag, void* stream) {
  return solve_rows<slu_rows::cplx<float>>(dinv, X, P, rows, chunkptr, q0,
                                           count, bs, nrhs, transpose, diag,
                                           stream);
}

extern "C" int slu_solve_rows_c128(const void* dinv, void* X, const void* P,
                                   const void* rows, const void* chunkptr,
                                   int q0, int count, int bs, int nrhs,
                                   int transpose, int diag, void* stream) {
  return solve_rows<slu_rows::cplx<double>>(dinv, X, P, rows, chunkptr, q0,
                                            count, bs, nrhs, transpose, diag,
                                            stream);
}

// The stacked forms of the two passes: `members` members, member m's
// pool (pass 1) or diagonal inverses (pass 2) m * ps (is) elements in, its
// X m * xs and its P m * qs; the tapes are shared.
#define SLU_SOLVE_BATCH(SFX, T)                                               \
  extern "C" int slu_solve_gemm_batch_##SFX(                                  \
      const void* pool, const void* X, void* P, const void* cptr,             \
      const void* cslot, const void* csrc, int count, int bs, int nrhs,       \
      int transpose, int members, long long ps, long long xs, long long qs,   \
      void* stream) {                                                         \
    return solve_gemm_batch<T>(pool, X, P, cptr, cslot, csrc, count, bs,      \
                               nrhs, transpose, members, ps, xs, qs, stream); \
  }                                                                           \
  extern "C" int slu_solve_rows_batch_##SFX(                                  \
      const void* dinv, void* X, const void* P, const void* rows,             \
      const void* chunkptr, int q0, int count, int bs, int nrhs,              \
      int transpose, int diag, int members, long long is, long long xs,       \
      long long qs, void* stream) {                                           \
    return solve_rows_batch<T>(dinv, X, P, rows, chunkptr, q0, count, bs,     \
                               nrhs, transpose, diag, members, is, xs, qs,    \
                               stream);                                       \
  }

SLU_SOLVE_BATCH(f32, float)
SLU_SOLVE_BATCH(f64, double)
SLU_SOLVE_BATCH(c64, slu_rows::cplx<float>)
SLU_SOLVE_BATCH(c128, slu_rows::cplx<double>)
