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
// one right-hand side and for tiles of kRT = 8 (template RT). Templates on
// the element type (float, double: IEEE arithmetic in that type), the
// block size (32, 64, 128), the transpose flag, RT and (pass 2) the
// diagonal.

#include "rows.cuh"

namespace {

using slu_rows::kRT;
using slu_rows::kThreads;

// one 16-byte load through the read-only path into kV = 16 / sizeof(T)
// registers; p is 16-byte aligned
template <typename T>
__device__ __forceinline__ void ld16(const T* __restrict__ p, T* v) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = a.x;
    v[1] = a.y;
  }
}

// How the kThreads threads of a CTA share the product of one bs x bs
// block M (row major) with a bs x rt tile x (x(k, c) gives its entries).
template <typename T, int BS, bool kTrans>
struct Map {
  static constexpr int kV = 16 / sizeof(T);    // elements per 16-byte load
  static constexpr int kQ = BS / kV;           // 16-byte words per row of M
  // threads that hold partial sums of the same outputs
  static constexpr int kGroups = kTrans ? kThreads / kQ : kThreads / BS;
  static constexpr int kOut = kTrans ? kV : 1;  // outputs per thread
  // 16-byte loads per thread per block
  static constexpr int kSteps = kTrans ? BS / kGroups : kQ / kGroups;
  static constexpr int kLd = BS + kV;          // padded row of `red`
  static_assert(kQ <= kThreads && kSteps >= 1, "block size");

  template <int RT>
  static constexpr int red_elems() {
    return kGroups * RT * kLd > kThreads ? kGroups * RT * kLd : kThreads;
  }

  __device__ static int group() {
    return kTrans ? threadIdx.x / kQ : threadIdx.x / BS;
  }

  // acc += op(M) . x over this thread's share of M.
  //   M^T: thread (j, g) owns outputs i = j*kV .. j*kV + kV-1 and reads
  //        16-byte word j of rows k = g, g + kGroups, ...; a warp reads
  //        consecutive words of a row.
  //   M:   thread (r, h) owns output row r and reads its 16-byte words
  //        j = h, h + kGroups, ...; each lane's words fill whole sectors.
  template <int RT, typename XAt>
  __device__ static void accumulate(const T* __restrict__ M, int rt, XAt x,
                                    T (&acc)[kOut][RT]) {
    const int g = group();
    if constexpr (kTrans) {
      const T* col = M + (threadIdx.x % kQ) * kV;
#pragma unroll 8
      for (int m = 0; m < kSteps; ++m) {
        const int k = g + kGroups * m;
        T a[kV];
        ld16(col + k * BS, a);
#pragma unroll
        for (int c = 0; c < RT; ++c) {
          if (c < rt) {
            const T xv = x(k, c);
#pragma unroll
            for (int v = 0; v < kV; ++v) acc[v][c] += a[v] * xv;
          }
        }
      }
    } else {
      const T* row = M + (threadIdx.x % BS) * BS;
#pragma unroll 8
      for (int m = 0; m < kSteps; ++m) {
        const int j = g + kGroups * m;
        T a[kV];
        ld16(row + j * kV, a);
#pragma unroll
        for (int v = 0; v < kV; ++v) {
#pragma unroll
          for (int c = 0; c < RT; ++c)
            if (c < rt) acc[0][c] += a[v] * x(j * kV + v, c);
        }
      }
    }
  }

  // The groups' partial sums meet in `red` and are added in group order;
  // emit(i, c, value) for each output row i and column c < rt. Contains a
  // __syncthreads(): call it from every thread of the CTA.
  template <int RT, typename Emit>
  __device__ static void reduce(const T (&acc)[kOut][RT], int rt, T* red,
                                Emit emit) {
    const int g = group();
    const int i0 = kTrans ? (threadIdx.x % kQ) * kV : threadIdx.x % BS;
#pragma unroll
    for (int c = 0; c < RT; ++c) {
      if (c < rt) {
#pragma unroll
        for (int v = 0; v < kOut; ++v)
          red[(g * RT + c) * kLd + i0 + v] = acc[v][c];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < BS * rt; e += kThreads) {
      const int i = e / rt, c = e - i * rt;
      T s = red[c * kLd + i];
      for (int h = 1; h < kGroups; ++h) s += red[(h * RT + c) * kLd + i];
      emit(i, c, s);
    }
  }
};

// ---- pass 1: a chunk's products into its partial sum ---------------------
template <typename T, int BS, bool kTrans, int RT>
__global__ void __launch_bounds__(kThreads, 2)
chunk_kernel(const T* __restrict__ pool, const T* __restrict__ X,
             T* __restrict__ P, const int32_t* __restrict__ cptr,
             const int32_t* __restrict__ cslot,
             const int32_t* __restrict__ csrc, int nrhs) {
  using M = Map<T, BS, kTrans>;
  const int q = blockIdx.x;
  const int c0 = blockIdx.y * RT;
  const int rt = min(RT, nrhs - c0);
  T acc[M::kOut][RT] = {};
  const int p1 = cptr[q + 1];
  for (int p = cptr[q]; p < p1; ++p) {
    const T* x = X + (int64_t)csrc[p] * BS * nrhs + c0;
    M::template accumulate<RT>(
        pool + (int64_t)cslot[p] * BS * BS, rt,
        [&](int k, int c) { return __ldg(x + k * nrhs + c); }, acc);
  }
  T* Pq = P + (int64_t)q * BS * nrhs + c0;
  M::template reduce<RT>(acc, rt, slu_rows::dyn_smem<T>(),
                         [&](int i, int c, T v) { Pq[i * nrhs + c] = v; });
}

// ---- pass 2: a row's partials, then its diagonal --------------------------
template <typename T, int BS, bool kTrans, int RT, bool kDiag>
__global__ void __launch_bounds__(kThreads, 2)
rows_kernel(const T* __restrict__ dinv, T* __restrict__ X,
            const T* __restrict__ P, const int32_t* __restrict__ rows,
            const int32_t* __restrict__ chunkptr, int q0, int nrhs) {
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
};

struct RowArgs {
  const void* dinv;
  void* X;
  const void* P;
  const int32_t* rows;
  const int32_t* chunkptr;
  int q0, count, nrhs, diag;
  cudaStream_t stream;
};

template <typename T, int BS, bool kTrans, int RT>
struct ChunkLaunch {
  static void go(const ChunkArgs& a) {
    using M = Map<T, BS, kTrans>;
    constexpr size_t smem = M::template red_elems<RT>() * sizeof(T);
    static_assert(smem <= 48 * 1024, "shared memory");
    const dim3 grid(a.count, (a.nrhs + RT - 1) / RT);
    chunk_kernel<T, BS, kTrans, RT><<<grid, kThreads, smem, a.stream>>>(
        (const T*)a.pool, (const T*)a.X, (T*)a.P, a.cptr, a.cslot, a.csrc,
        a.nrhs);
  }
};

template <typename T, int BS, bool kTrans, int RT>
struct RowLaunch {
  static void go(const RowArgs& a) {
    using M = Map<T, BS, kTrans>;
    constexpr size_t smem =
        (BS * RT + M::template red_elems<RT>()) * sizeof(T);
    static_assert(smem <= 48 * 1024, "shared memory");
    const dim3 grid(a.count, (a.nrhs + RT - 1) / RT);
    if (a.diag)
      rows_kernel<T, BS, kTrans, RT, true><<<grid, kThreads, smem, a.stream>>>(
          (const T*)a.dinv, (T*)a.X, (const T*)a.P, a.rows, a.chunkptr, a.q0,
          a.nrhs);
    else
      rows_kernel<T, BS, kTrans, RT, false><<<grid, kThreads, smem,
                                              a.stream>>>(
          (const T*)a.dinv, (T*)a.X, (const T*)a.P, a.rows, a.chunkptr, a.q0,
          a.nrhs);
  }
};

template <template <typename, int, bool, int> class L, typename T, int BS,
          bool kTrans, typename A>
void by_rt(const A& a) {
  if (a.nrhs == 1)
    L<T, BS, kTrans, 1>::go(a);
  else
    L<T, BS, kTrans, kRT>::go(a);
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
                    (const int32_t*)csrc, count, nrhs, (cudaStream_t)stream};
  return dispatch<ChunkLaunch, T>(a, bs, transpose);
}

template <typename T>
int solve_rows(const void* dinv, void* X, const void* P, const void* rows,
               const void* chunkptr, int q0, int count, int bs, int nrhs,
               int transpose, int diag, void* stream) {
  const RowArgs a{dinv, X, P, (const int32_t*)rows, (const int32_t*)chunkptr,
                  q0, count, nrhs, diag, (cudaStream_t)stream};
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
