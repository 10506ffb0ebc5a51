// panel.cuh: the panel TRSM by a stored inverse, shared by schur.cu
// (`trsm`, both flags, float and double) and clk.cu (`clk_trsm`), its
// band product (band_product, which rdma.cu's `rdma_panel` runs before
// storing the band into its peers' buffers), its pieces (stage_chunk,
// mul_chunk, load_tile, store_tile), which chain.cuh's chain product
// reuses, and the cp.async helpers that waves.cuh stages with.
//
// What it computes, in place over a list of (slot, step), X = pool[slot]
// and D = dinv[step], every block bs x bs:
//   LEFT = false (L panels):  X <- X . D
//   LEFT = true  (U panels):  X <- D . X
//
// Ownership, which keeps the update in place safe. X . D mixes the columns
// of a row of X, and D . X the rows of a column; so a CTA owns a band of BM
// whole rows of one block (LEFT = false) or BM whole columns (LEFT = true),
// and every element of its output band depends only on its input band and
// on D. The CTA reads its band only through copies into shared memory, and
// writes it back from registers only after the last of those copies has
// landed for every thread (the last wait and barrier of the loop). No
// other CTA reads or writes those rows (columns), a slot appears once in a
// launch, and the inverses are another array. This is the hazard that
// makes chain.cuh's FIN_L bands whole rows.
//
// Design. The product is out = A . B with A = the band, B = D (LEFT =
// false) or A = D, B = the band (LEFT = true). Both stream through shared
// memory by cp.async in a ring of four stages, each KC columns of A and
// the matching KC rows of B (KC * sizeof(T) = 128 bytes), so the product
// never waits on L2 or device-memory latency and the first product starts
// after one stage, not after the whole band. The staged rows of A (which
// a warp reads down a column) are padded by 16 bytes, so the rows that one
// access reads fall in distinct banks. Each thread owns a 4 x TN tile of
// the M x N output band: rows g, g + M/4, g + M/2, g + 3M/4 and TN columns
// in 16-byte groups spaced N / (TN/W) apart (W elements per 16 bytes), so
// that the threads of a quarter warp read consecutive 16-byte words of a
// B row. The arithmetic is IEEE FMA in T on the CUDA cores (no TF32); each
// output sums its bs products in ascending k. T is float, double, or
// cplx.cuh's complex64 and complex128 (each complex FMA four real ones in a
// fixed order). At bs = 128 a launch takes
// bands of 64 with 4 x 8 tiles (two bands a block, 256 threads, 100-104
// KiB of shared memory, two CTAs an SM), or bands of 16 with 4 x 4 tiles
// (8 bands a block, 128 threads) when the bands of 64 would fill fewer
// CTAs than the card has SMs: such a launch is latency-bound, and each
// thread's chain of products is then a quarter as long. bs = 64 chooses
// the same way between the whole block and bands of 16; bs = 32 takes the
// whole block. complex128 (16 bytes an element, 8 to a stage's 128-byte
// chunk) takes bands of 16 with 4 x 4 tiles at every block size: a 4 x 8
// tile of it is 128 registers of accumulator alone, and bands of 64 with
// 4 x 4 tiles run 512 threads, which may hold only 128 registers each.
//
// Offsets are computed in 64 bits (slot * bs^2 passes 2^31 near n = 885k).
//
// The bf16 pass (BF16 = true, float and X <- X . D only: clk's L-part
// TRSM at gemm_precision "default"): the same ring and band ownership,
// the product on the tensor cores through mma.cuh's m16n8k16 bf16 tiles
// with float32 accumulation. Each warp owns 2 x 4 tiles of 16 x 8 of the
// band (1 x 4 in bands of 16), the same outputs per thread as the FP32
// tile (chain.cuh's bf16 pass, flk's, adds 2 x 2 in a band of 16
// columns); the staged rows of B are N + 4 floats apart, so that a B
// fragment's four k rows fall in distinct banks. BF16 = false compiles to
// the kernels above, unchanged; schur.cu's trsm and trsm_batch and
// rdma.cu's panels keep full precision, as the JAX package's do.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cplx.cuh"
#include "mma.cuh"

namespace slu_panel {

using slu_cplx::cplx;

// ---------------------------------------------------------------------------
// cp.async: 16-byte copies from device memory to shared memory through L2
// (cp.async.cg), committed in groups; both addresses 16-byte aligned.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// W = 16 / sizeof(T) consecutive elements, 16-byte aligned
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int W = 4;
  static __device__ __forceinline__ void ld(const float* p, float v[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  static __device__ __forceinline__ void st(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec16<double> {
  static constexpr int W = 2;
  static __device__ __forceinline__ void ld(const double* p, double v[2]) {
    const double2 x = *reinterpret_cast<const double2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  }
  static __device__ __forceinline__ void st(double* p, const double v[2]) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
};

template <>
struct Vec16<cplx<float>> {
  static constexpr int W = 2;
  static __device__ __forceinline__ void ld(const cplx<float>* p,
                                            cplx<float> v[2]) {
    slu_cplx::ld16v(p, v);
  }
  static __device__ __forceinline__ void st(cplx<float>* p,
                                            const cplx<float> v[2]) {
    slu_cplx::st16v(p, v);
  }
};

template <>
struct Vec16<cplx<double>> {
  static constexpr int W = 1;
  static __device__ __forceinline__ void ld(const cplx<double>* p,
                                            cplx<double> v[1]) {
    slu_cplx::ld16v(p, v);
  }
  static __device__ __forceinline__ void st(cplx<double>* p,
                                            const cplx<double> v[1]) {
    slu_cplx::st16v(p, v);
  }
};

// The geometry of one instantiation: bands of BM rows (columns), a
// 4 x TN tile per thread. The product is out = A . B, out M x N, with
// A = the band and B = D (LEFT = false) or A = D and B = the band
// (LEFT = true), k over BS; a stage of the ring holds KC columns of A
// (rows padded to LDA) and the matching KC rows of B.
template <typename T, int BS, bool LEFT, int BM, int TN>
struct Panel {
  static constexpr int W = Vec16<T>::W;
  static constexpr int KC = 128 / sizeof(T);     // k per stage
  static constexpr int STAGES = 4;
  static constexpr int NT = BM * BS / (4 * TN);  // threads
  static constexpr int M = LEFT ? BS : BM;
  static constexpr int N = LEFT ? BM : BS;
  static constexpr int LDA = KC + W;
  static constexpr int kA = M * LDA;
  static constexpr int kStage = kA + KC * N;
  static constexpr size_t kBytes = (size_t)STAGES * kStage * sizeof(T);
  static constexpr int BSZ = BS;
  static constexpr int TW = TN;       // columns of a thread's tile
  static constexpr int CT = N / TN;   // threads along a row of out
  static constexpr int RS = M / 4;    // row stride of a thread's 4 rows
  static constexpr int CS = CT * W;   // column stride of its groups
  static_assert(BS % KC == 0 && BS % BM == 0 && TN % W == 0 &&
                    BM >= 2 * TN, "block size");
  static_assert(kBytes <= 113 * 1024, "shared memory: two CTAs per SM");
};

// Stage chunk k0 of a product out = A . B into `st`: columns k0 .. k0+KC
// of A (element (r, k) at Ag[r * BS + k], r < M; rows padded to LDA) and
// rows k0 .. k0+KC of B (element (k, q) at Bg[k * BS + q], q < N; staged
// rows LDB elements apart). A null operand is not staged (it is read from
// elsewhere). Every thread of the CTA issues its copies.
template <class P, int LDB = P::N, typename T>
__device__ __forceinline__ void stage_chunk(T* st, const T* Ag, const T* Bg,
                                            int k0) {
  constexpr int W = P::W, KC = P::KC, M = P::M, N = P::N, NT = P::NT;
  const int tid = threadIdx.x;
  if (Ag != nullptr)
    for (int e = tid; e < M * (KC / W); e += NT) {
      const int r = e / (KC / W), q = (e % (KC / W)) * W;
      cp_async16(st + r * P::LDA + q, Ag + (int64_t)r * P::BSZ + k0 + q);
    }
  if (Bg != nullptr) {
    T* bs = st + P::kA;
    for (int e = tid; e < KC * (N / W); e += NT) {
      const int r = e / (N / W), q = (e % (N / W)) * W;
      cp_async16(bs + r * LDB + q, Bg + (int64_t)(k0 + r) * P::BSZ + q);
    }
  }
}

// acc += A . B over one chunk of KC: this thread's rows g + i * RS of A
// (row r at A + r * LDA_) and its columns c0 + j * CS .. of B (row k at
// B + k * LDB_), each output summing its k in ascending order; the k loop
// unrolled by UK steps of W (whole by default).
template <class P, int LDA_, int LDB_, int UK = P::KC / P::W, typename T>
__device__ __forceinline__ void mul_chunk(const T* A, const T* B, int g,
                                          int c0, T (&acc)[4][P::TW]) {
  using V = Vec16<T>;
  constexpr int W = P::W, TN = P::TW;
#pragma unroll (UK)
  for (int kk = 0; kk < P::KC; kk += W) {
    T a[4][W];
#pragma unroll
    for (int i = 0; i < 4; ++i) V::ld(A + (g + i * P::RS) * LDA_ + kk, a[i]);
#pragma unroll
    for (int u = 0; u < W; ++u) {
      T b[TN];
#pragma unroll
      for (int j = 0; j < TN / W; ++j)
        V::ld(B + (kk + u) * LDB_ + c0 + j * P::CS, b + j * W);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fma(a[i][u], b[j], acc[i][j]);
    }
  }
}

// This thread's 4 x TN share of an M x N band with leading dimension LD:
// rows g + i * RS, columns c0 + j * CS .. (W at a time).
template <class P, int LD, typename T>
__device__ __forceinline__ void load_tile(const T* X, int g, int c0,
                                          T (&acc)[4][P::TW]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < P::TW / P::W; ++j)
      Vec16<T>::ld(X + (int64_t)(g + i * P::RS) * LD + c0 + j * P::CS,
                   acc[i] + j * P::W);
}

template <class P, int LD, typename T>
__device__ __forceinline__ void store_tile(T* X, int g, int c0,
                                           const T (&acc)[4][P::TW]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < P::TW / P::W; ++j)
      Vec16<T>::st(X + (int64_t)(g + i * P::RS) * LD + c0 + j * P::CS,
                   acc[i] + j * P::W);
}

// acc = A . B for one band (k over BS), both operands streamed through the
// ring (STAGES stages of P::kStage elements at `ring`): A = the band, B = D
// (LEFT = false) or A = D, B = the band (LEFT = true), as the kernel below
// and rdma.cu's panels use it. g, c0 give this thread's tile.
template <class P, typename T>
__device__ __forceinline__ void band_product(T* ring, const T* Ag,
                                             const T* Bg, int g, int c0,
                                             T (&acc)[4][P::TW]) {
  constexpr int ST = P::STAGES;
  constexpr int NK = P::BSZ / P::KC;   // stages per product
#pragma unroll
  for (int c = 0; c < ST - 1; ++c) {
    if (c < NK) stage_chunk<P>(ring + c * P::kStage, Ag, Bg, c * P::KC);
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < P::TW; ++j) acc[i][j] = T(0);
  for (int c = 0; c < NK; ++c) {
    cp_async_wait<ST - 2>();   // chunk c has landed
    __syncthreads();           // ... for every thread; stage c-1 is free
    if (c + ST - 1 < NK)
      stage_chunk<P>(ring + ((c + ST - 1) % ST) * P::kStage, Ag, Bg,
                     (c + ST - 1) * P::KC);
    cp_async_commit();
    const T* A = ring + (c % ST) * P::kStage;
    // complex keeps the k loop rolled (complex64's 4 x 8 tile, unrolled
    // whole, spilled 12 bytes)
    mul_chunk<P, P::LDA, P::N, slu_cplx::is_cplx<T> ? 1 : P::KC / P::W>(
        A, A + P::kA, g, c0, acc);
  }
}

// The bf16 pass's geometry of a float Panel P: a warp's WM x WN tiles of
// 16 x 8 (the 4 x TW outputs of each of its threads: 2 x 4 for a 4 x 8
// tile, 1 x 4 for a 4 x 4 one, 2 x 2 in a band only 16 wide), WC warps
// along a row of the band, the staged rows of B LDB floats apart (4 mod
// 16: distinct banks for a B fragment's k rows).
template <class P>
struct PanelMma {
  static constexpr int LDB = P::N + 4;
  static constexpr int kStage = P::kA + P::KC * LDB;
  static constexpr size_t kBytes = (size_t)P::STAGES * kStage * sizeof(float);
  static constexpr int WN = P::N >= 32 ? 4 : P::N / 8;   // n8 tiles of a warp
  static constexpr int WM = P::TW / WN;                   // m16 tiles of a warp
  static constexpr int WC = P::N / (8 * WN);      // warps along a row
  static_assert(WC >= 1 && WC * (P::M / (16 * WM)) * 32 == P::NT &&
                    P::KC % 16 == 0,
                "one warp per 16 WM x 8 WN tile of the band");
  static_assert(kBytes <= 113 * 1024, "shared memory: two CTAs per SM");
};

// acc = A . B for one band in the bf16 pass: band_product's ring and
// order, this warp's tiles at rows r0 + 16 i, columns c0 + 8 j.
template <class P>
__device__ __forceinline__ void band_product_mma(
    float* ring, const float* Ag, const float* Bg, int r0, int c0,
    float (&acc)[PanelMma<P>::WM][PanelMma<P>::WN][4]) {
  using Q = PanelMma<P>;
  constexpr int ST = P::STAGES;
  constexpr int NK = P::BSZ / P::KC;   // stages per product
#pragma unroll
  for (int c = 0; c < ST - 1; ++c) {
    if (c < NK)
      stage_chunk<P, Q::LDB>(ring + c * Q::kStage, Ag, Bg, c * P::KC);
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < Q::WM; ++i)
#pragma unroll
    for (int j = 0; j < Q::WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int c = 0; c < NK; ++c) {
    cp_async_wait<ST - 2>();   // chunk c has landed
    __syncthreads();           // ... for every thread; stage c-1 is free
    if (c + ST - 1 < NK)
      stage_chunk<P, Q::LDB>(ring + ((c + ST - 1) % ST) * Q::kStage, Ag, Bg,
                             (c + ST - 1) * P::KC);
    cp_async_commit();
    const float* A = ring + (c % ST) * Q::kStage;
    slu_mma::mma_chunk<P::KC, P::LDA, Q::LDB, Q::WM, Q::WN>(A, A + P::kA, r0,
                                                            c0, acc);
  }
}

// One CTA's band of panel slots[blockIdx.x]: X <- X . D (LEFT false) or
// D . X (LEFT true), the band blockIdx.y; with BF16, the bf16 pass.
template <typename T, int BS, bool LEFT, int BM, int TN, bool BF16 = false>
__device__ __forceinline__ void band_inverse(T* pool,
                                             const T* __restrict__ dinv,
                                             const int32_t* __restrict__ slots,
                                             const int32_t* __restrict__ steps) {
  using P = Panel<T, BS, LEFT, BM, TN>;
  extern __shared__ float4 smem4[];
  if constexpr (BF16) {
    static_assert(sizeof(T) == sizeof(float), "the bf16 pass is float's");
    using Q = PanelMma<P>;
    const int warp = threadIdx.x >> 5;
    const int r0 = (warp / Q::WC) * 16 * Q::WM;
    const int c0 = (warp % Q::WC) * 8 * Q::WN;
    const int64_t bb = (int64_t)BS * BS;
    const int64_t band = blockIdx.y;
    T* X = pool + (int64_t)slots[blockIdx.x] * bb +
           (LEFT ? band * BM : band * BM * BS);
    const T* D = dinv + (int64_t)steps[blockIdx.x] * bb;
    float acc[Q::WM][Q::WN][4];
    band_product_mma<P>(reinterpret_cast<float*>(smem4), LEFT ? D : X,
                        LEFT ? X : D, r0, c0, acc);
    // as below: the band is written only after its last copy landed
#pragma unroll
    for (int i = 0; i < Q::WM; ++i)
#pragma unroll
      for (int j = 0; j < Q::WN; ++j)
        slu_mma::store_c<BS>(X, r0 + 16 * i, c0 + 8 * j, acc[i][j]);
  } else {
    const int g = threadIdx.x / P::CT;
    const int c0 = (threadIdx.x % P::CT) * P::W;
    const int64_t bb = (int64_t)BS * BS;
    const int64_t band = blockIdx.y;
    // element (r, q) of the band is X[r * BS + q]
    T* X = pool + (int64_t)slots[blockIdx.x] * bb +
           (LEFT ? band * BM : band * BM * BS);
    const T* D = dinv + (int64_t)steps[blockIdx.x] * bb;
    T acc[4][TN];
    band_product<P>(reinterpret_cast<T*>(smem4), LEFT ? D : X,
                    LEFT ? X : D, g, c0, acc);
    // every read of the band was a copy that has landed (the last wait);
    // only now is it written
    store_tile<P, BS>(X, g, c0, acc);
  }
}

template <typename T, int BS, bool LEFT, int BM, int TN, bool BF16 = false>
__global__ void __launch_bounds__(Panel<T, BS, LEFT, BM, TN>::NT)
band_times_inverse(T* pool, const T* __restrict__ dinv,
                   const int32_t* __restrict__ slots,
                   const int32_t* __restrict__ steps) {
  band_inverse<T, BS, LEFT, BM, TN, BF16>(pool, dinv, slots, steps);
}

// The same over the members of a stacked pool: member blockIdx.z's pool and
// inverses start member * pool_stride and member * inv_stride elements in;
// the member moves the pointers only.
template <typename T, int BS, bool LEFT, int BM, int TN>
__global__ void __launch_bounds__(Panel<T, BS, LEFT, BM, TN>::NT)
band_times_inverse_batch(T* pool, const T* __restrict__ dinv,
                         const int32_t* __restrict__ slots,
                         const int32_t* __restrict__ steps,
                         int64_t pool_stride, int64_t inv_stride) {
  const int64_t m = blockIdx.z;
  band_inverse<T, BS, LEFT, BM, TN>(pool + m * pool_stride,
                                    dinv + m * inv_stride, slots, steps);
}

// A launch's members: `count` 0 is the unbatched launch (no z axis).
struct Members {
  int count = 0;
  int64_t pool_stride = 0, inv_stride = 0;
};

template <typename T, int BS, bool LEFT, int BM, int TN, bool BF16 = false>
int launch_bm(void* pool, const void* dinv, const void* slots,
              const void* steps, int count, cudaStream_t stream,
              const Members& mb) {
  using P = Panel<T, BS, LEFT, BM, TN>;
  if constexpr (BF16) {
    if (mb.count != 0) return (int)cudaErrorInvalidValue;
    constexpr size_t bytes = PanelMma<P>::kBytes;
    const cudaError_t e = cudaFuncSetAttribute(
        band_times_inverse<T, BS, LEFT, BM, TN, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    band_times_inverse<T, BS, LEFT, BM, TN, true>
        <<<dim3((unsigned)count, BS / BM), P::NT, bytes, stream>>>(
            (T*)pool, (const T*)dinv, (const int32_t*)slots,
            (const int32_t*)steps);
  } else if (mb.count == 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        band_times_inverse<T, BS, LEFT, BM, TN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kBytes);
    if (e != cudaSuccess) return (int)e;
    band_times_inverse<T, BS, LEFT, BM, TN>
        <<<dim3((unsigned)count, BS / BM), P::NT, P::kBytes, stream>>>(
            (T*)pool, (const T*)dinv, (const int32_t*)slots,
            (const int32_t*)steps);
  } else {
    const cudaError_t e = cudaFuncSetAttribute(
        band_times_inverse_batch<T, BS, LEFT, BM, TN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kBytes);
    if (e != cudaSuccess) return (int)e;
    band_times_inverse_batch<T, BS, LEFT, BM, TN>
        <<<dim3((unsigned)count, BS / BM, (unsigned)mb.count), P::NT,
           P::kBytes, stream>>>((T*)pool, (const T*)dinv,
                                (const int32_t*)slots, (const int32_t*)steps,
                                mb.pool_stride, mb.inv_stride);
  }
  return (int)cudaGetLastError();
}

// The SMs of the current device (read once).
inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 1;
  }();
  return n;
}

// At bs >= 64, bands of 64 rows (columns) with 4 x 8 tiles, or, when that
// gives the card fewer CTAs than SMs, bands of 16 with 4 x 4 tiles: a
// launch of few panels is latency-bound, and each thread's chain of
// products is then a quarter (bs = 128) as long. complex128 always takes
// bands of 16 with 4 x 4 tiles (the header says why).
// The geometry is chosen from `count`, the panels of one member, so a
// member of a batched launch runs the unbatched launch's geometry (and the
// bf16 pass the FP32 pass's).
template <typename T, int BS, bool LEFT, bool BF16 = false>
int launch_bs(void* pool, const void* dinv, const void* slots,
              const void* steps, int count, cudaStream_t stream,
              const Members& mb) {
  if constexpr (sizeof(T) == 16) {
    return launch_bm<T, BS, LEFT, 16, 4>(pool, dinv, slots, steps, count,
                                         stream, mb);
  } else if constexpr (BS < 64) {
    return launch_bm<T, BS, LEFT, BS, 8, BF16>(pool, dinv, slots, steps,
                                               count, stream, mb);
  } else {
    if ((int64_t)count * (BS / 64) < sm_count())
      return launch_bm<T, BS, LEFT, 16, 4, BF16>(pool, dinv, slots, steps,
                                                 count, stream, mb);
    return launch_bm<T, BS, LEFT, 64, 8, BF16>(pool, dinv, slots, steps,
                                               count, stream, mb);
  }
}

template <typename T, bool LEFT, bool BF16 = false>
int launch_left(void* pool, const void* dinv, const void* slots,
                const void* steps, int count, int bs, cudaStream_t stream,
                const Members& mb) {
  switch (bs) {
    case 32: return launch_bs<T, 32, LEFT, BF16>(pool, dinv, slots, steps,
                                                 count, stream, mb);
    case 64: return launch_bs<T, 64, LEFT, BF16>(pool, dinv, slots, steps,
                                                 count, stream, mb);
    case 128: return launch_bs<T, 128, LEFT, BF16>(pool, dinv, slots, steps,
                                                   count, stream, mb);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The panel TRSM over `count` (slot, step) pairs (int32 device arrays):
// X <- X . dinv[step] (left = 0) or dinv[step] . X (left != 0). Returns
// the cudaError_t of the launch (a refused launch never runs). With
// mb.count > 0 the same over mb.count members of a stacked pool
// (gridDim.z, at most 65,535). BF16 runs the bf16 pass, which serves
// left = 0 without members alone (clk's L panels).
template <typename T, bool BF16 = false>
int trsm(void* pool, const void* dinv, const void* slots, const void* steps,
         int count, int bs, int left, void* stream, const Members& mb = {}) {
  if (mb.count < 0 || mb.count > 65535) return (int)cudaErrorInvalidValue;
  if (count == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if constexpr (BF16) {
    if (left || mb.count != 0) return (int)cudaErrorInvalidValue;
    return launch_left<T, false, true>(pool, dinv, slots, steps, count, bs,
                                       s, mb);
  } else {
    return left ? launch_left<T, true>(pool, dinv, slots, steps, count, bs,
                                       s, mb)
                : launch_left<T, false>(pool, dinv, slots, steps, count, bs,
                                        s, mb);
  }
}

}  // namespace slu_panel
