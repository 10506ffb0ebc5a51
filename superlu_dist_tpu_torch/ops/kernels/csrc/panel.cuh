// panel.cuh: the panel TRSM by a stored inverse, shared by schur.cu
// (`trsm`, both flags, in every type) and clk.cu (`clk_trsm`, FP32 and the
// bf16 pass), its band product (band_product, which rdma.cu's
// `rdma_panel` runs before storing the band into its peers' buffers), its
// pieces (stage_chunk, mul_chunk, load_tile, store_tile), which chain.cuh's
// chain product reuses, the bf16 tiles that passes.cuh's chain product
// takes (PanelMma), and the cp.async helpers that waves.cuh stages with.
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
// Design (float, double, complex64). The product is out = A . B with A =
// the band, B = D (LEFT = false) or A = D, B = the band (LEFT = true). Both
// stream through shared memory by cp.async in a ring of four stages, each
// KC columns of A and the matching KC rows of B (KC * sizeof(T) = 128
// bytes), so the product never waits on L2 or device-memory latency and
// the first product starts after one stage, not after the whole band. The
// staged rows of A (which a warp reads down a column) are padded by 16
// bytes, so the rows that one access reads fall in distinct banks. Each
// thread owns a 4 x TN tile of the M x N output band: rows g, g + M/4, g +
// M/2, g + 3M/4 and TN columns in 16-byte groups spaced N / (TN/W) apart
// (W elements per 16 bytes), so that the threads of a quarter warp read
// consecutive 16-byte words of a B row. The arithmetic is IEEE FMA in T on
// the CUDA cores (no TF32); each output sums its bs products in ascending
// k. T is float, double, or cplx.cuh's complex64 (each complex FMA four
// real ones in a fixed order; rdma.cu's panels take complex128 this way
// too). At bs = 128 a launch takes bands of 64 with 4 x 8 tiles (two bands
// a block, 256 threads, 100-104 KiB of shared memory, two CTAs an SM), or
// bands of 16 with 4 x 4 tiles (8 bands a block, 128 threads) when the
// bands of 64 would fill fewer CTAs than the card has SMs: such a launch
// is latency-bound, and each thread's chain of products is then a quarter
// as long. bs = 64 chooses the same way between the whole block and bands
// of 16; bs = 32 takes the whole block.
//
// complex128 (zband_times_inverse) runs on the FP64 tensor cores
// (mma.sync .f64, m16n8k4), which give twice the CUDA cores' 34 TFLOP/s:
// a complex product is four real tile products, Re += Re A . Re B + (-Im
// A) . Im B and Im += Re A . Im B + Im A . Re B, in that order, each
// fragment's real and imaginary parts from one 16-byte load of the
// interleaved elements. The same ring (three stages of 8 complex columns)
// and ownership; a warp owns 16 rows and WN tiles of 8 columns of out, so
// the accumulators sit in the fragments. At bs = 128 a CTA takes a band of
// 64 rows (columns), 128 doubles of accumulator a thread, one CTA an SM:
// it streams D once for four times the outputs of the FP32 design's
// complex128 bands of 16 (whose 4 x 8 tile would have been 128 registers
// of accumulator); bs = 64 and 32 take bands of 32 (two CTAs an SM); any
// block size bands of 16 where the wide bands would leave SMs empty.
//
// Offsets are computed in 64 bits (slot * bs^2 passes 2^31 near n = 885k).
//
// The bf16 pass of clk's L-part TRSM (trsm_mma_kernel: float, X <- X . D,
// gemm_precision "default") is a kernel of its own: one CTA per (L panel,
// band of BM whole rows). The CTA rounds D = uinv(k) to bf16 once in
// shared memory, and streams its band through a cp.async ring, writing it
// back in place once its last chunk has landed; the products are
// mma.cuh's m16n8k16 bf16 tiles with float32 accumulation, A fragments
// built from the staged float32 band, B fragments read by ldmatrix from
// the bf16 D. Its CTAs may start while the previous grid drains
// (programmatic dependent launch) and wait for it before any read.
// Bounded by the bytes of its panels (read and written once; their
// operations at the bf16 tensor-core peak take about a sixth of that)
// and, on the small levels, by the launch. (CTAs that took a run of one
// column's panels, staging D once for the run, were no faster on an H100:
// tools/clk_strip_ab.py --trsm.)

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

// The bf16 tiles of a float Panel P, on which passes.cuh's chain product
// lays out its bf16 pass: a warp's WM x WN tiles of 16 x 8 (the 4 x TW
// outputs of each of its threads: 2 x 4 for a 4 x 8 tile, 1 x 4 for a 4 x
// 4 one, 2 x 2 in a band only 16 wide), WC warps along a row of the band,
// the staged rows of B LDB floats apart (4 mod 16: distinct banks for a B
// fragment's k rows).
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

// One CTA's band of panel slots[blockIdx.x]: X <- X . D (LEFT false) or
// D . X (LEFT true), the band blockIdx.y.
template <typename T, int BS, bool LEFT, int BM, int TN>
__device__ __forceinline__ void band_inverse(T* pool,
                                             const T* __restrict__ dinv,
                                             const int32_t* __restrict__ slots,
                                             const int32_t* __restrict__ steps) {
  using P = Panel<T, BS, LEFT, BM, TN>;
  extern __shared__ float4 smem4[];
  const int g = threadIdx.x / P::CT;
  const int c0 = (threadIdx.x % P::CT) * P::W;
  const int64_t bb = (int64_t)BS * BS;
  const int64_t band = blockIdx.y;
  // element (r, q) of the band is X[r * BS + q]
  T* X = pool + (int64_t)slots[blockIdx.x] * bb +
         (LEFT ? band * BM : band * BM * BS);
  const T* D = dinv + (int64_t)steps[blockIdx.x] * bb;
  T acc[4][TN];
  band_product<P>(reinterpret_cast<T*>(smem4), LEFT ? D : X, LEFT ? X : D,
                  g, c0, acc);
  // every read of the band was a copy that has landed (the last wait);
  // only now is it written
  store_tile<P, BS>(X, g, c0, acc);
}

template <typename T, int BS, bool LEFT, int BM, int TN>
__global__ void __launch_bounds__(Panel<T, BS, LEFT, BM, TN>::NT)
band_times_inverse(T* pool, const T* __restrict__ dinv,
                   const int32_t* __restrict__ slots,
                   const int32_t* __restrict__ steps) {
  band_inverse<T, BS, LEFT, BM, TN>(pool, dinv, slots, steps);
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

template <typename T, int BS, bool LEFT, int BM, int TN>
int launch_bm(void* pool, const void* dinv, const void* slots,
              const void* steps, int count, cudaStream_t stream,
              const Members& mb) {
  using P = Panel<T, BS, LEFT, BM, TN>;
  if (mb.count == 0) {
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
// products is then a quarter (bs = 128) as long.
// The geometry is chosen from `count`, the panels of one member, so a
// member of a batched launch runs the unbatched launch's geometry.
template <typename T, int BS, bool LEFT>
int launch_bs(void* pool, const void* dinv, const void* slots,
              const void* steps, int count, cudaStream_t stream,
              const Members& mb) {
  if constexpr (BS < 64) {
    return launch_bm<T, BS, LEFT, BS, 8>(pool, dinv, slots, steps, count,
                                         stream, mb);
  } else {
    if ((int64_t)count * (BS / 64) < sm_count())
      return launch_bm<T, BS, LEFT, 16, 4>(pool, dinv, slots, steps, count,
                                           stream, mb);
    return launch_bm<T, BS, LEFT, 64, 8>(pool, dinv, slots, steps, count,
                                         stream, mb);
  }
}

// ---------------------------------------------------------------------------
// complex128 on the FP64 tensor cores
// ---------------------------------------------------------------------------

// d += a . b on one m16n8k4 tile of float64 (3% faster than m16n8k8 on
// helm32's panels, tools/schur_ab.py): the fragments of PTX's mma.m16n8k4
// with .f64 (lane = 4 gid + tig): a[h] = A(gid + 8 h, tig), b = B(tig,
// gid), d[2 h + j] = D(gid + 8 h, 2 tig + j).
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[2],
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

// The geometry of complex128's band kernel: out = A . B, out M x N, A = the
// band and B = D (LEFT = false) or A = D and B = the band (LEFT = true), k
// over BS in stages of KC = 8 complex (a 128-byte row of A). A stage holds
// KC columns of A (rows LDA = KC + 4 complex apart: 192 bytes, so a
// fragment's two rows of four 16-byte elements fall in distinct banks) and
// KC rows of B (LDB = N + 2 apart: 32 mod 128 bytes, so a fragment's four
// rows of two fall in distinct banks). NW warps, WR along the rows of out:
// a warp owns 16 rows and WN tiles of 8 columns, each tile's real and
// imaginary parts (8 WN doubles of accumulator a thread).
template <int BS, bool LEFT, int BM>
struct ZPanel {
  static constexpr int KC = 8;
  static constexpr int STAGES = 3;
  static constexpr int M = LEFT ? BS : BM;
  static constexpr int N = LEFT ? BM : BS;
  static constexpr int LDA = KC + 4;
  static constexpr int LDB = N + 2;
  static constexpr int kA = M * LDA;
  static constexpr int kStage = kA + KC * LDB;   // complex elements
  static constexpr size_t kBytes = (size_t)STAGES * kStage * 16;
  static constexpr int NW = (M / 16) * (N / 8) < 8 ? (M / 16) * (N / 8) : 8;
  static constexpr int NT = 32 * NW;
  static constexpr int WR = M / 16 < NW ? M / 16 : NW;
  static constexpr int WC = NW / WR;
  static constexpr int WN = N / (8 * WC);
  // two CTAs an SM where the accumulators leave the registers for it
  // (WN = 4 spilled 60-132 bytes at their 128 registers a thread)
  static constexpr int kMinBlocks = WN <= 2 ? 2 : 1;
  static_assert(M == 16 * WR && N == 8 * WN * WC && BS % KC == 0,
                "one warp per 16 x 8 WN tile of out");
  static_assert(kBytes * kMinBlocks <= 226 * 1024,
                "shared memory: kMinBlocks CTAs per SM");
};

// acc += A . B over one stage of this warp's 16 x 8 WN tiles (rows r0,
// columns c0 + 8 j) of complex128 from the stage `st` (interleaved real and
// imaginary parts, as cplx.cuh lays them out): per k step of 4, per tile,
// Re += Re A . Re B, Re += (-Im A) . Im B, Im += Re A . Im B, Im += Im A .
// Re B, in that order (the negation is exact, and made once for the WN
// tiles).
template <class Z>
__device__ __forceinline__ void zmul_stage(const double2* st, int r0, int c0,
                                           double (&re)[Z::WN][4],
                                           double (&im)[Z::WN][4]) {
  const int gid = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
  const double2* A = st;
  const double2* B = st + Z::kA;
#pragma unroll
  for (int k = 0; k < Z::KC; k += 4) {
    double ar[2], ai[2], an[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const double2 v = A[(r0 + gid + 8 * h) * Z::LDA + k + tig];
      ar[h] = v.x;
      ai[h] = v.y;
      an[h] = -v.y;
    }
#pragma unroll
    for (int j = 0; j < Z::WN; ++j) {
      const double2 v = B[(k + tig) * Z::LDB + c0 + 8 * j + gid];
      mma_f64(re[j], ar, v.x);
      mma_f64(re[j], an, v.y);
      mma_f64(im[j], ar, v.y);
      mma_f64(im[j], ai, v.x);
    }
  }
}

// One CTA's band of a complex128 panel slots[blockIdx.x] (the band
// blockIdx.y), as band_inverse: both operands through a cp.async ring of
// STAGES stages, the band written from registers once its last copy has
// landed.
template <int BS, bool LEFT, int BM>
__device__ __forceinline__ void zband_inverse(
    cplx<double>* pool, const cplx<double>* __restrict__ dinv,
    const int32_t* __restrict__ slots, const int32_t* __restrict__ steps) {
  using Z = ZPanel<BS, LEFT, BM>;
  constexpr int ST = Z::STAGES, NK = BS / Z::KC;
  extern __shared__ float4 smem4[];
  double2* ring = reinterpret_cast<double2*>(smem4);
  const int64_t bb = (int64_t)BS * BS;
  const int64_t band = blockIdx.y;
  // element (r, q) of the band is X[r * BS + q]
  cplx<double>* X = pool + (int64_t)slots[blockIdx.x] * bb +
                    (LEFT ? band * BM : band * BM * BS);
  const cplx<double>* D = dinv + (int64_t)steps[blockIdx.x] * bb;
  const cplx<double>* Ag = LEFT ? D : X;
  const cplx<double>* Bg = LEFT ? X : D;
  auto stage = [&](int c) {
    double2* st = ring + (c % ST) * Z::kStage;
    const int k0 = c * Z::KC;
    for (int e = threadIdx.x; e < Z::M * Z::KC; e += Z::NT) {
      const int r = e / Z::KC, q = e % Z::KC;
      cp_async16(st + r * Z::LDA + q, Ag + (int64_t)r * BS + k0 + q);
    }
    for (int e = threadIdx.x; e < Z::KC * Z::N; e += Z::NT) {
      const int r = e / Z::N, q = e % Z::N;
      cp_async16(st + Z::kA + r * Z::LDB + q,
                 Bg + (int64_t)(k0 + r) * BS + q);
    }
  };
#pragma unroll
  for (int c = 0; c < ST - 1; ++c) {
    if (c < NK) stage(c);
    cp_async_commit();
  }
  const int warp = threadIdx.x >> 5;
  const int r0 = (warp / Z::WC) * 16;
  const int c0 = (warp % Z::WC) * 8 * Z::WN;
  double re[Z::WN][4], im[Z::WN][4];
#pragma unroll
  for (int j = 0; j < Z::WN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) re[j][e] = im[j][e] = 0.0;
  for (int c = 0; c < NK; ++c) {
    cp_async_wait<ST - 2>();   // chunk c has landed
    __syncthreads();           // ... for every thread; stage c-1 is free
    if (c + ST - 1 < NK) stage(c + ST - 1);
    cp_async_commit();
    zmul_stage<Z>(ring + (c % ST) * Z::kStage, r0, c0, re, im);
  }
  // every read of the band was a copy that has landed (the last wait);
  // only now is it written
  const int gid = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
  double2* Xo = reinterpret_cast<double2*>(X);
#pragma unroll
  for (int j = 0; j < Z::WN; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int t = 0; t < 2; ++t)
        Xo[(int64_t)(r0 + gid + 8 * h) * BS + c0 + 8 * j + 2 * tig + t] =
            make_double2(re[j][2 * h + t], im[j][2 * h + t]);
}

template <int BS, bool LEFT, int BM>
__global__ void __launch_bounds__(ZPanel<BS, LEFT, BM>::NT,
                                  ZPanel<BS, LEFT, BM>::kMinBlocks)
zband_times_inverse(cplx<double>* pool,
                    const cplx<double>* __restrict__ dinv,
                    const int32_t* __restrict__ slots,
                    const int32_t* __restrict__ steps) {
  zband_inverse<BS, LEFT, BM>(pool, dinv, slots, steps);
}

template <int BS, bool LEFT, int BM>
__global__ void __launch_bounds__(ZPanel<BS, LEFT, BM>::NT,
                                  ZPanel<BS, LEFT, BM>::kMinBlocks)
zband_times_inverse_batch(cplx<double>* pool,
                          const cplx<double>* __restrict__ dinv,
                          const int32_t* __restrict__ slots,
                          const int32_t* __restrict__ steps,
                          int64_t pool_stride, int64_t inv_stride) {
  const int64_t m = blockIdx.z;
  zband_inverse<BS, LEFT, BM>(pool + m * pool_stride,
                              dinv + m * inv_stride, slots, steps);
}

template <int BS, bool LEFT, int BM>
int zlaunch_bm(void* pool, const void* dinv, const void* slots,
               const void* steps, int count, cudaStream_t stream,
               const Members& mb) {
  using Z = ZPanel<BS, LEFT, BM>;
  using C = cplx<double>;
  if (mb.count == 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        zband_times_inverse<BS, LEFT, BM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Z::kBytes);
    if (e != cudaSuccess) return (int)e;
    zband_times_inverse<BS, LEFT, BM>
        <<<dim3((unsigned)count, BS / BM), Z::NT, Z::kBytes, stream>>>(
            (C*)pool, (const C*)dinv, (const int32_t*)slots,
            (const int32_t*)steps);
  } else {
    const cudaError_t e = cudaFuncSetAttribute(
        zband_times_inverse_batch<BS, LEFT, BM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Z::kBytes);
    if (e != cudaSuccess) return (int)e;
    zband_times_inverse_batch<BS, LEFT, BM>
        <<<dim3((unsigned)count, BS / BM, (unsigned)mb.count), Z::NT,
           Z::kBytes, stream>>>((C*)pool, (const C*)dinv,
                                (const int32_t*)slots, (const int32_t*)steps,
                                mb.pool_stride, mb.inv_stride);
  }
  return (int)cudaGetLastError();
}

// complex128's bands: 64 rows (columns) at bs = 128 (one CTA an SM, 128
// doubles of accumulator a thread), 32 at bs 64 and 32, or 16 where those
// would give the card fewer CTAs than SMs; chosen from `count`, one
// member's panels, as launch_bs chooses.
template <int BS, bool LEFT>
int zlaunch_bs(void* pool, const void* dinv, const void* slots,
               const void* steps, int count, cudaStream_t stream,
               const Members& mb) {
  constexpr int WIDE = BS == 128 ? 64 : 32;
  if ((int64_t)count * (BS / WIDE) < sm_count())
    return zlaunch_bm<BS, LEFT, 16>(pool, dinv, slots, steps, count, stream,
                                    mb);
  return zlaunch_bm<BS, LEFT, WIDE>(pool, dinv, slots, steps, count, stream,
                                    mb);
}

template <typename T, bool LEFT>
int launch_left(void* pool, const void* dinv, const void* slots,
                const void* steps, int count, int bs, cudaStream_t stream,
                const Members& mb) {
  if constexpr (sizeof(T) == 16) {
    switch (bs) {
      case 32: return zlaunch_bs<32, LEFT>(pool, dinv, slots, steps, count,
                                           stream, mb);
      case 64: return zlaunch_bs<64, LEFT>(pool, dinv, slots, steps, count,
                                           stream, mb);
      case 128: return zlaunch_bs<128, LEFT>(pool, dinv, slots, steps,
                                             count, stream, mb);
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (bs) {
      case 32: return launch_bs<T, 32, LEFT>(pool, dinv, slots, steps, count,
                                             stream, mb);
      case 64: return launch_bs<T, 64, LEFT>(pool, dinv, slots, steps, count,
                                             stream, mb);
      case 128: return launch_bs<T, 128, LEFT>(pool, dinv, slots, steps,
                                               count, stream, mb);
      default: return (int)cudaErrorInvalidValue;
    }
  }
}

// The panel TRSM over `count` (slot, step) pairs (int32 device arrays):
// X <- X . dinv[step] (left = 0) or dinv[step] . X (left != 0). Returns
// the cudaError_t of the launch (a refused launch never runs). With
// mb.count > 0 the same over mb.count members of a stacked pool
// (gridDim.z, at most 65,535). complex128 runs zband_times_inverse.
template <typename T>
int trsm(void* pool, const void* dinv, const void* slots, const void* steps,
         int count, int bs, int left, void* stream, const Members& mb = {}) {
  if (mb.count < 0 || mb.count > 65535) return (int)cudaErrorInvalidValue;
  if (count == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return left ? launch_left<T, true>(pool, dinv, slots, steps, count, bs, s,
                                     mb)
              : launch_left<T, false>(pool, dinv, slots, steps, count, bs, s,
                                      mb);
}

// ---------------------------------------------------------------------------
// clk's L-part TRSM in the bf16 pass
// ---------------------------------------------------------------------------

// The geometry of the bf16 TRSM, X <- X . D on one band of an L panel: D
// rounded to bf16 once in shared memory (BS rows of LDD bf16, rows an odd
// multiple of 16 bytes apart for ldmatrix), the band of BM rows streamed
// through a cp.async ring of STAGES stages of KC columns (rows LDA = KC +
// 8 floats apart: 8 mod 32 words, so the float2 pairs of an A fragment's
// rows fall in distinct banks). NW warps, WR along the rows: a warp owns
// WM x WN tiles of 16 x 8 (2 x 8 at BM = BS = 128: 64 floats of
// accumulator a thread).
template <int BS, int BM>
struct TrsmMma {
  static constexpr int KC = 32;
  static constexpr int NK = BS / KC;
  static constexpr int STAGES = 3;
  static constexpr int LDA = KC + 8;
  static constexpr int LDD = BS + 8;
  static constexpr int kStage = BM * LDA;   // floats
  static constexpr size_t kDBytes = (size_t)BS * LDD * 2;
  static constexpr size_t kBytes =
      kDBytes + (size_t)STAGES * kStage * sizeof(float);
  static constexpr int NW = (BM / 16) * (BS / 8) < 8 ? (BM / 16) * (BS / 8)
                                                     : 8;
  static constexpr int NT = 32 * NW;
  static constexpr int WR = BM / 16 < 4 ? BM / 16 : 4;
  static constexpr int WC = NW / WR;
  static constexpr int WM = BM / (16 * WR);
  static constexpr int WN = BS / (8 * WC);
  // D's pieces of 8 floats, and a thread's share of them
  static constexpr int kD8 = BS * BS / 8;
  static constexpr int kDLoads = (kD8 + NT - 1) / NT;
  static_assert(BS % KC == 0 && BM == 16 * WM * WR && BS == 8 * WN * WC &&
                    (WN == 1 || WN % 2 == 0) && kDBytes % 16 == 0,
                "one warp per 16 WM x 8 WN tile of the band");
  static_assert(kBytes <= 113 * 1024, "shared memory: two CTAs per SM");
};

// One CTA: band blockIdx.y of BM rows of the panel slots[blockIdx.x], X <-
// X . D with D = dinv[steps[blockIdx.x]]. Each output sums its BS k in ascending steps of 16,
// each by one m16n8k16 (the FP32 accumulator from 0), so it holds what
// PanelMma's tiles gave, bit for bit. The launch may start early
// (programmatic dependent launch): the CTAs may become resident while the
// grid before them drains, and wait in griddepcontrol.wait, before any
// read, until it has completed and its writes are visible.
template <int BS, int BM>
__global__ void __launch_bounds__(TrsmMma<BS, BM>::NT, 2)
trsm_mma_kernel(float* pool, const float* __restrict__ dinv,
                const int32_t* __restrict__ slots,
                const int32_t* __restrict__ steps) {
  using Q = TrsmMma<BS, BM>;
  constexpr int ST = Q::STAGES, NK = Q::NK;
  extern __shared__ float4 smem4[];
  uint16_t* Ds = reinterpret_cast<uint16_t*>(smem4);
  float* ring = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem4) + Q::kDBytes);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int64_t bb = (int64_t)BS * BS;
  float* X = pool + (int64_t)slots[blockIdx.x] * bb +
             (int64_t)blockIdx.y * BM * BS;
  // chunk q: columns q KC .. of the band
  auto stage = [&](int q) {
    const float* Xg = X + q * Q::KC;
    float* st = ring + (q % ST) * Q::kStage;
    for (int e = threadIdx.x; e < BM * (Q::KC / 4); e += Q::NT) {
      const int r = e / (Q::KC / 4), c = (e % (Q::KC / 4)) * 4;
      cp_async16(st + r * Q::LDA + c, Xg + (int64_t)r * BS + c);
    }
  };
#pragma unroll
  for (int q = 0; q < ST - 1; ++q) {
    if (q < NK) stage(q);
    cp_async_commit();
  }
  // D in bf16, rounded to nearest even as slu_mma::pack_bf16 rounds: every
  // load issued before the first store, so that the staging waits on one
  // round trip, not on one per row
  const float* D = dinv + (int64_t)steps[blockIdx.x] * bb;
  float4 dv[Q::kDLoads][2];
#pragma unroll
  for (int t = 0; t < Q::kDLoads; ++t) {
    const int e = threadIdx.x + t * Q::NT;
    if (Q::kD8 % Q::NT != 0 && e >= Q::kD8) break;
    const float* p = D + (e / (BS / 8)) * BS + (e % (BS / 8)) * 8;
    dv[t][0] = __ldg(reinterpret_cast<const float4*>(p));
    dv[t][1] = __ldg(reinterpret_cast<const float4*>(p + 4));
  }
#pragma unroll
  for (int t = 0; t < Q::kDLoads; ++t) {
    const int e = threadIdx.x + t * Q::NT;
    if (Q::kD8 % Q::NT != 0 && e >= Q::kD8) break;
    const float4 u = dv[t][0], v = dv[t][1];
    *reinterpret_cast<uint4*>(Ds + (e / (BS / 8)) * Q::LDD +
                              (e % (BS / 8)) * 8) =
        make_uint4(slu_mma::pack_bf16(u.x, u.y), slu_mma::pack_bf16(u.z, u.w),
                   slu_mma::pack_bf16(v.x, v.y), slu_mma::pack_bf16(v.z, v.w));
  }
  const int warp = threadIdx.x >> 5;
  const int r0 = (warp / Q::WC) * 16 * Q::WM;
  const int c0 = (warp % Q::WC) * 8 * Q::WN;
  float acc[Q::WM][Q::WN][4];
#pragma unroll
  for (int i = 0; i < Q::WM; ++i)
#pragma unroll
    for (int j = 0; j < Q::WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int q = 0; q < NK; ++q) {
    cp_async_wait<ST - 2>();   // chunk q has landed
    __syncthreads();           // ... for every thread (and D); q-1 is free
    if (q + ST - 1 < NK) stage(q + ST - 1);
    cp_async_commit();
    const float* A = ring + (q % ST) * Q::kStage;
    const int k0 = q * Q::KC;
#pragma unroll
    for (int k = 0; k < Q::KC; k += 16) {
      uint32_t a[Q::WM][4];
#pragma unroll
      for (int i = 0; i < Q::WM; ++i)
        slu_mma::frag_a<Q::LDA>(A, r0 + 16 * i, k, a[i]);
      if constexpr (Q::WN == 1) {
        uint32_t b[2];
        slu_mma::frag_b1_bf16<Q::LDD>(Ds, k0 + k, c0, b);
#pragma unroll
        for (int i = 0; i < Q::WM; ++i) slu_mma::mma_bf16(acc[i][0], a[i], b);
      } else {
#pragma unroll
        for (int j = 0; j < Q::WN; j += 2) {
          uint32_t b[4];
          slu_mma::frag_b2_bf16<Q::LDD>(Ds, k0 + k, c0 + 8 * j, b);
          const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
#pragma unroll
          for (int i = 0; i < Q::WM; ++i) {
            slu_mma::mma_bf16(acc[i][j], a[i], b0);
            slu_mma::mma_bf16(acc[i][j + 1], a[i], b1);
          }
        }
      }
    }
  }
  // every read of the band was a copy that has landed (the last wait, for
  // every thread): only now is it written
#pragma unroll
  for (int i = 0; i < Q::WM; ++i)
#pragma unroll
    for (int j = 0; j < Q::WN; ++j)
      slu_mma::store_c<BS>(X, r0 + 16 * i, c0 + 8 * j, acc[i][j]);
}

template <int BS, int BM>
int launch_trsm_mma(void* pool, const void* dinv, const void* slots,
                    const void* steps, int count, cudaStream_t stream) {
  using Q = TrsmMma<BS, BM>;
  const cudaError_t e = cudaFuncSetAttribute(
      trsm_mma_kernel<BS, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Q::kBytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)count, BS / BM);
  cfg.blockDim = dim3(Q::NT);
  cfg.dynamicSmemBytes = Q::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, trsm_mma_kernel<BS, BM>,
                                 (float*)pool, (const float*)dinv,
                                 (const int32_t*)slots,
                                 (const int32_t*)steps);
}

// The widest band (BM = BS, BS / 2, .., 16 rows) whose CTAs, count a
// band, still give every SM one (T, float, defers the instantiation to
// trsm_bf16's).
template <typename T, int BS, int BM = BS>
int launch_trsm_bands(void* pool, const void* dinv, const void* slots,
                      const void* steps, int count, cudaStream_t stream) {
  if constexpr (BM > 16) {
    if ((int64_t)count * (BS / BM) < sm_count())
      return launch_trsm_bands<T, BS, BM / 2>(pool, dinv, slots, steps,
                                              count, stream);
  }
  return launch_trsm_mma<BS, BM>(pool, dinv, slots, steps, count, stream);
}

// clk's L-part TRSM in the bf16 pass over `count` (slot, step) pairs of
// one level (int32 device arrays). Returns the cudaError_t of the launch.
// (A template, so that only the source that calls it, clk.cu, compiles
// its kernels.)
template <typename T = float>
int trsm_bf16(void* pool, const void* dinv, const void* slots,
              const void* steps, int count, int bs, void* stream) {
  static_assert(sizeof(T) == sizeof(float), "the bf16 pass is float's");
  if (count == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (bs) {
    case 32: return launch_trsm_bands<T, 32>(pool, dinv, slots, steps,
                                             count, s);
    case 64: return launch_trsm_bands<T, 64>(pool, dinv, slots, steps,
                                             count, s);
    case 128: return launch_trsm_bands<T, 128>(pool, dinv, slots, steps,
                                               count, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace slu_panel
