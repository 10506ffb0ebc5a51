// chain.cuh: the staged chain product, shared by flk.cu (`flk`, through
// passes.cuh),
// schur.cu (`schur`, in float and double) and rdma.cu (`rdma_schur`, and
// the launch geometry of `rdma_panel`); schur_band is the Schur update's
// body that `schur` and `rdma_schur` share.
//
// What it computes, for one target block T (bs x bs) and its list of
// products p < np, each A_p . B_p of two bs x bs blocks:
//   T <- T - sum over p of A_p . B_p      in list order, then optionally
//   FIN_U: T <- inv . T                   (a U panel, inv = linv[step])
//   FIN_L: T <- T . inv                   (an L panel, inv = uinv[step])
// and leaves the result in registers for the caller's store.
//
// Ownership (panel.cuh's rule). T . inv mixes the columns of a row of T,
// and inv . T the rows of a column; so a CTA owns a band of BM whole rows
// of T (FIN_L) or of BM whole columns (FIN_NONE, FIN_U), and every output
// element of its band depends only on that band of T, on the products'
// matching bands and on inv. The caller loads the band into registers and
// stores it once at the end; no other CTA touches it, and no block that a
// launch reads is written in that launch (sources and inverses belong to
// lower elimination levels or earlier launches). No atomics: each output
// element sums its products in list order and each product's k in
// ascending order, so a result repeats bit for bit.
//
// Design. The chain is one stream of KC-wide chunks, np * (bs / KC) of
// them, then bs / KC more for the finalize. Both operands of a product
// chunk (KC columns of A_p's band rows, the matching KC rows of B_p's band
// columns) go through a cp.async ring of ST stages (panel.cuh's
// stage_chunk, padded A rows), so while the CTA multiplies one chunk the
// next ST - 1 are in flight, across product boundaries: a chained product
// never waits on L2. Each product is summed into `prod` and subtracted
// from the band (acc -= prod), as the plain version's T - L . U rounds.
// When the last product is done, each thread writes its share of the band
// into shared memory (`fin`, padded rows for a row band); the finalize's
// chunks stage only the inverse and take the band from there. Each thread
// owns a 4 x TN tile (panel.cuh's mul_chunk, IEEE FMA in T on the CUDA
// cores, no TF32). Geometry (by_geometry): at bs >= 64, bands of 64 with
// 4 x 8 tiles when a launch's bands of 64 fill the card's SMs, else bands
// of 16 with 4 x 4 tiles, so that a launch of few targets spreads over
// more CTAs and each thread's chain of FMAs is a quarter as long; bs = 32
// takes the whole block. A shared-memory budget of two CTAs per SM fixes
// ST: 3 stages for bands of 64 with a finalize, 4 otherwise.
//
// double (schur.cu's float64 `schur`): the same bands and tiles, but a 4
// x 8 tile of doubles holds acc and prod in 128 registers, and with the
// chunk's k loop unrolled whole ptxas needs more than 255 a thread and
// spills (8 bytes at every block size; unrolled by 2 or 4 steps, 12 and
// 44 bytes). Rolled (UK = 1) it takes 248 registers and spills none, so
// double takes that. On an H100 80GB HBM3 at 700 W (lap3d32, float64,
// tools/schur_ab.py) it ran 9.54-9.57 ms per factor against 8.79-8.82
// unrolled (with the spill) and 9.82-9.91 for 4 x 4 tiles in bands of 16
// everywhere; 4 x 4 tiles in bands of 32 took 10.60 and in bands of 64
// (512 threads, at most 128 registers) spilled 56 bytes. Two CTAs fit an
// SM's shared memory, one its registers.
//
// complex (schur.cu's complex64 and complex128 `schur`; cplx.cuh's element
// type, each complex FMA four real ones in a fixed order, so a factor
// repeats bit for bit). complex64 is 8 bytes an element as double, so it
// takes double's geometry and its rolled k loop (a 4 x 8 tile of it holds
// acc and prod in 128 registers, as double's does). complex128 would need
// 256 registers for a 4 x 8 tile's acc and prod alone, so it takes bands
// of 16 with 4 x 4 tiles (128 registers for acc and prod, 128 threads a
// CTA) at every block size and launch, whatever `wide` asks, its k loop
// rolled (unrolled whole it spilled 60 bytes).
//
// The bf16 pass of this product (ChainMma, chain_band_mma: the products
// and the finalize on the tensor cores) lives in passes.cuh, on these
// geometries.
//
// Offsets are computed in 64 bits (slot * bs^2 passes 2^31 near n = 885k).

#pragma once

#include "panel.cuh"

namespace slu_chain {

using slu_panel::cp_async_commit;
using slu_panel::cp_async_wait;
using slu_panel::load_tile;
using slu_panel::mul_chunk;
using slu_panel::Panel;
using slu_panel::stage_chunk;
using slu_panel::store_tile;

// finalize codes, the values of the JAX package's flk.py
constexpr int FIN_NONE = 0;
constexpr int FIN_L = 2;
constexpr int FIN_U = 3;

// The geometry of one launch: bands of BM whole columns (Band<true>) or
// rows (Band<false>) of a BS x BS block, a 4 x TN tile per thread, a ring
// of ST stages sized for either orientation, (FIN) room for the band as
// the finalize's operand, and the unroll of a chunk's k loop (UK_ steps
// of W; 0 unrolls it whole).
template <typename T, int BS_, int BM_, int TN, int ST, bool FIN,
          int UK_ = 0>
struct Chain {
  template <bool LEFT>
  using Band = Panel<T, BS_, LEFT, BM_, TN>;
  static constexpr int UK = UK_ > 0 ? UK_ : Band<true>::KC / Band<true>::W;
  static constexpr int BS = BS_;
  static constexpr int BM = BM_;
  static constexpr int BANDS = BS / BM;
  static constexpr int STAGES = ST;
  static constexpr bool HAS_FIN = FIN;
  static constexpr int NT = Band<true>::NT;
  static constexpr int kStage = Band<true>::kStage > Band<false>::kStage
                                    ? Band<true>::kStage
                                    : Band<false>::kStage;
  static constexpr int LDF = BS + Band<true>::W;   // padded row band row
  static constexpr int kFin =
      !FIN ? 0 : (BS * BM > BM * LDF ? BS * BM : BM * LDF);
  static constexpr size_t kBytes = (size_t)(ST * kStage + kFin) * sizeof(T);
  static_assert(kBytes <= 113 * 1024, "shared memory: two CTAs per SM");
};

// The chain product of one band, as described at the top of this file.
// `smem` holds G::kBytes; acc holds this thread's tile of the band (rows
// g + i * RS, columns c0 + j * CS of Band<LEFT>) as loaded by the caller;
// src(p, Ag, Bg) sets product p's operands, offset to the band (element
// (r, k) of A at Ag[r * BS + k], (k, q) of B at Bg[k * BS + q]); `inv`,
// unless null, is the whole inverse of the finalize (LEFT: inv . band,
// else band . inv). Every thread of the CTA calls it. A kernel that picks
// the orientation per CTA calls it from one function per orientation,
// not inlined (flk.cu says why).
template <class G, bool LEFT, typename T, typename Src>
__device__ __forceinline__ void chain_band(
    T* smem, int np, const T* inv, Src src, int g, int c0,
    T (&acc)[4][G::template Band<LEFT>::TW]) {
  using P = typename G::template Band<LEFT>;
  constexpr int ST = G::STAGES, KC = P::KC, TN = P::TW;
  constexpr int NK = G::BS / KC;   // chunks per product
  T* fin = smem + ST * G::kStage;
  const bool has_fin = G::HAS_FIN && inv != nullptr;
  const int nchunks = (np + (has_fin ? 1 : 0)) * NK;

  // the band as the finalize's operand: B (LEFT, BS x BM) or A (BM x BS,
  // rows padded to LDF)
  auto put_fin = [&]() {
    if constexpr (G::HAS_FIN) {
      if (LEFT)
        store_tile<P, P::N>(fin, g, c0, acc);
      else
        store_tile<P, G::LDF>(fin, g, c0, acc);
    }
  };
  auto load = [&](int c) {
    const int p = c / NK;
    const T* Ag = LEFT ? inv : nullptr;
    const T* Bg = LEFT ? nullptr : inv;
    if (p < np) src(p, Ag, Bg);
    stage_chunk<P>(smem + (c % ST) * G::kStage, Ag, Bg, (c % NK) * KC);
  };

  if (has_fin && np == 0) put_fin();   // read after the first barrier
#pragma unroll
  for (int c = 0; c < ST - 1; ++c) {
    if (c < nchunks) load(c);
    cp_async_commit();
  }
  T prod[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) prod[i][j] = T(0);
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<ST - 2>();   // chunk c has landed
    __syncthreads();           // ... for every thread; stage c-1 is free
    if (c + ST - 1 < nchunks) load(c + ST - 1);
    cp_async_commit();
    const int p = c / NK;
    const T* st = smem + (c % ST) * G::kStage;
    if (p < np) {
      mul_chunk<P, P::LDA, P::N, G::UK>(st, st + P::kA, g, c0, prod);
    } else if constexpr (G::HAS_FIN) {
      const int k0 = (c % NK) * KC;
      if (LEFT)
        mul_chunk<P, P::LDA, P::N, G::UK>(st, fin + k0 * P::N, g, c0,
                                          prod);
      else
        mul_chunk<P, G::LDF, P::N, G::UK>(fin + k0, st + P::kA, g, c0,
                                          prod);
    }
    if (c % NK == NK - 1) {   // product p (or the finalize) is complete
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = p < np ? acc[i][j] - prod[i][j] : prod[i][j];
          prod[i][j] = T(0);
        }
      if (has_fin && p == np - 1) put_fin();   // read after the next barrier
    }
  }
}

// The Schur update of one (target, band of BM whole columns), the body of
// schur.cu's `schur` and rdma.cu's `rdma_schur`:
//   X <- X - sum over p in [p0, p1) of Lb[cl[p]] . Ub[cu[p]]
// in list order, with X the target block and Lb / Ub arrays of bs x bs
// blocks (the pool itself, or a rank's broadcast buffers). The band is
// blockIdx.y; it is loaded once and stored once. No target is a source of
// the same launch, so X may lie in the array that Lb and Ub point into.
template <class G, typename T>
__device__ __forceinline__ void schur_band(T* X, const T* Lb, const T* Ub,
                                           const int32_t* __restrict__ cl,
                                           const int32_t* __restrict__ cu,
                                           int p0, int p1) {
  using P = typename G::template Band<true>;
  extern __shared__ float4 smem4[];
  const int g = threadIdx.x / P::CT;
  const int c0 = (threadIdx.x % P::CT) * P::W;
  constexpr int64_t bb = (int64_t)G::BS * G::BS;
  const int64_t off = (int64_t)blockIdx.y * G::BM;
  X += off;
  Ub += off;
  cl += p0;
  cu += p0;
  T acc[4][P::TW];
  load_tile<P, G::BS>(X, g, c0, acc);
  chain_band<G, true>(
      reinterpret_cast<T*>(smem4), p1 - p0, static_cast<const T*>(nullptr),
      [&](int p, const T*& Ag, const T*& Bg) {
        Ag = Lb + cl[p] * bb;
        Bg = Ub + cu[p] * bb;
      },
      g, c0, acc);
  store_tile<P, G::BS>(X, g, c0, acc);
}

// Launch `kernel` over count x G::BANDS CTAs of G::NT threads with
// G::kBytes of dynamic shared memory; returns the cudaError_t.
template <class G, typename... KArgs, typename... Args>
int launch(void (*kernel)(KArgs...), int count, cudaStream_t stream,
           Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kBytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((unsigned)count, G::BANDS), G::NT, G::kBytes, stream>>>(
      args...);
  return (int)cudaGetLastError();
}

// go(Chain<...>{}) for the geometry of a launch of `count` targets at
// block size bs: `wide` < 0 chooses by the rule at the top of this file,
// 0 forces bands of 16, 1 bands of 64 (bs = 32: the whole block always);
// double's and complex64's 4 x 8 tile keeps its chunk's k loop rolled, and
// complex128 takes bands of 16 with 4 x 4 tiles always (the top of this
// file says why).
template <typename T, bool FIN, typename Go>
int by_geometry(int bs, int count, int wide, Go go) {
  constexpr int STW = FIN ? 3 : 4;   // stages for bands of 64
  auto narrow = [&](int b) {
    return wide < 0 ? (int64_t)count * (b / 64) < slu_panel::sm_count()
                    : wide == 0;
  };
  constexpr int UK = sizeof(T) == 8 ? 1 : 0;   // 8-byte 4 x 8 tiles
  if constexpr (sizeof(T) == 16) {
    switch (bs) {
      case 32: return go(Chain<T, 32, 16, 4, 4, FIN, 1>{});
      case 64: return go(Chain<T, 64, 16, 4, 4, FIN, 1>{});
      case 128: return go(Chain<T, 128, 16, 4, 4, FIN, 1>{});
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (bs) {
      case 32: return go(Chain<T, 32, 32, 8, 4, FIN, UK>{});
      case 64:
        return narrow(64) ? go(Chain<T, 64, 16, 4, 4, FIN>{})
                          : go(Chain<T, 64, 64, 8, STW, FIN, UK>{});
      case 128:
        return narrow(128) ? go(Chain<T, 128, 16, 4, 4, FIN>{})
                           : go(Chain<T, 128, 64, 8, STW, FIN, UK>{});
      default: return (int)cudaErrorInvalidValue;
    }
  }
}

}  // namespace slu_chain
