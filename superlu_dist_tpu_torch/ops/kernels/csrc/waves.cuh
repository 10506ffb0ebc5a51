// waves.cuh: staged block-times-strip products, and the left-looking
// update in source-ready waves, shared by clk.cu (clk_update) and tck.cu
// (tck_update's phase A, and the ring of its phase B).
//
// The update in waves (clk.py::build_clk_tapes, or tck.py's phase-A tapes
// from the same _waves): a U block without sources is final in wave
// f = 0, one with sources in wave f(i) = 1 + max f(j), and the product
// L(i',j) . U(j,k) is applied in wave f(j) + 1. One launch per wave
// (issued in a loop by waves_f32 from the host array of wave pointers),
// one CTA per (target, strip of TN scalar columns). A CTA loads its strip
// into registers once, subtracts the wave's products of its target in
// list order (ascending j), applies linv(i) if the target's sum is then
// complete (FIN_U), and stores the strip once. No atomics, and a fixed
// order: a target's sum runs by source wave, then ascending j. Every
// source U block of a wave was final in an earlier wave and every L block
// belongs to a lower level, so nothing that a launch reads is written in
// it.
//
// The operands stream through shared memory by asynchronous copies
// (cp.async, a ring of STAGES chunks): a chunk is KC columns of the L
// block (bs x KC, rows padded to LD floats so that the eight rows a warp
// reads at once fall in distinct banks) and the matching KC rows of the U
// strip; while the CTA multiplies one chunk, the next STAGES - 1 are in
// flight, so the chain of products on one CTA does not wait on L2
// latency. Each of (bs/4)(TN/4) threads owns a 4x4 tile of the strip:
// rows g, g + bs/4, g + bs/2, g + 3bs/4 (g = tid / (TN/4)) and 4
// consecutive columns. The arithmetic is IEEE FP32 FMA on the CUDA cores
// (no TF32). Offsets are computed in 64 bits (slot * bs^2 passes 2^31
// near n = 885k).
//
// The bf16 pass (wave_kernel<..., BF16 = true>, clk's gemm_precision
// "default"): the same ring, order and finalize, every product (the
// finalize by linv included) on the tensor cores through mma.cuh's
// m16n8k16 bf16 tiles with float32 accumulation. Warp w owns rows 32w ..
// 32w + 31 of the strip (two m16 tiles by both n8 tiles of TN = 16, in
// the C layout); the staged U chunks and the finalize operand keep rows of
// TN + 4 floats, so that a B fragment's four k rows fall in distinct
// banks. Operands are rounded to bf16 as their fragments are built from
// the float32 chunks; the sums, the pool and the finalize operand stay
// float32. BF16 = false compiles to the FP32 kernel above, unchanged.

#pragma once

#include "chain.cuh"
#include "mma.cuh"

namespace slu_waves {

using slu_panel::cp_async16;
using slu_panel::cp_async_commit;
using slu_panel::cp_async_wait;
using slu_panel::Vec16;

constexpr int KC = 32;                  // k per staged chunk
constexpr int LD = KC + 4;              // padded row of a staged L chunk
constexpr int STAGES = 3;               // chunks in the cp.async ring

// a ring of ST staged chunks for strips of TN columns at block size BS,
// the U chunk's rows UL floats apart
template <int BS, int TN, int ST = STAGES, int UL = TN>
struct Ring {
  static constexpr int kThreads = (BS / 4) * (TN / 4);   // a 4x4 tile each
  static constexpr int kL = BS * LD;              // staged L chunk (floats)
  static constexpr int kStage = kL + KC * UL;     // + the U chunk
  static constexpr int kFloats = ST * kStage;
  static constexpr int NK = BS / KC;              // chunks per product
  static constexpr int RS = BS / 4;               // row stride of a thread
};

// Stage chunk k0 of one product into `st`: columns k0 .. k0+KC of the
// bs x bs block L, and, unless U is null, rows k0 .. k0+KC of the strip U
// (leading dimension BS; staged rows UL floats apart). Every thread of the
// CTA issues its copies.
template <int BS, int TN, int UL = TN>
__device__ __forceinline__ void stage(float* st, const float* L,
                                      const float* U, int k0) {
  constexpr int NT = Ring<BS, TN>::kThreads;
  const int tid = threadIdx.x;
  for (int e = tid; e < BS * (KC / 4); e += NT) {
    const int r = e / (KC / 4), q = (e % (KC / 4)) * 4;
    cp_async16(st + r * LD + q, L + (int64_t)r * BS + k0 + q);
  }
  if (U != nullptr) {
    float* us = st + Ring<BS, TN>::kL;
    for (int e = tid; e < KC * (TN / 4); e += NT) {
      const int r = e / (TN / 4), q = (e % (TN / 4)) * 4;
      cp_async16(us + r * UL + q, U + (int64_t)(k0 + r) * BS + q);
    }
  }
}

// prod += the staged L chunk Ls (this thread's 4 rows) times the KC x TN
// operand Bs (this thread's 4 columns c0 ..)
template <int BS, int TN>
__device__ __forceinline__ void mul_chunk(const float* Ls, const float* Bs,
                                          int g, int c0,
                                          float (&prod)[4][4]) {
  constexpr int RS = Ring<BS, TN>::RS;
#pragma unroll
  for (int kk = 0; kk < KC; kk += 4) {
    float a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      Vec16<float>::ld(Ls + (g + i * RS) * LD + kk, a[i]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float b[4];
      Vec16<float>::ld(Bs + (kk + u) * TN + c0, b);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) prod[i][j] += a[i][u] * b[j];
    }
  }
}

// the ring, then the finalize operand (the target strip, BS x TN, rows UL
// floats apart)
template <int BS, int TN, int UL = TN>
constexpr size_t wave_smem_bytes() {
  return (size_t)(Ring<BS, TN, STAGES, UL>::kFloats + BS * UL) *
         sizeof(float);
}

// the staged rows of the U chunks and the finalize operand in the bf16 pass
template <int TN>
constexpr int kMmaUL = TN + 4;

// The bf16 pass of wave_kernel (the header says how it is laid out).
template <int BS, int TN>
__device__ __forceinline__ void wave_mma(float* __restrict__ pool,
                                         const float* __restrict__ linv,
                                         const int32_t* __restrict__ tslot,
                                         const int32_t* __restrict__ tstep,
                                         const int32_t* __restrict__ tfin,
                                         const int32_t* __restrict__ pptr,
                                         const int32_t* __restrict__ cl,
                                         const int32_t* __restrict__ cu,
                                         int t0) {
  constexpr int UL = kMmaUL<TN>;
  using S = Ring<BS, TN, STAGES, UL>;
  static_assert(TN == 16 && S::kThreads == BS,
                "a warp per 32 rows of a strip of 16 columns");
  constexpr int NK = S::NK;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* fstrip = smem + S::kFloats;
  const int t = t0 + blockIdx.x;
  const int s0 = blockIdx.y * TN;
  const int r0 = (threadIdx.x >> 5) * 32;
  const int64_t bb = (int64_t)BS * BS;
  const int p0 = pptr[t];
  const int np = pptr[t + 1] - p0;
  const bool fin = tfin[t] == slu_chain::FIN_U;
  const float* Linv = linv + (int64_t)tstep[t] * bb;
  const int nchunks = (np + (fin ? 1 : 0)) * NK;
  float* T = pool + (int64_t)tslot[t] * bb + s0;

  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      slu_mma::load_c<BS>(T, r0 + 16 * i, 8 * j, acc[i][j]);
  if (np == 0) {   // a finalize alone: its operand is the stored strip
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        slu_mma::store_c<UL>(fstrip, r0 + 16 * i, 8 * j, acc[i][j]);
  }

  auto load = [&](int c) {
    const int p = c / NK;
    stage<BS, TN, UL>(smem + (c % STAGES) * S::kStage,
                      p < np ? pool + (int64_t)cl[p0 + p] * bb : Linv,
                      p < np ? pool + (int64_t)cu[p0 + p] * bb + s0 : nullptr,
                      (c % NK) * KC);
  };

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nchunks) load(c);
    cp_async_commit();
  }
  float prod[2][2][4] = {};
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();   // chunk c has landed
    __syncthreads();               // ... for every thread; stage c-1 is free
    if (c + STAGES - 1 < nchunks) load(c + STAGES - 1);
    cp_async_commit();
    const int p = c / NK;
    const int k0 = (c % NK) * KC;
    const float* Ls = smem + (c % STAGES) * S::kStage;
    slu_mma::mma_chunk<KC, LD, UL, 2, 2>(
        Ls, p < np ? Ls + S::kL : fstrip + k0 * UL, r0, 0, prod);
    if (c % NK == NK - 1) {   // product p is complete
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][j][e] =
                p < np ? acc[i][j][e] - prod[i][j][e] : prod[i][j][e];
            prod[i][j][e] = 0.f;
          }
      if (fin && p == np - 1) {   // read after the next barrier
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            slu_mma::store_c<UL>(fstrip, r0 + 16 * i, 8 * j, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      slu_mma::store_c<BS>(T, r0 + 16 * i, 8 * j, acc[i][j]);
}

template <int BS, int TN, bool BF16 = false>
__global__ void __launch_bounds__(Ring<BS, TN>::kThreads)
wave_kernel(float* __restrict__ pool, const float* __restrict__ linv,
            const int32_t* __restrict__ tslot,
            const int32_t* __restrict__ tstep,
            const int32_t* __restrict__ tfin,
            const int32_t* __restrict__ pptr,
            const int32_t* __restrict__ cl,
            const int32_t* __restrict__ cu, int t0) {
  if constexpr (BF16) {
    wave_mma<BS, TN>(pool, linv, tslot, tstep, tfin, pptr, cl, cu, t0);
  } else {
    using S = Ring<BS, TN>;
    constexpr int NK = S::NK;
    constexpr int RS = S::RS;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* fstrip = smem + S::kFloats;
    const int t = t0 + blockIdx.x;
    const int s0 = blockIdx.y * TN;
    const int tid = threadIdx.x;
    const int g = tid / (TN / 4);
    const int c0 = (tid % (TN / 4)) * 4;
    const int64_t bb = (int64_t)BS * BS;
    const int p0 = pptr[t];
    const int np = pptr[t + 1] - p0;
    const bool fin = tfin[t] == slu_chain::FIN_U;
    const float* Linv = linv + (int64_t)tstep[t] * bb;
    const int nchunks = (np + (fin ? 1 : 0)) * NK;
    float* T = pool + (int64_t)tslot[t] * bb + s0;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      Vec16<float>::ld(T + (int64_t)(g + i * RS) * BS + c0, acc[i]);
    if (np == 0) {   // a finalize alone: its operand is the stored strip
#pragma unroll
      for (int i = 0; i < 4; ++i)
        Vec16<float>::st(fstrip + (g + i * RS) * TN + c0, acc[i]);
    }

    // stage chunk c: columns k0.. of product p's L block (of linv(i) for the
    // finalize) and rows k0.. of its U strip
    auto load = [&](int c) {
      const int p = c / NK;
      stage<BS, TN>(smem + (c % STAGES) * S::kStage,
                    p < np ? pool + (int64_t)cl[p0 + p] * bb : Linv,
                    p < np ? pool + (int64_t)cu[p0 + p] * bb + s0 : nullptr,
                    (c % NK) * KC);
    };

#pragma unroll
    for (int c = 0; c < STAGES - 1; ++c) {
      if (c < nchunks) load(c);
      cp_async_commit();
    }
    float prod[4][4] = {};
    for (int c = 0; c < nchunks; ++c) {
      cp_async_wait<STAGES - 2>();   // chunk c has landed
      __syncthreads();               // ... for every thread; stage c-1 is free
      if (c + STAGES - 1 < nchunks) load(c + STAGES - 1);
      cp_async_commit();
      const int p = c / NK;
      const int k0 = (c % NK) * KC;
      const float* Ls = smem + (c % STAGES) * S::kStage;
      mul_chunk<BS, TN>(Ls, p < np ? Ls + S::kL : fstrip + k0 * TN, g, c0,
                        prod);
      if (c % NK == NK - 1) {   // product p is complete
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = p < np ? acc[i][j] - prod[i][j] : prod[i][j];
            prod[i][j] = 0.f;
          }
        if (fin && p == np - 1) {   // read after the next barrier
#pragma unroll
          for (int i = 0; i < 4; ++i)
            Vec16<float>::st(fstrip + (g + i * RS) * TN + c0, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      Vec16<float>::st(T + (int64_t)(g + i * RS) * BS + c0, acc[i]);
  }
}

template <int BS, int TN, bool BF16 = false>
int launch_waves(float* pool, const float* linv, const int32_t* tslot,
                 const int32_t* tstep, const int32_t* tfin,
                 const int32_t* pptr, const int32_t* cl, const int32_t* cu,
                 const int64_t* wptr, int nwaves, cudaStream_t stream) {
  constexpr size_t smem = BF16 ? wave_smem_bytes<BS, TN, kMmaUL<TN>>()
                                : wave_smem_bytes<BS, TN>();
  static_assert(smem <= 227 * 1024, "shared memory");
  cudaError_t e = cudaFuncSetAttribute(
      wave_kernel<BS, TN, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  for (int w = 0; w < nwaves; ++w) {
    const int64_t t0 = wptr[w];
    const int64_t n = wptr[w + 1] - t0;
    if (n == 0) continue;
    wave_kernel<BS, TN, BF16><<<dim3((unsigned)n, BS / TN),
                          Ring<BS, TN>::kThreads, smem, stream>>>(
        pool, linv, tslot, tstep, tfin, pptr, cl, cu, (int)t0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The update of one level: `nwaves` launches, wave w over the targets
// wptr[w] .. wptr[w+1] (wptr is a host array of nwaves + 1 entries); the
// FP32 kernel, or with BF16 its bf16 pass.
template <int TN, bool BF16 = false>
int waves_f32(void* pool, const void* linv, const void* tslot,
              const void* tstep, const void* tfin, const void* pptr,
              const void* cl, const void* cu, const void* wptr, int nwaves,
              int bs, void* stream) {
  auto go = [&](auto launch) {
    return launch((float*)pool, (const float*)linv, (const int32_t*)tslot,
                  (const int32_t*)tstep, (const int32_t*)tfin,
                  (const int32_t*)pptr, (const int32_t*)cl,
                  (const int32_t*)cu, (const int64_t*)wptr, nwaves,
                  (cudaStream_t)stream);
  };
  switch (bs) {
    case 32: return go(launch_waves<32, TN, BF16>);
    case 64: return go(launch_waves<64, TN, BF16>);
    case 128: return go(launch_waves<128, TN, BF16>);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace slu_waves
