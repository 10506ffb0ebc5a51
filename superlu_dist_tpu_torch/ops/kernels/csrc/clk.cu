// clk.cu: the left-looking column factor: the update in source-ready
// waves, and the L-part TRSM.
//
// Replaces: superlu_dist_tpu/ops/kernels/clk.py::_clk_kernel (called by
// _clk_seg_call), the column-resident left-looking factor of the TPU.
// Its diagonal LU is the separate diag_lu kernel (diag_lu.cu).
//
// What it computes, for each block column k of one elimination level
// (pool slots of column k are contiguous: U(j,k) for ascending j, the
// diagonal block, then L(i,k) for ascending i):
//   clk_update: every stored block (i,k) becomes
//                 (i,k) - sum of L(i,j) . U(j,k)
//               over the column's U blocks U(j,k) with j < i and L(i,j)
//               stored, and every U block is then finalized as
//                 U(i,k) <- linv(i) . U(i,k)
//               (the exact-LU fill closure guarantees every (i,k) that
//               the sum reaches is stored).
//   clk_trsm:   L(i,k) <- L(i,k) . uinv(k) for every L block of the level.
// Column k depends only on columns of lower levels, so the columns of one
// level run in parallel; the level order replaces the TPU's sequential
// grid, one launch per phase per level on one stream.
//
// What bounds it on an H100: operations, 2*bs^3 per block product in
// FP32 on the CUDA cores (67 TFLOP/s peak), and at the top of the
// elimination tree the dependencies inside a column: U(i,k) can be
// finalized only after every U(j,k) that it depends on (L(i,j) stored).
//
// Design of clk_update: the host cuts each level into source-ready waves
// (clk.py::build_clk_tapes): a U block without sources is final in wave
// f = 0, one with sources in wave f(i) = 1 + max f(j), and the product
// L(i',j) . U(j,k) is applied in wave f(j) + 1. One launch per wave
// (issued in a loop by slu_clk_waves_f32 from the host array of wave
// pointers), one CTA per (target, strip of TN scalar columns). A CTA loads
// its strip into registers once, subtracts the wave's products of its
// target in list order (ascending j), applies linv(i) if the target's sum
// is then complete (FIN_U), and stores the strip once. No atomics, and a
// fixed order: a target's sum runs by source wave, then ascending j, where
// the JAX kernel runs by ascending j alone. Every source U block of a wave
// was final in an earlier wave and every L block belongs to a lower level,
// so nothing that a launch reads is written in it.
//   The operands stream through shared memory by asynchronous copies
// (cp.async, a ring of STAGES chunks): a chunk is KC columns of the L
// block (bs x KC, rows padded to LD floats so that the eight rows a warp
// reads at once fall in distinct banks) and the matching KC rows of the U
// strip; while the CTA multiplies one chunk, the next STAGES - 1 are in
// flight, so the chain of products on one CTA does not wait on L2 latency.
// The finalize is one more product, linv(i) against the strip staged in
// shared memory. Each of (bs/4)(TN/4) threads owns a 4x4 tile of the
// strip: rows g, g + bs/4, g + bs/2, g + 3bs/4 (g = tid / (TN/4)) and 4
// consecutive columns. The arithmetic is IEEE FP32 FMA on the CUDA cores
// (no TF32).
//
// clk_trsm is panel.cuh's band-times-inverse kernel (shared with
// schur.cu's trsm): one CTA per (L block, band of whole rows), the band
// and the inverse streamed through a cp.async ring, the band written back
// in place once all of it has been read. Offsets are computed in 64 bits
// (slot * bs^2 passes 2^31 near n = 885k).

#include "panel.cuh"
#include "strip.cuh"

namespace {

using slu_panel::cp_async16;
using slu_panel::cp_async_commit;
using slu_panel::cp_async_wait;
using slu_strip::Vec4;

// clk_update's columns per strip: 8 and 32 were no faster on an H100
// (superlu_dist_tpu_torch/tools/clk_strip_ab.py rewrites this line)
constexpr int TN = 16;
constexpr int KC = 32;                  // k per staged chunk
constexpr int LD = KC + 4;              // padded row of a staged L chunk
constexpr int STAGES = 3;               // chunks in the cp.async ring

template <int BS>
struct Wave {
  static constexpr int kThreads = (BS / 4) * (TN / 4);   // a 4x4 tile each
  static constexpr int kL = BS * LD;              // staged L chunk (floats)
  static constexpr int kStage = kL + KC * TN;     // + the U chunk
  // the ring, then the finalize operand (the target strip, BS x TN)
  static constexpr size_t kBytes =
      (size_t)(STAGES * kStage + BS * TN) * sizeof(float);
  static_assert(kBytes <= 227 * 1024, "shared memory");
};

template <int BS>
__global__ void __launch_bounds__(Wave<BS>::kThreads)
clk_wave_kernel(float* __restrict__ pool, const float* __restrict__ linv,
                const int32_t* __restrict__ tslot,
                const int32_t* __restrict__ tstep,
                const int32_t* __restrict__ tfin,
                const int32_t* __restrict__ pptr,
                const int32_t* __restrict__ cl,
                const int32_t* __restrict__ cu, int t0) {
  using S = Wave<BS>;
  constexpr int NT = S::kThreads;
  constexpr int NK = BS / KC;    // chunks per product
  constexpr int RS = BS / 4;     // row stride of a thread's 4 rows
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* fstrip = smem + STAGES * S::kStage;
  const int t = t0 + blockIdx.x;
  const int s0 = blockIdx.y * TN;
  const int tid = threadIdx.x;
  const int g = tid / (TN / 4);
  const int c0 = (tid % (TN / 4)) * 4;
  const int64_t bb = (int64_t)BS * BS;
  const int p0 = pptr[t];
  const int np = pptr[t + 1] - p0;
  const bool fin = tfin[t] == slu_strip::FIN_U;
  const float* Linv = linv + (int64_t)tstep[t] * bb;
  const int nchunks = (np + (fin ? 1 : 0)) * NK;
  float* T = pool + (int64_t)tslot[t] * bb + s0;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    Vec4<float>::ld(T + (int64_t)(g + i * RS) * BS + c0, acc[i]);
  if (np == 0) {   // a finalize alone: its operand is the stored strip
#pragma unroll
    for (int i = 0; i < 4; ++i)
      Vec4<float>::st(fstrip + (g + i * RS) * TN + c0, acc[i]);
  }

  // stage chunk c: columns k0.. of product p's L block (of linv(i) for the
  // finalize) and rows k0.. of its U strip
  auto load = [&](int c) {
    float* st = smem + (c % STAGES) * S::kStage;
    const int p = c / NK;
    const int k0 = (c % NK) * KC;
    const float* L = p < np ? pool + (int64_t)cl[p0 + p] * bb : Linv;
    for (int e = tid; e < BS * (KC / 4); e += NT) {
      const int r = e / (KC / 4), q = (e % (KC / 4)) * 4;
      cp_async16(st + r * LD + q, L + (int64_t)r * BS + k0 + q);
    }
    if (p < np) {
      const float* U = pool + (int64_t)cu[p0 + p] * bb + s0;
      float* us = st + S::kL;
      for (int e = tid; e < KC * (TN / 4); e += NT) {
        const int r = e / (TN / 4), q = (e % (TN / 4)) * 4;
        cp_async16(us + r * TN + q, U + (int64_t)(k0 + r) * BS + q);
      }
    }
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
    const float* Bs = p < np ? Ls + S::kL : fstrip + k0 * TN;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      float a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        Vec4<float>::ld(Ls + (g + i * RS) * LD + kk, a[i]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float b[4];
        Vec4<float>::ld(Bs + (kk + u) * TN + c0, b);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) prod[i][j] += a[i][u] * b[j];
      }
    }
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
          Vec4<float>::st(fstrip + (g + i * RS) * TN + c0, acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    Vec4<float>::st(T + (int64_t)(g + i * RS) * BS + c0, acc[i]);
}

template <int BS>
int launch_waves(float* pool, const float* linv, const int32_t* tslot,
                 const int32_t* tstep, const int32_t* tfin,
                 const int32_t* pptr, const int32_t* cl, const int32_t* cu,
                 const int64_t* wptr, int nwaves, cudaStream_t stream) {
  constexpr size_t smem = Wave<BS>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      clk_wave_kernel<BS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  for (int w = 0; w < nwaves; ++w) {
    const int64_t t0 = wptr[w];
    const int64_t n = wptr[w + 1] - t0;
    if (n == 0) continue;
    clk_wave_kernel<BS><<<dim3((unsigned)n, BS / TN), Wave<BS>::kThreads,
                          smem, stream>>>(
        pool, linv, tslot, tstep, tfin, pptr, cl, cu, (int)t0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// The update of one level: `nwaves` launches, wave w over the targets
// wptr[w] .. wptr[w+1] (wptr is a host array of nwaves + 1 entries).
extern "C" int slu_clk_waves_f32(void* pool, const void* linv,
                                 const void* tslot, const void* tstep,
                                 const void* tfin, const void* pptr,
                                 const void* cl, const void* cu,
                                 const void* wptr, int nwaves, int bs,
                                 void* stream) {
  auto go = [&](auto launch) {
    return launch((float*)pool, (const float*)linv, (const int32_t*)tslot,
                  (const int32_t*)tstep, (const int32_t*)tfin,
                  (const int32_t*)pptr, (const int32_t*)cl,
                  (const int32_t*)cu, (const int64_t*)wptr, nwaves,
                  (cudaStream_t)stream);
  };
  switch (bs) {
    case 32: return go(launch_waves<32>);
    case 64: return go(launch_waves<64>);
    case 128: return go(launch_waves<128>);
    default: return (int)cudaErrorInvalidValue;
  }
}

// L(i,k) <- L(i,k) . uinv(k) over the level's L blocks: the same function
// as schur.cu's trsm with left = 0, launched and counted apart.
extern "C" int slu_clk_trsm_f32(void* pool, const void* uinv,
                                const void* lslots, const void* lsteps,
                                int count, int bs, void* stream) {
  return slu_panel::trsm<float>(pool, uinv, lslots, lsteps, count, bs, 0,
                                stream);
}
