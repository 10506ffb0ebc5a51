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
// The bf16 pass (wave_mma_kernel, clk's and tck's gemm_precision
// "default"): the same waves, function and order, every product (the
// finalize by linv included) on the tensor cores through mma.cuh's
// m16n8k16 bf16 tiles with float32 accumulation, in a kernel of its own
// for Hopper. One producer warp fills a ring of chunks through the tensor
// memory accelerator (a 2D box of an L chunk and one or two of the U
// chunk a stage, from tensor maps of the pool and linv made per entry
// call, 128- or 64-byte swizzle); each stage completes on its full
// mbarrier. The consumer warps, 32 rows by 16 or 32 columns each, wait on
// it and release the stage by one arrival a warp on its empty mbarrier,
// so no block-wide barrier runs per chunk (one named barrier of the
// consumers before a finalize, whose operand is the target strip rounded
// to bf16 and held transposed in shared memory). The host chooses per
// wave (clk.py::wave_geoms) the strip width and the ring depth: strips of
// 16 and 8 stages where a wave's CTAs would leave SMs idle, else the
// widest strip (32 or 64 columns) whose CTAs still give 4 an SM, at 3
// stages, so that each L chunk enters 4 or 2 SMs a target instead of 8.
// A wave after a level's first launches early (programmatic dependent
// launch): it sets up and loads its first L boxes while the wave before
// it finishes, and reads the U blocks and targets only after
// griddepcontrol.wait. An output element sums the same k steps in the
// same order at every geometry, so every geometry gives the same bits.
// Operands are rounded to bf16 as their fragments are built from the
// float32 chunks; the sums, the pool and the inverses stay float32. On an
// H100 the waves that set the time fill the card (the narrow ones hold one
// or two products a target), so a CTA's time per chunk, not one CTA's
// latency, is what the design cuts (tools/clk_strip_ab.py --bf16).

#pragma once

#include <cuda.h>

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

template <int BS, int TN>
__global__ void __launch_bounds__(Ring<BS, TN>::kThreads)
wave_kernel(float* __restrict__ pool, const float* __restrict__ linv,
            const int32_t* __restrict__ tslot,
            const int32_t* __restrict__ tstep,
            const int32_t* __restrict__ tfin,
            const int32_t* __restrict__ pptr,
            const int32_t* __restrict__ cl,
            const int32_t* __restrict__ cu, int t0) {
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

template <int BS, int TN>
int launch_waves(float* pool, const float* linv, const int32_t* tslot,
                 const int32_t* tstep, const int32_t* tfin,
                 const int32_t* pptr, const int32_t* cl, const int32_t* cu,
                 const int64_t* wptr, int nwaves, cudaStream_t stream) {
  constexpr size_t smem = wave_smem_bytes<BS, TN>();
  static_assert(smem <= 227 * 1024, "shared memory");
  cudaError_t e = cudaFuncSetAttribute(
      wave_kernel<BS, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  for (int w = 0; w < nwaves; ++w) {
    const int64_t t0 = wptr[w];
    const int64_t n = wptr[w + 1] - t0;
    if (n == 0) continue;
    wave_kernel<BS, TN><<<dim3((unsigned)n, BS / TN), Ring<BS, TN>::kThreads,
                          smem, stream>>>(pool, linv, tslot, tstep, tfin,
                                          pptr, cl, cu, (int)t0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The update of one level in the FP32 kernel: `nwaves` launches, wave w
// over the targets wptr[w] .. wptr[w+1] (wptr is a host array of nwaves +
// 1 entries).
template <int TN>
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
    case 32: return go(launch_waves<32, TN>);
    case 64: return go(launch_waves<64, TN>);
    case 128: return go(launch_waves<128, TN>);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The bf16 pass (the header says how it is laid out)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of bulk copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// until the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// programmatic dependent launch: wait until the grids before this one in
// the stream have completed and their writes are visible (at once where
// the launch did not ask for an early start), and let the next grid start
__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void grid_launch_next() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// the box of `map` at (column x, row y) into shared memory by the tensor
// memory accelerator, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

// The float offset of element (r, c) of a staged box whose rows hold
// RB bytes (128 or 64), as the tensor map's swizzle of the same width
// places it: the 16-byte unit c / 4 of row r is XORed with bits 7.. of
// the row's byte offset (the box starts on a 1024-byte boundary).
template <int RB>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int W = RB / 4;   // floats a row
  return r * W + ((((c >> 2) ^ ((r * RB) >> 7)) & (RB / 16 - 1)) << 2) +
         (c & 3);
}

// Whether a wave after a level's first may start before the wave before
// it has finished (programmatic dependent launch; tools/clk_strip_ab.py
// rewrites this line)
constexpr bool kWaveEarly = true;

// The bf16 wave kernel at block size BS and strip width TN: NW consumer
// warps of 32 rows by WC columns (WN n8 tiles) and one producer warp. A
// ring stage holds an L chunk (a box of BS rows by KC floats, 128-byte
// swizzle) and a U chunk (a box of KC rows by UB floats, UB = 16 with
// the 64-byte swizzle or 32 with the 128-byte one; two boxes at TN =
// 64); the finalize operand is bf16, held transposed (element (k, n) at
// n * LDT + k). Mirrored by clk.py::wave_mma_bytes.
template <int BS, int TN>
struct WaveMma {
  static_assert((TN == 16 || TN == 32 || TN == 64) && TN <= BS,
                "strips of 16, 32 or 64 columns");
  static_assert(KC == 32, "an L chunk's rows are 128 bytes");
  static constexpr int WC = TN < 32 ? TN : 32;
  static constexpr int WN = WC / 8;
  static constexpr int RW = BS / 32;             // warps down the strip
  static constexpr int NW = RW * (TN / WC);
  static constexpr int kThreads = 32 * (NW + 1);
  static constexpr int UB = TN < 32 ? TN : 32;   // columns of a U box
  static constexpr int LDT = BS + 8;             // distinct banks
  static constexpr int NK = BS / KC;
  static constexpr int kL = BS * KC;             // floats
  static constexpr int kStage = kL + KC * TN;    // floats, 1024-byte units
  static constexpr uint32_t kTxL = kL * sizeof(float);
  static constexpr uint32_t kTxU = KC * TN * sizeof(float);
  static constexpr size_t kFixed = 1024 + (size_t)TN * LDT * 2;
  // a stage and its two mbarriers
  static constexpr size_t kPerStage = kStage * sizeof(float) + 16;
  static constexpr size_t bytes(int stages) {
    return stages * kPerStage + kFixed;
  }
  static constexpr int kMaxStages =
      (227 * 1024 - kFixed) / kPerStage < 8 ? (227 * 1024 - kFixed) / kPerStage
                                            : 8;
};

// The tensor maps of one launch: L chunks of the pool and of linv (boxes
// of BS rows by KC floats), U chunks of the pool (KC rows by 16 or by 32
// floats).
struct WaveMaps {
  CUtensorMap pool_l, linv_l, pool_u16, pool_u32;
};

// A of rows r0 .. r0+15 and columns k .. k+15 of a staged L box
__device__ __forceinline__ void frag_a_box(const float* A, int r0, int k,
                                           uint32_t (&a)[4]) {
  const int r = r0 + slu_mma::lane_gid(), c = k + 2 * slu_mma::lane_tig();
  const float2 v0 = *reinterpret_cast<const float2*>(A + swz<128>(r, c));
  const float2 v1 = *reinterpret_cast<const float2*>(A + swz<128>(r + 8, c));
  const float2 v2 = *reinterpret_cast<const float2*>(A + swz<128>(r, c + 8));
  const float2 v3 =
      *reinterpret_cast<const float2*>(A + swz<128>(r + 8, c + 8));
  a[0] = slu_mma::pack_bf16(v0.x, v0.y);
  a[1] = slu_mma::pack_bf16(v1.x, v1.y);
  a[2] = slu_mma::pack_bf16(v2.x, v2.y);
  a[3] = slu_mma::pack_bf16(v3.x, v3.y);
}

// B of rows (k) k .. k+15 and columns c .. c+7 of a staged U box of UB
// columns
template <int UB>
__device__ __forceinline__ void frag_b_box(const float* B, int k, int c,
                                           uint32_t (&b)[2]) {
  constexpr int RB = UB * 4;
  const int r = k + 2 * slu_mma::lane_tig(), n = c + slu_mma::lane_gid();
  b[0] = slu_mma::pack_bf16(B[swz<RB>(r, n)], B[swz<RB>(r + 1, n)]);
  b[1] = slu_mma::pack_bf16(B[swz<RB>(r + 8, n)], B[swz<RB>(r + 9, n)]);
}

// prod += a staged chunk: its L box (this warp's rows r0 ..) times its U
// box (this warp's columns c0 .. of the strip, in the box of columns
// c0 / UB), or for the finalize (U null) times rows k0 .. k0 + KC of the
// finalize operand ft. Each output's k run in steps of 16 in ascending
// order, each step summed by the tensor core, as mma.cuh's mma_chunk.
template <int UB, int LDT, int WN>
__device__ __forceinline__ void mma_box(const float* L, const float* U,
                                        const __nv_bfloat16* ft, int k0,
                                        int r0, int c0,
                                        float (&prod)[2][WN][4]) {
#pragma unroll
  for (int k = 0; k < KC; k += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) frag_a_box(L, r0 + 16 * i, k, a[i]);
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      uint32_t b[2];
      if (U != nullptr) {
        frag_b_box<UB>(U + (c0 / UB) * KC * UB, k, c0 % UB + 8 * j, b);
      } else {
        const __nv_bfloat16* q = ft +
                                 (c0 + 8 * j + slu_mma::lane_gid()) * LDT +
                                 k0 + k + 2 * slu_mma::lane_tig();
        b[0] = *reinterpret_cast<const uint32_t*>(q);
        b[1] = *reinterpret_cast<const uint32_t*>(q + 8);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) slu_mma::mma_bf16(prod[i][j], a[i], b);
    }
  }
}

// this warp's tiles of the strip into the finalize operand, rounded to bf16
template <int LDT, int WN>
__device__ __forceinline__ void store_fin(__nv_bfloat16* ft, int r0, int c0,
                                          const float (&acc)[2][WN][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      __nv_bfloat16* q = ft + (c0 + 8 * j + 2 * slu_mma::lane_tig()) * LDT +
                         r0 + 16 * i + slu_mma::lane_gid();
      q[0] = __float2bfloat16_rn(acc[i][j][0]);
      q[LDT] = __float2bfloat16_rn(acc[i][j][1]);
      q[8] = __float2bfloat16_rn(acc[i][j][2]);
      q[LDT + 8] = __float2bfloat16_rn(acc[i][j][3]);
    }
}

template <int BS, int TN>
__global__ void __launch_bounds__(WaveMma<BS, TN>::kThreads)
wave_mma_kernel(const __grid_constant__ WaveMaps maps,
                float* __restrict__ pool, const int32_t* __restrict__ tslot,
                const int32_t* __restrict__ tstep,
                const int32_t* __restrict__ tfin,
                const int32_t* __restrict__ pptr,
                const int32_t* __restrict__ cl,
                const int32_t* __restrict__ cu, int t0, int stages) {
  using G = WaveMma<BS, TN>;
  constexpr int NK = G::NK;
  extern __shared__ float4 smem4[];
  // the ring on a 1024-byte boundary of shared memory (the swizzle's
  // period)
  float* ring = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem4) +
      ((1024 - (smem_addr(smem4) & 1023)) & 1023));
  __nv_bfloat16* ft =
      reinterpret_cast<__nv_bfloat16*>(ring + stages * G::kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(ft + TN * G::LDT);
  uint64_t* empty = full + stages;
  const int t = t0 + blockIdx.x;
  const int s0 = blockIdx.y * TN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p0 = pptr[t];
  const int np = pptr[t + 1] - p0;
  const bool fin = tfin[t] == slu_chain::FIN_U;
  const int nchunks = (np + (fin ? 1 : 0)) * NK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);           // the producer's expect_tx
      mbar_init(empty + s, G::NW);      // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == G::NW) {
    // the producer: chunk c into stage c % stages, once the consumers
    // have released that stage's previous chunk; lane 0 issues, the
    // warp reads the product list 32 entries at a time. Before the wave
    // before it has finished, only the L boxes of the first chunks (L
    // blocks and linv belong to lower levels, final before the level's
    // first wave, which starts late).
    const int step = tstep[t];
    int ml = lane < np ? cl[p0 + lane] : 0;
    int mu = lane < np ? cu[p0 + lane] : 0;
    const int pre = nchunks < stages ? nchunks : stages;
    for (int c = 0; c < pre; ++c) {
      const int p = c / NK;
      const int lslot = __shfl_sync(0xffffffffu, ml, p);
      if (lane == 0) {
        mbar_expect_tx(full + c, p < np ? G::kTxL + G::kTxU : G::kTxL);
        tma_load(ring + c * G::kStage, p < np ? &maps.pool_l : &maps.linv_l,
                 (c % NK) * KC, (p < np ? lslot : step) * BS, full + c);
      }
    }
    grid_wait();
    grid_launch_next();
    int s = 0, round = 0;
    for (int c = 0; c < nchunks; ++c) {
      const int p = c / NK;
      const int k0 = (c % NK) * KC;
      if (k0 == 0 && p % 32 == 0 && p > 0 && p < np) {
        const int q = p + lane;
        ml = q < np ? cl[p0 + q] : 0;
        mu = q < np ? cu[p0 + q] : 0;
      }
      const int lslot = __shfl_sync(0xffffffffu, ml, p % 32);
      const int uslot = __shfl_sync(0xffffffffu, mu, p % 32);
      if (lane == 0) {
        float* st = ring + s * G::kStage;
        if (round > 0) {   // the first round's L boxes are on their way
          mbar_wait(empty + s, (round - 1) & 1);
          mbar_expect_tx(full + s, p < np ? G::kTxL + G::kTxU : G::kTxL);
          tma_load(st, p < np ? &maps.pool_l : &maps.linv_l, k0,
                   (p < np ? lslot : step) * BS, full + s);
        }
        if (p < np) {
#pragma unroll
          for (int h = 0; h < TN / G::UB; ++h)
            tma_load(st + G::kL + h * KC * G::UB,
                     TN < 32 ? &maps.pool_u16 : &maps.pool_u32,
                     s0 + h * G::UB, uslot * BS + k0, full + s);
        }
      }
      __syncwarp();
      if (++s == stages) {
        s = 0;
        ++round;
      }
    }
    return;
  }

  // a consumer warp: rows r0 .. r0 + 31 and columns c0 .. c0 + WC - 1
  const int r0 = (warp % G::RW) * 32;
  const int c0 = (warp / G::RW) * G::WC;
  float* T = pool + (int64_t)tslot[t] * BS * BS + s0;
  grid_wait();   // the targets' sums so far, and the wave's U sources
  grid_launch_next();
  float acc[2][G::WN][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < G::WN; ++j)
      slu_mma::load_c<BS>(T, r0 + 16 * i, c0 + 8 * j, acc[i][j]);
  if (np == 0)   // a finalize alone: its operand is the stored strip
    store_fin<G::LDT, G::WN>(ft, r0, c0, acc);
  float prod[2][G::WN][4] = {};
  int s = 0, round = 0;
  for (int c = 0; c < nchunks; ++c) {
    const int p = c / NK;
    const int k0 = (c % NK) * KC;
    if (p == np && k0 == 0)   // every consumer warp has stored its part
      asm volatile("bar.sync 1, %0;" ::"n"(G::NW * 32) : "memory");
    mbar_wait(full + s, round & 1);
    const float* st = ring + s * G::kStage;
    mma_box<G::UB, G::LDT, G::WN>(st, p < np ? st + G::kL : nullptr, ft, k0,
                                  r0, c0, prod);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    if (++s == stages) {
      s = 0;
      ++round;
    }
    if (c % NK == NK - 1) {   // product p is complete
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < G::WN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][j][e] =
                p < np ? acc[i][j][e] - prod[i][j][e] : prod[i][j][e];
            prod[i][j][e] = 0.f;
          }
      if (fin && p == np - 1) store_fin<G::LDT, G::WN>(ft, r0, c0, acc);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < G::WN; ++j)
      slu_mma::store_c<BS>(T, r0 + 16 * i, c0 + 8 * j, acc[i][j]);
}

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query (no link to libcuda); null where the installed CUDA lacks it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a map of `rows` rows of BS floats at `base`, in boxes of `box_rows` by
// `box_cols` floats with the swizzle of their row width
inline bool make_map(CUtensorMap* m, const float* base, int64_t rows, int bs,
                     int box_cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dim[2] = {(cuuint64_t)bs, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)bs * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t one[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
            dim, stride, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_cols == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One wave of the bf16 pass at strip width TN and ring depth `stages`;
// with `early` (a wave after the first of a level) the launch lets it
// start before the wave before it has finished (its L boxes are read
// early, the rest after griddepcontrol.wait).
template <int BS, int TN>
int launch_wave_mma(const WaveMaps& maps, float* pool, const int32_t* tslot,
                    const int32_t* tstep, const int32_t* tfin,
                    const int32_t* pptr, const int32_t* cl,
                    const int32_t* cu, int t0, int n, int stages, bool early,
                    cudaStream_t stream) {
  if constexpr (TN > BS) {
    return (int)cudaErrorInvalidValue;
  } else {
    using G = WaveMma<BS, TN>;
    if (stages < 2 || stages > G::kMaxStages)
      return (int)cudaErrorInvalidValue;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)n, BS / TN);
    cfg.blockDim = dim3(G::kThreads);
    cfg.dynamicSmemBytes = G::bytes(stages);
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = kWaveEarly && early ? 1 : 0;
    return (int)cudaLaunchKernelEx(&cfg, wave_mma_kernel<BS, TN>, maps, pool,
                                   tslot, tstep, tfin, pptr, cl, cu, t0,
                                   stages);
  }
}

// the most shared memory that the kernel of strip width TN may take
template <int BS, int TN>
cudaError_t allow_wave_mma() {
  if constexpr (TN > BS) {
    return cudaSuccess;
  } else {
    using G = WaveMma<BS, TN>;
    return cudaFuncSetAttribute(wave_mma_kernel<BS, TN>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)G::bytes(G::kMaxStages));
  }
}

template <int BS>
int launch_waves_mma(float* pool, const float* linv, int64_t nslots,
                     int64_t ninv, const int32_t* tslot, const int32_t* tstep,
                     const int32_t* tfin, const int32_t* pptr,
                     const int32_t* cl, const int32_t* cu,
                     const int64_t* wptr, const int32_t* geom, int nwaves,
                     cudaStream_t stream) {
  WaveMaps maps;
  if (!make_map(&maps.pool_l, pool, nslots * BS, BS, KC, BS) ||
      !make_map(&maps.linv_l, linv, ninv * BS, BS, KC, BS) ||
      !make_map(&maps.pool_u16, pool, nslots * BS, BS, 16, KC) ||
      !make_map(&maps.pool_u32, pool, nslots * BS, BS, 32, KC))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_wave_mma<BS, 16>();
  if (e == cudaSuccess) e = allow_wave_mma<BS, 32>();
  if (e == cudaSuccess) e = allow_wave_mma<BS, 64>();
  if (e != cudaSuccess) return (int)e;
  bool early = false;   // the level's first wave waits for what came before
  for (int w = 0; w < nwaves; ++w) {
    const int64_t t0 = wptr[w];
    const int64_t n = wptr[w + 1] - t0;
    if (n == 0) continue;
    const int tn = geom[w] >> 8, stages = geom[w] & 255;
    int r = (int)cudaErrorInvalidValue;
    if (tn == 16)
      r = launch_wave_mma<BS, 16>(maps, pool, tslot, tstep, tfin, pptr, cl,
                                  cu, (int)t0, (int)n, stages, early, stream);
    else if (tn == 32)
      r = launch_wave_mma<BS, 32>(maps, pool, tslot, tstep, tfin, pptr, cl,
                                  cu, (int)t0, (int)n, stages, early, stream);
    else if (tn == 64)
      r = launch_wave_mma<BS, 64>(maps, pool, tslot, tstep, tfin, pptr, cl,
                                  cu, (int)t0, (int)n, stages, early, stream);
    if (r != 0) return r;
    early = true;
  }
  return 0;
}

// The update of one level in the bf16 pass: `nwaves` launches, wave w
// over the targets wptr[w] .. wptr[w+1] at the geometry geom[w] (strip
// width << 8 | ring depth; both host arrays, chosen by
// clk.py::wave_geoms); the pool holds `nslots` blocks and linv `ninv`.
inline int waves_bf16(void* pool, const void* linv, const void* tslot,
                      const void* tstep, const void* tfin, const void* pptr,
                      const void* cl, const void* cu, const void* wptr,
                      const void* geom, int nwaves, int bs, int64_t nslots,
                      int64_t ninv, void* stream) {
  auto go = [&](auto launch) {
    return launch((float*)pool, (const float*)linv, nslots, ninv,
                  (const int32_t*)tslot, (const int32_t*)tstep,
                  (const int32_t*)tfin, (const int32_t*)pptr,
                  (const int32_t*)cl, (const int32_t*)cu,
                  (const int64_t*)wptr, (const int32_t*)geom, nwaves,
                  (cudaStream_t)stream);
  };
  switch (bs) {
    case 32: return go(launch_waves_mma<32>);
    case 64: return go(launch_waves_mma<64>);
    case 128: return go(launch_waves_mma<128>);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace slu_waves
