// tck.cu: the tiled left-looking column update, per elimination level in
// two phases.
//
// Replaces: superlu_dist_tpu/ops/kernels/tck.py::_tck_kernel (called by
// _tck_seg_call), the TPU's column-resident factor for columns of any
// height, whose resident panel is a tile of W block rows sliding down the
// column. Its DIAG and TRSM jobs are the diag_lu launch (diag_lu.cu) and
// the clk_trsm launch (clk.cu) that follow this one on the same level.
//
// What it computes, for each block column k of one elimination level
// (pool slots of column k are contiguous: U(j,k) for ascending j, the
// diagonal block, then L(i,k) for ascending i): every stored (i,k)
// becomes (i,k) - sum of L(i,j) . U(j,k) over the column's U blocks with
// L(i,j) stored, and every U block is then finalized as
// U(j,k) <- linv(j) . U(j,k): the TPU kernel's LOAD / GEMM / FINU / STORE
// stream. The diagonal and L positions are finalized by diag_lu and
// clk_trsm. Column k depends only on columns of lower levels, so the level
// order replaces the TPU's sequential grid.
//
// What bounds it on an H100: operations, 2*bs^3 per block product in FP32
// on the CUDA cores (67 TFLOP/s peak), and at the top of the elimination
// tree the chains: a U block waits on the U blocks it depends on, and a
// position sums its products in ascending source order.
//
// Design, on the host's tapes (ops/kernels/tck.py::build_tck_tapes):
//   Phase A (slu_tck_waves_f32): the U part of every column of the level,
//     waves.cuh's update in source-ready waves (clk.cu's clk_update, fed
//     only the products whose target lies above the diagonal): one launch
//     per wave. Every U block is final when phase A ends.
//   Phase B (slu_tck_tiles_f32): one launch per level for the diagonal
//     and L positions. One CTA per (tile, strip of TNB = 16 scalar
//     columns); a tile is up to W consecutive diagonal/L positions of one
//     column (fewer on a level where a taller tile would lengthen its
//     longest chain of products). The CTA loads the tile's strips into
//     shared memory once, subtracts every product into the tile in
//     ascending source j, then L block (the JAX kernel's order), and
//     stores the tile once. Each product is L(i,j) . U(j,k), its operands
//     streamed through waves.cuh's cp.async ring (KC-column chunks of the
//     L block and the matching KC rows of the final U strip, from the
//     pool). A thread reads and writes only its own 4x4 share of each
//     tile position, so the tile needs no barrier of its own. W is what half an SM's shared memory holds
//     beside the ring (tck.py::tile_rows: 6 rows at bs = 128), so that two
//     CTAs share an SM; the launch takes the ring plus its tallest tile.
// Nothing that a launch reads is written in it: phase B reads final U
// blocks and L blocks of lower levels, and writes only its tiles.
//
// The _bf16 entries are the low pass of gemm_precision "default" (the TPU
// kernel's dot() at precision "default", tck.py:226-228 there: the U
// finalize :306, the update products :311 and :346 and the L finalize
// :323, in one bf16 pass with float32 accumulation). Phase A is
// waves.cuh's wave_mma_kernel (clk.cu's slu_clk_waves_bf16, each wave at
// the geometry that the host chooses). Phase B does not keep the tiles:
// a tile's products run in one chain on one CTA, and at the top of the
// elimination tree a level's few tiles each hold one position whose chain
// of 80-100 products no tile height can shorten. So the host cuts each
// position's chain (the tile's products into it, in the same order) into
// chunks of at most flk.CHUNK_MAX products (tck.py::_chain_tapes, by
// flk's rule), and phase B runs flk's two passes over them on passes.cuh's
// bf16 chain product (slu_tck_chunks_bf16, slu_tck_sum_bf16: no
// finalize, FIN_NONE targets): pass 1 finishes a position of one chunk
// and writes each chunk of the others to a float32 scratch row, pass 2
// adds a position's rows in chunk order; no atomics, so a factor repeats
// bit for bit. Operands are rounded to bf16 as their fragments are built;
// the sums, the pool and the scratch rows stay float32. The TRSM jobs are
// clk.cu's slu_clk_trsm_bf16.

#include "passes.cuh"
#include "waves.cuh"

namespace {

using slu_panel::Vec16;
using slu_waves::KC;
using slu_waves::Ring;

constexpr int TN = 16;                  // phase A's scalar columns per strip
// phase B's scalar columns per strip (8 was slower on an H100) and the
// chunks of its cp.async ring (superlu_dist_tpu_torch/tools/tck_ab.py
// rewrites these two lines)
constexpr int TNB = 16;
constexpr int STB = 3;
constexpr int kTileFields = 4;          // slot0, rows, q0, q1
constexpr int kMaxSmem = 227 * 1024;    // opt-in shared memory of a CTA

// the ring, then the tile of `rows` positions (BS x TNB each)
template <int BS>
size_t tile_smem_bytes(int rows) {
  return (size_t)(Ring<BS, TNB, STB>::kFloats + rows * BS * TNB) *
         sizeof(float);
}

template <int BS>
__global__ void __launch_bounds__(Ring<BS, TNB, STB>::kThreads)
tck_tile_kernel(float* __restrict__ pool,
                const int32_t* __restrict__ tiles,
                const int32_t* __restrict__ bl,
                const int32_t* __restrict__ bu,
                const int32_t* __restrict__ bd, int t0) {
  using S = Ring<BS, TNB, STB>;
  constexpr int NK = S::NK;
  constexpr int RS = S::RS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* tile = smem + S::kFloats;       // rows x BS x TNB
  const int32_t* tr = tiles + (int64_t)kTileFields * (t0 + blockIdx.x);
  const int64_t bb = (int64_t)BS * BS;
  const int s0 = blockIdx.y * TNB;
  const int g = threadIdx.x / (TNB / 4);
  const int c0 = (threadIdx.x % (TNB / 4)) * 4;
  const int rows = tr[1], q0 = tr[2];
  const int nchunks = (tr[3] - q0) * NK;
  float* T0 = pool + (int64_t)tr[0] * bb + s0;

  // this thread's share of every tile position
  for (int p = 0; p < rows; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v[4];
      Vec16<float>::ld(T0 + p * bb + (int64_t)(g + i * RS) * BS + c0, v);
      Vec16<float>::st(tile + (p * BS + g + i * RS) * TNB + c0, v);
    }

  auto load = [&](int c) {
    const int q = q0 + c / NK;
    slu_waves::stage<BS, TNB>(smem + (c % STB) * S::kStage,
                              pool + (int64_t)bl[q] * bb,
                              pool + (int64_t)bu[q] * bb + s0, (c % NK) * KC);
  };
#pragma unroll
  for (int c = 0; c < STB - 1; ++c) {
    if (c < nchunks) load(c);
    slu_waves::cp_async_commit();
  }
  float prod[4][4] = {};
  for (int c = 0; c < nchunks; ++c) {
    slu_waves::cp_async_wait<STB - 2>();   // chunk c has landed
    __syncthreads();               // ... for every thread; stage c-1 is free
    if (c + STB - 1 < nchunks) load(c + STB - 1);
    slu_waves::cp_async_commit();
    const float* Ls = smem + (c % STB) * S::kStage;
    slu_waves::mul_chunk<BS, TNB>(Ls, Ls + S::kL, g, c0, prod);
    if (c % NK == NK - 1) {   // the product is complete: into its position
      float* T = tile + bd[q0 + c / NK] * BS * TNB;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v[4];
        Vec16<float>::ld(T + (g + i * RS) * TNB + c0, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] -= prod[i][j];
          prod[i][j] = 0.f;
        }
        Vec16<float>::st(T + (g + i * RS) * TNB + c0, v);
      }
    }
  }
  for (int p = 0; p < rows; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v[4];
      Vec16<float>::ld(tile + (p * BS + g + i * RS) * TNB + c0, v);
      Vec16<float>::st(T0 + p * bb + (int64_t)(g + i * RS) * BS + c0, v);
    }
}

template <int BS>
int launch_tiles(float* pool, const int32_t* tiles, const int32_t* bl,
                 const int32_t* bu, const int32_t* bd, int t0, int count,
                 int hmax, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes<BS>(hmax);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)count, BS / TNB);
  constexpr int nt = Ring<BS, TNB, STB>::kThreads;
  const cudaError_t e = cudaFuncSetAttribute(
      tck_tile_kernel<BS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  tck_tile_kernel<BS><<<grid, nt, smem, stream>>>(pool, tiles, bl, bu, bd,
                                                  t0);
  return (int)cudaGetLastError();
}

}  // namespace

// Phase A of one level: `nwaves` launches of the wave update, wave w over
// the targets wptr[w] .. wptr[w+1] (wptr is a host array).
extern "C" int slu_tck_waves_f32(void* pool, const void* linv,
                                 const void* tslot, const void* tstep,
                                 const void* tfin, const void* pptr,
                                 const void* cl, const void* cu,
                                 const void* wptr, int nwaves, int bs,
                                 void* stream) {
  return slu_waves::waves_f32<TN>(pool, linv, tslot, tstep, tfin, pptr, cl,
                                  cu, wptr, nwaves, bs, stream);
}

// Phase B of one level: tiles t0 .. t0+count (rows of `tiles`: first
// slot, rows, products q0 .. q1 of bl/bu/bd), hmax the tallest of them.
extern "C" int slu_tck_tiles_f32(void* pool, const void* tiles,
                                 const void* bl, const void* bu,
                                 const void* bd, int t0, int count, int hmax,
                                 int bs, void* stream) {
  if (count == 0) return 0;
  auto go = [&](auto launch) {
    return launch((float*)pool, (const int32_t*)tiles, (const int32_t*)bl,
                  (const int32_t*)bu, (const int32_t*)bd, t0, count, hmax,
                  (cudaStream_t)stream);
  };
  switch (bs) {
    case 32: return go(launch_tiles<32>);
    case 64: return go(launch_tiles<64>);
    case 128: return go(launch_tiles<128>);
    default: return (int)cudaErrorInvalidValue;
  }
}

// slu_tck_waves_f32 in the bf16 pass, wave w at the geometry geom[w]
// (a host array: strip width << 8 | ring depth); the pool holds `nslots`
// blocks and linv `ninv`.
extern "C" int slu_tck_waves_bf16(void* pool, const void* linv,
                                  const void* tslot, const void* tstep,
                                  const void* tfin, const void* pptr,
                                  const void* cl, const void* cu,
                                  const void* wptr, const void* geom,
                                  int nwaves, int bs, int64_t nslots,
                                  int64_t ninv, void* stream) {
  return slu_waves::waves_bf16(pool, linv, tslot, tstep, tfin, pptr, cl, cu,
                               wptr, geom, nwaves, bs, nslots, ninv, stream);
}

// Phase B of one level in the bf16 pass, pass 1: `count` chunks (int32
// device arrays qtgt, qrow, qcptr at the level's first chunk; tslot, cl,
// cu whole), each writing its position or its scratch row. `wide` < 0
// chooses the band geometry by chain.cuh's rule, 0 / 1 force bands of 16
// / 64.
extern "C" int slu_tck_chunks_bf16(void* pool, void* scratch,
                                   const void* qtgt, const void* qrow,
                                   const void* qcptr, const void* tslot,
                                   const void* cl, const void* cu, int count,
                                   int bs, int wide, void* stream) {
  return chunks_bf16(pool, nullptr, nullptr, scratch, qtgt, qrow, qcptr,
                     tslot, nullptr, nullptr, cl, cu, count, bs, wide,
                     stream);
}

// Pass 2: `count` positions of several chunks (mtgt, mrow, mcnt at the
// level's first such position), each the sum of its scratch rows in chunk
// order.
extern "C" int slu_tck_sum_bf16(void* pool, const void* scratch,
                                const void* mtgt, const void* mrow,
                                const void* mcnt, const void* tslot,
                                int count, int bs, int wide, void* stream) {
  return sum_bf16(pool, nullptr, nullptr, scratch, mtgt, mrow, mcnt, tslot,
                  nullptr, nullptr, count, bs, wide, stream);
}
