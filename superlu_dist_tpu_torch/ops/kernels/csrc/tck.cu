// tck.cu: the tiled left-looking column update, one elimination level per
// launch.
//
// Replaces: superlu_dist_tpu/ops/kernels/tck.py::_tck_kernel (called by
// _tck_seg_call), the TPU's column-resident factor for columns of any
// height, whose resident panel is a tile of W block rows sliding down the
// column. Its DIAG and TRSM jobs are the diag_lu launch (diag_lu.cu) and
// the clk_trsm launch (clk.cu) that follow this one on the same level.
//
// What it computes, for each block column k of one elimination level
// (pool slots of column k are contiguous: U(j,k) for ascending j, the
// diagonal block, then L(i,k) for ascending i), tile by tile down the
// column, on the host's job lists (ops/kernels/tck.py::build_tck_tapes):
//   GEMM job: B = U(j,k); if B sits in the tile and this is its first use
//             there, B <- linv(j) . B in place (a B from an earlier tile is
//             read from the pool, already final); then
//             tile[dst[m]] -= L(i_m, j) . B for the job's m L blocks
//   FINU job: U(j,k) <- linv(j) . U(j,k) for a U block that was no source
//             inside its own tile
// Jobs run in ascending source order within a tile, so each position sums
// its contributions in that order, and a U block is final before its
// first use. The diagonal and L positions get their contributions here
// and are finalized by diag_lu and clk_trsm. Column k depends only on
// columns of lower levels, so the level order replaces the TPU's
// sequential grid: one launch per level on one stream.
//
// What bounds it on an H100: operations, 2*bs^3 per block product in FP32
// on the CUDA cores (67 TFLOP/s peak), and at the top of the elimination
// tree the parallelism of a level (one or two columns, so bs/16 CTAs).
//
// Design: one CTA per (column, strip of TN = 16 scalar columns), as
// clk_update; each thread owns a 4x4 tile of a block strip. The CTA keeps
// the strip of up to W block rows of the current tile in shared memory
// (W = 24 at bs = 128: 24 x 8 KiB plus one 8 KiB B strip, 200 KiB,
// opt-in dynamic shared memory sized per launch by the level's tallest
// tile), accumulates every contribution there and stores the tile to the
// pool once, where clk_update reads and writes a target strip in device
// memory for every product. The L blocks are read from device memory (L2)
// through the read-only path: they belong to lower levels. A B strip from
// an earlier tile is read with ordinary loads, since this CTA stored it.
// Offsets are 64-bit (slot * bs^2 passes 2^31 near n = 885k).

#include "strip.cuh"

namespace {

constexpr int TN = slu_strip::kStrip;   // scalar columns per strip
constexpr int kB_LOAD = -1;             // load B from the pool (tck.py)
constexpr int kTileFields = 6;          // p0, rows, g0, g1, f0, f1
constexpr int kGemmFields = 7;          // a0, m, bpos, bslot, src, fin, d0

// strip (bs x TN, leading dimension TN) of a block at `src` in the pool
// (leading dimension bs) into shared memory, or back
__device__ __forceinline__ void copy_in(float* dst, const float* src,
                                        int bs) {
  for (int e = threadIdx.x; e < bs * (TN / 4); e += blockDim.x) {
    const int r = e / (TN / 4);
    const int c = (e % (TN / 4)) * 4;
    *reinterpret_cast<float4*>(dst + r * TN + c) =
        *reinterpret_cast<const float4*>(src + (int64_t)r * bs + c);
  }
}

__device__ __forceinline__ void copy_out(float* dst, const float* src,
                                         int bs) {
  for (int e = threadIdx.x; e < bs * (TN / 4); e += blockDim.x) {
    const int r = e / (TN / 4);
    const int c = (e % (TN / 4)) * 4;
    *reinterpret_cast<float4*>(dst + (int64_t)r * bs + c) =
        *reinterpret_cast<const float4*>(src + r * TN + c);
  }
}

// S <- D . S for a strip S in shared memory and a block D in device
// memory (the U finalize); synchronises before and after the write.
__device__ __forceinline__ void left_apply(const float* __restrict__ D,
                                           float* S, int bs, int r0,
                                           int c0) {
  float acc[4][4] = {};
  slu_strip::mul_dev_smem<float>(D, S, bs, r0, c0, acc);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
    slu_strip::Vec4<float>::st(S + (r0 + i) * TN + c0, acc[i]);
  __syncthreads();
}

__global__ void __launch_bounds__(slu_strip::kMaxBs)
tck_update_kernel(float* pool, const float* __restrict__ linv,
                  const int32_t* __restrict__ cbase,
                  const int32_t* __restrict__ ctile,
                  const int32_t* __restrict__ tiles,
                  const int32_t* __restrict__ gjobs,
                  const int32_t* __restrict__ dst,
                  const int32_t* __restrict__ fjobs, int c0, int bs) {
  extern __shared__ float4 smem4[];
  float* sB = reinterpret_cast<float*>(smem4);   // bs x TN: a B from the pool
  float* sT = sB + bs * TN;                      // rows x bs x TN: the tile
  const int q = c0 + blockIdx.x;
  const int s0 = blockIdx.y * TN;
  const int tid = threadIdx.x;
  const int r0 = (tid / (TN / 4)) * 4;
  const int cc = (tid % (TN / 4)) * 4;
  const int64_t bb = (int64_t)bs * bs;
  const int bst = bs * TN;                       // floats of one block strip
  const int64_t base = cbase[q];

  for (int i = ctile[q]; i < ctile[q + 1]; ++i) {
    const int32_t* tr = tiles + (int64_t)kTileFields * i;
    const int p0 = tr[0], rows = tr[1];
    const int g0 = tr[2], g1 = tr[3], f0 = tr[4], f1 = tr[5];
    if (g0 == g1 && f0 == f1) continue;          // the tile stays as it is
    float* T0 = pool + (base + p0) * bb + s0;
    __syncthreads();                             // the last tile is stored
    for (int p = 0; p < rows; ++p) copy_in(sT + p * bst, T0 + p * bb, bs);
    __syncthreads();

    for (int g = g0; g < g1; ++g) {
      const int32_t* gj = gjobs + (int64_t)kGemmFields * g;
      const int64_t a0 = gj[0];
      const int m = gj[1], bpos = gj[2], d0 = gj[6];
      const float* B = sB;
      if (bpos >= 0) {
        float* Bt = sT + bpos * bst;
        if (gj[5]) left_apply(linv + (int64_t)gj[4] * bb, Bt, bs, r0, cc);
        B = Bt;
      } else if (bpos == kB_LOAD) {
        copy_in(sB, pool + (int64_t)gj[3] * bb + s0, bs);
        __syncthreads();
      }                                          // else: sB holds it
      for (int mm = 0; mm < m; ++mm) {
        float prod[4][4] = {};
        slu_strip::mul_dev_smem<float>(pool + (a0 + mm) * bb, B, bs, r0, cc,
                                       prod);
        float* C = sT + dst[d0 + mm] * bst;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float v[4];
          slu_strip::Vec4<float>::ld(C + (r0 + r) * TN + cc, v);
#pragma unroll
          for (int c = 0; c < 4; ++c) v[c] -= prod[r][c];
          slu_strip::Vec4<float>::st(C + (r0 + r) * TN + cc, v);
        }
      }
      // the next job may read a block just written, or reload sB
      __syncthreads();
    }
    for (int f = f0; f < f1; ++f)
      left_apply(linv + (int64_t)fjobs[2 * f + 1] * bb,
                 sT + fjobs[2 * f] * bst, bs, r0, cc);
    for (int p = 0; p < rows; ++p) copy_out(T0 + p * bb, sT + p * bst, bs);
  }
}

}  // namespace

extern "C" int slu_tck_update_f32(void* pool, const void* linv,
                                  const void* cbase, const void* ctile,
                                  const void* tiles, const void* gjobs,
                                  const void* dst, const void* fjobs, int c0,
                                  int ncols, int hmax, int bs, void* stream) {
  const size_t smem = (size_t)(hmax + 1) * bs * TN * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tck_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (ncols == 0) return 0;
  const dim3 grid(ncols, bs / TN);
  const int threads = (bs / 4) * (TN / 4);
  tck_update_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (float*)pool, (const float*)linv, (const int32_t*)cbase,
      (const int32_t*)ctile, (const int32_t*)tiles, (const int32_t*)gjobs,
      (const int32_t*)dst, (const int32_t*)fjobs, c0, bs);
  return (int)cudaGetLastError();
}
