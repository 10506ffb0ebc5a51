// clk.cu: the left-looking column factor, one elimination level per
// launch pair.
//
// Replaces: superlu_dist_tpu/ops/kernels/clk.py::_clk_kernel (called by
// _clk_seg_call), the column-resident left-looking factor of the TPU.
// Its diagonal LU is the separate diag_lu kernel (diag_lu.cu).
//
// What it computes, for each block column k of one elimination level
// (pool slots of column k are contiguous: U(j,k) for ascending j, the
// diagonal block, then L(i,k) for ascending i):
//   clk_update: for each U(j,k) in ascending j,
//                 U(j,k) <- linv(j) . U(j,k)
//                 panel(i) -= L(i,j) . U(j,k)   for every L block of column j
//               where panel(i) is column k's slot of block row i (the
//               exact-LU fill closure guarantees it is stored).
//   clk_trsm:   L(i,k) <- L(i,k) . uinv(k) for every L block of the level.
// Column k depends only on columns of lower levels, so the columns of one
// level run in parallel; the level order replaces the TPU's sequential
// grid, one launch per phase per level on one stream.
//
// What bounds it on an H100: operations, 2*bs^3 per block product in
// FP32 on the CUDA cores (67 TFLOP/s peak), and at the top of the
// elimination tree the parallelism of a level (one or two columns).
//
// Design: clk_update runs one CTA per (column, strip of TN scalar
// columns). The left-looking update acts on each scalar column of block
// column k independently, so strips need no synchronisation between CTAs;
// inside a CTA the U blocks are walked in order, with the finalized U
// strip held in shared memory while every L block of the source column is
// multiplied against it and subtracted from its target strip in device
// memory (L2-resident). clk_trsm runs one CTA per (L block, strip of 16
// rows); the row strip is staged in shared memory so the product can be
// written in place (strip.cuh, shared with flk.cu and schur.cu). Each
// thread owns a 4x4 tile of the result. Offsets are computed in 64 bits
// (slot * bs^2 passes 2^31 near n = 885k).

#include "strip.cuh"

namespace {

constexpr int TN = slu_strip::kStrip;   // clk_update: scalar columns per strip

__global__ void __launch_bounds__(256)
clk_update_kernel(float* __restrict__ pool, const float* __restrict__ linv,
                  const int32_t* __restrict__ cols,
                  const int32_t* __restrict__ col_base,
                  const int32_t* __restrict__ col_dpos,
                  const int32_t* __restrict__ col_job0,
                  const int32_t* __restrict__ job_src,
                  const int32_t* __restrict__ job_la0,
                  const int32_t* __restrict__ job_lm,
                  const int32_t* __restrict__ job_dst0,
                  const int32_t* __restrict__ dst, int bs) {
  extern __shared__ float4 smem4[];
  float* B = reinterpret_cast<float*>(smem4);   // bs x TN: the U strip
  const int k = cols[blockIdx.x];
  const int s0 = blockIdx.y * TN;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int r0 = (tid / (TN / 4)) * 4;
  const int c0 = (tid % (TN / 4)) * 4;
  const int64_t bb = (int64_t)bs * bs;
  const int64_t base = col_base[k];
  const int dp = col_dpos[k];
  const int job0 = col_job0[k];

  for (int t = 0; t < dp; ++t) {
    const int job = job0 + t;
    float* U = pool + (base + t) * bb + s0;
    for (int e = tid; e < bs * (TN / 4); e += nt) {
      const int r = e / (TN / 4);
      const int c = (e % (TN / 4)) * 4;
      *reinterpret_cast<float4*>(B + r * TN + c) =
          *reinterpret_cast<const float4*>(U + (int64_t)r * bs + c);
    }
    __syncthreads();
    float acc[4][4] = {};
    slu_strip::mul_dev_smem<float>(linv + (int64_t)job_src[job] * bb, B, bs,
                                   r0, c0, acc);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(B + (r0 + i) * TN + c0) = v;
      *reinterpret_cast<float4*>(U + (int64_t)(r0 + i) * bs + c0) = v;
    }
    __syncthreads();
    const int64_t la0 = job_la0[job];
    const int lm = job_lm[job];
    const int d0 = job_dst0[job];
    for (int m = 0; m < lm; ++m) {
      float p[4][4] = {};
      slu_strip::mul_dev_smem<float>(pool + (la0 + m) * bb, B, bs, r0, c0,
                                     p);
      float* C = pool + (int64_t)dst[d0 + m] * bb + s0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4* cp = reinterpret_cast<float4*>(C + (int64_t)(r0 + i) * bs + c0);
        float4 v = *cp;
        v.x -= p[i][0];
        v.y -= p[i][1];
        v.z -= p[i][2];
        v.w -= p[i][3];
        *cp = v;
      }
    }
    // the next U block of this column may be a target just written
    __syncthreads();
  }
}

// L(i,k) <- L(i,k) . uinv(k): a row-strip TRSM (strip.cuh), the same
// function as schur.cu's trsm with left = 0, launched and counted apart.
__global__ void __launch_bounds__(slu_strip::kMaxBs)
clk_trsm_kernel(float* __restrict__ pool, const float* __restrict__ uinv,
                const int32_t* __restrict__ lslots,
                const int32_t* __restrict__ lsteps, int bs) {
  slu_strip::strip_update<float>(pool, uinv, uinv, lslots[blockIdx.x],
                                 lsteps[blockIdx.x], slu_strip::FIN_L,
                                 nullptr, nullptr, 0, 0, bs, blockIdx.y);
}

}  // namespace

extern "C" int slu_clk_update_f32(void* pool, const void* linv,
                                  const void* cols, int ncols,
                                  const void* col_base, const void* col_dpos,
                                  const void* col_job0, const void* job_src,
                                  const void* job_la0, const void* job_lm,
                                  const void* job_dst0, const void* dst,
                                  int bs, void* stream) {
  if (ncols == 0) return 0;
  const dim3 grid(ncols, bs / TN);
  const int threads = (bs / 4) * (TN / 4);
  const size_t smem = (size_t)bs * TN * sizeof(float);
  clk_update_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (float*)pool, (const float*)linv, (const int32_t*)cols,
      (const int32_t*)col_base, (const int32_t*)col_dpos,
      (const int32_t*)col_job0, (const int32_t*)job_src,
      (const int32_t*)job_la0, (const int32_t*)job_lm,
      (const int32_t*)job_dst0, (const int32_t*)dst, bs);
  return (int)cudaGetLastError();
}

extern "C" int slu_clk_trsm_f32(void* pool, const void* uinv,
                                const void* lslots, const void* lsteps,
                                int count, int bs, void* stream) {
  if (count == 0) return 0;
  const dim3 grid(count, bs / slu_strip::kStrip);
  clk_trsm_kernel<<<grid, bs, 0, (cudaStream_t)stream>>>(
      (float*)pool, (const float*)uinv, (const int32_t*)lslots,
      (const int32_t*)lsteps, bs);
  return (int)cudaGetLastError();
}
