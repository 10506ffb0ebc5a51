// sweep.cu: one level of a block triangular sweep.
//
// Replaces: superlu_dist_tpu/ops/kernels/pallas_exec.py::_sweep_kernel
// (called through make_sweep_call), the TPU's whole-sweep solve kernel,
// whose op 0 is X[dst] -= pool[slot] . X[src] and op 1 is
// X[row] = dinv[row] . X[row].
//
// What it computes, for each block row I of one level of the L (or U)
// sweep, with X of shape (nb, bs, nrhs):
//   acc = X[I] - sum over I's contributions (slot, src) of pool[slot] . X[src]
//   X[I] = dinv[I] . acc
// Every contribution into I and I's diagonal apply sit in I's level, and
// every source row is at a lower level, so one launch per level on one
// stream keeps the sweep's order (the TPU relies on its sequential grid).
//
// What bounds it on an H100: bytes. Each stored block is read once per
// sweep and used for 2*bs^2*nrhs operations, far below the card's
// operations-per-byte balance.
//
// Design: one CTA per (block row, tile of up to RT right-hand sides);
// each CTA owns its row, so there are no atomics and the result is
// deterministic. The accumulator and the source tile live in shared
// memory (column major, so the lanes of a warp read consecutive words);
// each warp walks rows of the block with coalesced loads and reduces
// across its lanes with shuffles. IEEE FP32 throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RT = 8;          // right-hand sides per CTA
constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[r][c] = sum_k M[r][k] * V[c*bs + k] for the rows of this warp;
// lane 0 hands each row's sums to emit(r, sums).
template <typename Emit>
__device__ __forceinline__ void rows_times(const float* __restrict__ M,
                                           const float* V, int bs, int rt,
                                           Emit emit) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int r = warp; r < bs; r += nw) {
    float part[RT];
#pragma unroll
    for (int c = 0; c < RT; ++c) part[c] = 0.f;
    const float* m = M + (int64_t)r * bs;
    for (int k = lane; k < bs; k += 32) {
      const float a = __ldg(m + k);
#pragma unroll
      for (int c = 0; c < RT; ++c)
        if (c < rt) part[c] += a * V[c * bs + k];
    }
#pragma unroll
    for (int c = 0; c < RT; ++c)
      if (c < rt) part[c] = warp_sum(part[c]);
    if (lane == 0) emit(r, part);
  }
}

__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ pool, const float* __restrict__ dinv,
             float* __restrict__ X, const int32_t* __restrict__ rows,
             const int32_t* __restrict__ rowptr,
             const int32_t* __restrict__ cslot,
             const int32_t* __restrict__ csrc, int bs, int nrhs) {
  extern __shared__ float smem[];
  float* acc = smem;             // RT x bs, column major
  float* xs = smem + RT * bs;    // RT x bs, column major
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t bb = (int64_t)bs * bs;
  const int I = rows[blockIdx.x];
  const int c0 = blockIdx.y * RT;
  const int rt = min(RT, nrhs - c0);
  float* XI = X + (int64_t)I * bs * nrhs + c0;

  for (int e = tid; e < bs * rt; e += nt) {
    const int r = e / rt, c = e - r * rt;
    acc[c * bs + r] = XI[(int64_t)r * nrhs + c];
  }
  const int p0 = rowptr[blockIdx.x], p1 = rowptr[blockIdx.x + 1];
  for (int p = p0; p < p1; ++p) {
    const float* XS = X + (int64_t)csrc[p] * bs * nrhs + c0;
    for (int e = tid; e < bs * rt; e += nt) {
      const int r = e / rt, c = e - r * rt;
      xs[c * bs + r] = XS[(int64_t)r * nrhs + c];
    }
    __syncthreads();
    rows_times(pool + (int64_t)cslot[p] * bb, xs, bs, rt,
               [&](int r, const float* s) {
                 for (int c = 0; c < rt; ++c) acc[c * bs + r] -= s[c];
               });
    __syncthreads();
  }
  __syncthreads();
  rows_times(dinv + (int64_t)I * bb, acc, bs, rt,
             [&](int r, const float* s) {
               for (int c = 0; c < rt; ++c) XI[(int64_t)r * nrhs + c] = s[c];
             });
}

}  // namespace

extern "C" int slu_sweep_f32(const void* pool, const void* dinv, void* X,
                             const void* rows, const void* rowptr,
                             const void* cslot, const void* csrc, int count,
                             int bs, int nrhs, void* stream) {
  if (count == 0) return 0;
  const dim3 grid(count, (nrhs + RT - 1) / RT);
  const size_t smem = (size_t)2 * RT * bs * sizeof(float);
  sweep_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)pool, (const float*)dinv, (float*)X,
      (const int32_t*)rows, (const int32_t*)rowptr, (const int32_t*)cslot,
      (const int32_t*)csrc, bs, nrhs);
  return (int)cudaGetLastError();
}
