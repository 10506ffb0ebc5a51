// diag_lu.cu: no-pivot LU with triangular inverses of a batch of
// diagonal tiles of the block pool.
//
// Replaces: superlu_dist_tpu/ops/kernels/flk.py::_lu_tile_blocked (with
// _lu_tile_inkernel), the device function that clk, tck and flk run on
// each diagonal block on the TPU.
//
// What it computes, per tile T = pool[slots[b]] (bs x bs, row major):
//   Doolittle LU without pivoting; a pivot with |p| < thresh becomes
//   sign(p)*thresh (+thresh at p == 0) and is counted (ReplaceTinyPivot,
//   reference pdgstrf2.c). The compact LU goes back into the tile,
//   L^{-1} into linv[steps[b]] and U^{-1} into uinv[steps[b]], and the
//   count of replaced pivots is added to *tiny.
//
// What bounds it on an H100: neither bytes (4 tiles of 64 KiB at bs=128)
// nor operations (~2.8 MFLOP a tile). It is latency: the elimination is a
// chain of bs dependent steps, each a rank-1 update with a barrier.
//
// Design: one CTA per tile; the tile and the inverse being built live in
// dynamic shared memory (2 x 64 KiB at bs=128), so the bs steps touch
// device memory only to load the tile and store the three results. L^{-1}
// is accumulated in the same forward sweep (each elimination step applies
// the same rank-1 update to it); U^{-1} follows by a right-looking
// backward sweep. All arithmetic is IEEE FP32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
diag_lu_kernel(float* __restrict__ pool, float* __restrict__ linv,
               float* __restrict__ uinv, const int32_t* __restrict__ slots,
               const int32_t* __restrict__ steps, int bs, int lg,
               float thresh, int32_t* __restrict__ tiny) {
  extern __shared__ float smem[];
  float* A = smem;                 // bs*bs: the tile, LU in place
  float* R = smem + bs * bs;       // bs*bs: L^{-1}, then U^{-1}
  float* lcol = R + bs * bs;       // bs: column of L at the current step
  __shared__ float piv_s;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int bb = bs * bs;
  const int msk = bs - 1;
  float* g = pool + (int64_t)slots[blockIdx.x] * bb;
  const int64_t step = steps[blockIdx.x];

  for (int e = tid; e < bb; e += nt) {
    A[e] = g[e];
    R[e] = ((e >> lg) == (e & msk)) ? 1.f : 0.f;
  }
  int ntiny = 0;
  __syncthreads();

  for (int j = 0; j < bs; ++j) {
    if (tid == 0) {
      float p = A[j * bs + j];
      const float ap = fabsf(p);
      if (ap < thresh) {
        p = ap > 0.f ? copysignf(thresh, p) : thresh;
        A[j * bs + j] = p;
        ++ntiny;
      }
      piv_s = p;
    }
    __syncthreads();
    const float p = piv_s;
    for (int i = j + 1 + tid; i < bs; i += nt) lcol[i] = A[i * bs + j] / p;
    __syncthreads();
    // rows below j: trailing update of A right of j, the rank-1 update of
    // L^{-1} left of and at j, and the L entry itself at column j
    const int cnt = (bs - j - 1) * bs;
    for (int e = tid; e < cnt; e += nt) {
      const int i = j + 1 + (e >> lg);
      const int c = e & msk;
      const float l = lcol[i];
      if (c > j) {
        A[i * bs + c] -= l * A[j * bs + c];
      } else {
        if (c == j) A[i * bs + j] = l;
        R[i * bs + c] -= l * R[j * bs + c];
      }
    }
    __syncthreads();
  }

  float* gl = linv + step * bb;
  for (int e = tid; e < bb; e += nt) {
    g[e] = A[e];
    gl[e] = R[e];
    R[e] = ((e >> lg) == (e & msk)) ? 1.f : 0.f;
  }
  if (tid == 0 && ntiny) atomicAdd(tiny, ntiny);
  __syncthreads();

  // U X = I by right-looking back substitution: row j of X is final once
  // divided by U[j][j]; then it is eliminated from the rows above.
  for (int j = bs - 1; j >= 0; --j) {
    const float d = A[j * bs + j];
    for (int c = j + tid; c < bs; c += nt) R[j * bs + c] /= d;
    __syncthreads();
    const int w = bs - j;
    const int cnt = j * w;
    for (int e = tid; e < cnt; e += nt) {
      const int i = e / w;
      const int c = j + (e - i * w);
      R[i * bs + c] -= A[i * bs + j] * R[j * bs + c];
    }
    __syncthreads();
  }
  float* gu = uinv + step * bb;
  for (int e = tid; e < bb; e += nt) gu[e] = R[e];
}

}  // namespace

extern "C" int slu_diag_lu_f32(void* pool, void* linv, void* uinv,
                               const void* slots, const void* steps,
                               int count, int bs, float thresh, void* tiny,
                               void* stream) {
  int lg = 0;
  while ((1 << lg) < bs) ++lg;
  const size_t smem = (size_t)(2 * bs * bs + bs) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      diag_lu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (count == 0) return 0;
  diag_lu_kernel<<<count, kThreads, smem, (cudaStream_t)stream>>>(
      (float*)pool, (float*)linv, (float*)uinv, (const int32_t*)slots,
      (const int32_t*)steps, bs, lg, thresh, (int32_t*)tiny);
  return (int)cudaGetLastError();
}
