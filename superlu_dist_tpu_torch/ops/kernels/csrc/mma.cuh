// mma.cuh: bf16 tensor-core products with float32 accumulation, for the
// low pass of the fused factors (waves.cuh's update, panel.cuh's TRSM,
// passes.cuh's chain product in flk.cu and tck.cu):
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 on fragments built
// from float32 operands staged in shared memory, or (B) read by ldmatrix
// from an operand rounded to bf16 once in shared memory.
//
// Replaces: the precision="default" dots of the TPU kernels
// (superlu_dist_tpu/ops/kernels/clk.py::_clk_kernel, its dot() at
// clk.py:257-259; tck.py::_tck_kernel, tck.py:226-228;
// flk.py::_flk_kernel, flk.py:439-441): one bf16 pass with float32
// accumulation, which the JAX package arms when refinement is configured
// and escalates from when refinement stalls.
//
// Each operand is rounded to bf16 (round to nearest even, as
// __floats2bfloat162_rn does and as torch's .to(torch.bfloat16) does)
// when its fragment is built; a product of two bf16 values is exact in
// float32, so the plain version (round both operands, multiply in
// float32) differs from these products only in the order of the sums.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16; lane = 4 * gid +
// tig): A (16 x 16, row major) in four registers of two values, rows gid
// and gid + 8, columns 2 tig, 2 tig + 1 and 8 more; B (16 x 8, k by n) in
// two, rows (k) 2 tig, 2 tig + 1 and 8 more, column gid; C (16 x 8,
// float32) rows gid and gid + 8, columns 2 tig, 2 tig + 1. The lower
// index of a pair sits in the low half of its register.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace slu_mma {

__device__ __forceinline__ int lane_gid() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_tig() { return threadIdx.x & 3; }

// x and y rounded to bf16, packed: x in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// d += a . b on one m16n8k16 tile, bf16 operands, float32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of rows r0 .. r0+15 and columns k0 .. k0+15 of a row-major
// float matrix in shared memory with an even leading dimension LDA.
template <int LDA>
__device__ __forceinline__ void frag_a(const float* A, int r0, int k0,
                                       uint32_t (&a)[4]) {
  const float* p = A + (r0 + lane_gid()) * LDA + k0 + 2 * lane_tig();
  const float2 v0 = *reinterpret_cast<const float2*>(p);
  const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * LDA);
  const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
  const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * LDA + 8);
  a[0] = pack_bf16(v0.x, v0.y);
  a[1] = pack_bf16(v1.x, v1.y);
  a[2] = pack_bf16(v2.x, v2.y);
  a[3] = pack_bf16(v3.x, v3.y);
}

// The B fragment of rows (k) k0 .. k0+15 and columns c0 .. c0+7 of a
// row-major (k, n) float matrix in shared memory with leading dimension
// LDB (with LDB = 4 mod 16 the rows 2 tig of a lane's group fall in
// distinct banks).
template <int LDB>
__device__ __forceinline__ void frag_b(const float* B, int k0, int c0,
                                       uint32_t (&b)[2]) {
  const float* p = B + (k0 + 2 * lane_tig()) * LDB + c0 + lane_gid();
  b[0] = pack_bf16(p[0], p[LDB]);
  b[1] = pack_bf16(p[8 * LDB], p[9 * LDB]);
}

// The B fragment of rows (k) k0 .. k0+15 and columns c0 .. c0+7 of a
// (k, n) float matrix held transposed in shared memory: element (k, n) at
// Bt[n * LDT + k], LDT even (with LDT = 4 mod 32 the pairs of a half
// warp fall in distinct banks).
template <int LDT>
__device__ __forceinline__ void frag_bt(const float* Bt, int k0, int c0,
                                        uint32_t (&b)[2]) {
  const float* p = Bt + (c0 + lane_gid()) * LDT + k0 + 2 * lane_tig();
  const float2 u = *reinterpret_cast<const float2*>(p);
  const float2 v = *reinterpret_cast<const float2*>(p + 8);
  b[0] = pack_bf16(u.x, u.y);
  b[1] = pack_bf16(v.x, v.y);
}

// The B fragments of two 16 x 8 tiles, rows (k) k0 .. k0+15 and columns c0
// .. c0+15, of a row-major (k, n) bf16 matrix in shared memory with leading
// dimension LDB (elements; 16-byte rows of 8): b[0], b[1] the columns c0 ..
// c0+7, b[2], b[3] the next 8, by one ldmatrix .trans (lane l gives the
// row k0 + (l & 7) + 8 ((l >> 3) & 1) of the columns c0 + 8 (l >> 4)).
// With rows of LDB * 2 bytes an odd multiple of 16, the eight rows of a
// matrix fall in distinct banks.
template <int LDB>
__device__ __forceinline__ void frag_b2_bf16(const uint16_t* B, int k0,
                                             int c0, uint32_t (&b)[4]) {
  const int l = threadIdx.x & 31;
  const uint16_t* p =
      B + (k0 + (l & 7) + 8 * ((l >> 3) & 1)) * LDB + c0 + 8 * (l >> 4);
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(a));
}

// The same for one tile (columns c0 .. c0+7): b[0], b[1].
template <int LDB>
__device__ __forceinline__ void frag_b1_bf16(const uint16_t* B, int k0,
                                             int c0, uint32_t (&b)[2]) {
  const int l = threadIdx.x & 15;
  const uint16_t* p = B + (k0 + (l & 7) + 8 * (l >> 3)) * LDB + c0;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(a));
}

// This lane's share of the 16 x 8 tile at (r0, c0) of a row-major float
// matrix with leading dimension LD (device or shared memory), in the C
// layout; 8-byte aligned pairs.
template <int LD>
__device__ __forceinline__ void load_c(const float* X, int r0, int c0,
                                       float (&c)[4]) {
  const float* p =
      X + (int64_t)(r0 + lane_gid()) * LD + c0 + 2 * lane_tig();
  const float2 u = *reinterpret_cast<const float2*>(p);
  const float2 v = *reinterpret_cast<const float2*>(p + 8 * (int64_t)LD);
  c[0] = u.x;
  c[1] = u.y;
  c[2] = v.x;
  c[3] = v.y;
}

template <int LD>
__device__ __forceinline__ void store_c(float* X, int r0, int c0,
                                        const float (&c)[4]) {
  float* p = X + (int64_t)(r0 + lane_gid()) * LD + c0 + 2 * lane_tig();
  *reinterpret_cast<float2*>(p) = make_float2(c[0], c[1]);
  *reinterpret_cast<float2*>(p + 8 * (int64_t)LD) = make_float2(c[2], c[3]);
}

// The same tile stored transposed: element (r, c) at Xt[c * LDT + r].
template <int LDT>
__device__ __forceinline__ void store_ct(float* Xt, int r0, int c0,
                                         const float (&c)[4]) {
  float* p = Xt + (c0 + 2 * lane_tig()) * LDT + r0 + lane_gid();
  p[0] = c[0];
  p[LDT] = c[1];
  p[8] = c[2];
  p[LDT + 8] = c[3];
}

// acc += A . B over a chunk of KC (a multiple of 16) k: this warp's WM x
// WN tiles of 16 x 8 at rows r0 + 16 i, columns c0 + 8 j; A row major
// (leading dimension LDA), B (k, n) row major (leading dimension LDB), or
// with BT held transposed (frag_bt, leading dimension LDB), both in
// shared memory. Each output's k run in steps of 16 in ascending order,
// each step summed by the tensor core.
template <int KC, int LDA, int LDB, int WM, int WN, bool BT = false>
__device__ __forceinline__ void mma_chunk(const float* A, const float* B,
                                          int r0, int c0,
                                          float (&acc)[WM][WN][4]) {
#pragma unroll
  for (int k = 0; k < KC; k += 16) {
    uint32_t a[WM][4];
#pragma unroll
    for (int i = 0; i < WM; ++i) frag_a<LDA>(A, r0 + 16 * i, k, a[i]);
    // one B fragment live at a time (all WN of them spilled 8 bytes in
    // the band of 64 rows at bs 128)
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      uint32_t b[2];
      if constexpr (BT)
        frag_bt<LDB>(B, k, c0 + 8 * j, b);
      else
        frag_b<LDB>(B, k, c0 + 8 * j, b);
#pragma unroll
      for (int i = 0; i < WM; ++i) mma_bf16(acc[i][j], a[i], b);
    }
  }
}

}  // namespace slu_mma
