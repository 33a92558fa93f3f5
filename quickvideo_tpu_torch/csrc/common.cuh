// Shared device helpers for the Hopper kernels of quickvideo_tpu_torch.
//
// The tensor-core primitive is the warp-level mma.sync m16n8k16 with bf16
// operands and f32 accumulators (available on sm_80+, full-rate enough for a
// first, correct kernel; wgmma is a later optimisation). Fragment layout,
// with g = lane / 4 and t = lane % 4:
//   A (16x16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                         a2 = A[g][2t+8..+9],   a3 = A[g+8][2t+8..+9]
//   B (16x8,  B[k][n]):   b0 = B[2t..2t+1][g],   b1 = B[2t+8..+9][g]
//   C (16x8, f32):        c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
// Each 32-bit register holds two bf16 values, the lower index in the low half.
//
// The integer primitive is mma.sync m16n8k32 with s8 operands and s32
// accumulators. Each 32-bit register holds four int8 values:
//   A (16x32, row-major): a0 = A[g][4t..4t+3],    a1 = A[g+8][4t..4t+3],
//                         a2 = A[g][4t+16..+19],  a3 = A[g+8][4t+16..+19]
//   B (32x8,  B[k][n]):   b0 = B[4t..4t+3][g],    b1 = B[4t+16..+19][g]
//   C (16x8, s32):        as for bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace qv {

__device__ __forceinline__ void mma_bf16_16816(
    float c[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8_16832(
    int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (round to nearest even); lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 4 bytes (two bf16 or four int8 values) as one fragment register
template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float warp_max4(float x) {
  // max over the 4 lanes that share one accumulator row
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

__device__ __forceinline__ float warp_sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

}  // namespace qv
