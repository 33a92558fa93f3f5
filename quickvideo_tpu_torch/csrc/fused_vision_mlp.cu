// Kernels B3, B4 and B6: the int8 vision tower's fused projections, for
// Hopper (sm_90a).
//
// Replace the TPU kernels of quickvideo_tpu/ops/fused_vision_mlp.py:
//   B3 _ln_gemm_kernel (entry ln_gemm_bias): rmsnorm * ln_w -> per-row int8
//      quantize -> s8 x s8 GEMM -> bf16((acc * xs) * sc) + b, (S, N) bf16;
//   B4 _ln_kernel (entry ln_dual_gemm_silu_quant): the same prologue and
//      GEMM against [wg | wu], then silu(g) * u in f32 and a per-row int8
//      requantize, (S, Np) int8 + (S,) f32 scales;
//   B6 _kernel (entry dual_gemm_silu_quant): B4 from a pre-quantized input.
//
// Rounding points follow the TPU kernels exactly: the normed row and its
// product with ln_w are each rounded to bf16 (round to nearest even); the
// row scale is max(|h|, 1e-8) / 127 and codes are clip(rint(h / s)); the
// epilogue rounds (acc * xs) * sc to bf16 before the bf16 bias add; silu is
// g * (1 / (1 + exp(-g))) in f32. The row sums and expf differ from XLA's
// by ulps, so a code can flip by one at a rounding boundary.
//
// Operands. Both GEMM operands are K-major, as s8 wgmma takes them: the
// quantized rows (S, C) row-major and the weight, the (out, in) row-major
// int8 tensor. Each is read by TMA through a 2D tensor map in boxes of 128
// bytes of K under the 128-byte swizzle; rows past S, weight rows past N
// and K past C read as zeros, which add nothing to the product.
//
// Design.
//  * Prologue (B3, B4), a launch of its own: one warp per row normalizes,
//    rounds and quantizes the raw row into an int8 row scratch (S, C) plus
//    its f32 scale. Its row-wide sum and max would otherwise be repeated
//    in every CTA of a row band; it is bytes-bound (37 MB in, 18 MB out at
//    the 7B group shape).
//  * GEMM core: one producer warpgroup, whose first thread keeps a ring of
//    stages full by TMA (each stage: the A box of the CTA's rows and the
//    weight box(es) of its output columns for 128 bytes of K, under full /
//    empty mbarriers), and consumer warpgroups of 64 rows that issue wgmma
//    m64nNk32 s8 x s8 -> s32 on the shared stages, the next stage's product
//    issued before the previous stage is released. K streams through the
//    ring, so C is not bounded by shared memory. The operands are re-read
//    from L2 (the weight once per row band, the row codes once per column
//    tile or chunk). Measured on an H100, sharing them across a cluster by
//    TMA multicast was slower in both kernels (the cluster's CTAs then
//    move in lockstep), and so was a second accumulator set that overlaps
//    B4's epilogue with the next chunk's products.
//  * B3 (gemm_bias_kernel): tiles of 128 rows x 256 output columns, two
//    consumer warpgroups sharing each weight stage; a persistent grid (one
//    CTA per SM walks the tiles), so the producer fills the next tile's
//    stages while the consumers write the last tile's bf16 pairs straight
//    from the accumulators. setmaxnreg moves registers to the consumers
//    (128 s32 accumulators each).
//  * B4/B6 (gemm_silu_quant_kernel<kW>): the requantize needs the max of
//    |silu(g) * u| over all Np columns of a row, so a thread-block cluster
//    along the output columns shares each row band of 128 rows (two
//    consumer warpgroups of 64 rows, sharing each weight stage).
//    The band's Np columns are chunks of kW (64 or 72) gate columns and the
//    kW up columns that pair with them (two TMA boxes, one in each half of
//    [wg | wu], so one m64n(2 kW) product holds both and each thread forms
//    silu(g) * u from its own accumulators); the cluster's CTAs take the
//    chunks round-robin. Each CTA keeps its slice of silu(g) * u in f32 in
//    shared memory and its per-row |max|; after a cluster barrier each CTA
//    reads the other CTAs' maxima through distributed shared memory,
//    quantizes its slice from shared memory with the row scale and writes
//    the codes; the cluster's rank 0 writes the scale. Nothing of
//    silu(g) * u goes through device memory. ops/fused_vision_mlp.py::
//    mlp_plan picks the chunk width, cluster size and ring depth.
//
// What bounds it. At the 7B group shape (S = 14,400, C = 1280, N = 3840 or
// 2 x 3456) the GEMM is 141.6 / 254.8 G int-ops, 0.0715 / 0.1288 ms at the
// int8 tensor-core peak; the data is 37 MB of input rows, 5 / 9 MB of
// weights and 111 MB (B3 output) or 50 MB (B4 codes), 0.03-0.05 ms at the
// HBM rate: operations bound both. The weight is read again from L2 for
// every row band and the row codes for every column tile or chunk.
#include "common.cuh"

namespace {

using qv::align1024;
using qv::bar_sync;
using qv::mbar_arrive;
using qv::mbar_expect_tx;
using qv::mbar_init;
using qv::mbar_wait;
using qv::smem_u32;
using qv::sw128_desc;
using qv::tma_load_2d;

constexpr int kKB = 128;      // bytes of K per ring stage: one swizzled box row
constexpr float kEps = 1e-8f;

// B3: tiles of 128 rows x 256 columns, a 4-stage ring of 48 KB stages
constexpr int kB3WG = 2;
constexpr int kB3BM = 64 * kB3WG;
constexpr int kB3BN = 256;
constexpr int kB3Stages = 4;
constexpr int kB3A = kB3BM * kKB;
constexpr int kB3Stage = kB3A + kB3BN * kKB;
constexpr int kB3Smem = 1024 + kB3Stages * kB3Stage + 2 * kB3Stages * 8;

// B4/B6: chunks of kW (64 or 72) gate columns and their kW up columns.
// Row bands of 128 rows: two consumer warpgroups. Shared memory of
// gemm_silu_quant_kernel<w> with `stages` ring stages and `nch` chunks per
// CTA (mirrored by ops/fused_vision_mlp.py::mlp_smem): alignment slack,
// ring, f32 slices, row maxima and scales, barriers
constexpr int kMlpWG = 2;
constexpr int kMlpBM = 64 * kMlpWG;

__host__ __device__ constexpr int mlp_smem(int w, int stages, int nch) {
  return 1024 + stages * (kMlpBM + 2 * w) * kKB + nch * kMlpBM * w * 4 +
         2 * kMlpBM * 4 + 2 * stages * 8;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int quant(float v, float s) {
  return max(-127, min(127, __float2int_rn(v / s)));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) |
         ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) |
         ((static_cast<uint32_t>(d) & 0xffu) << 24);
}

// -- thread-block clusters ----------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster arrives (release) / waits
// (acquire); arrive and wait may be apart
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the f32 at `p` in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// B3/B4 prologue: normalize, round and quantize each raw row into the
// int8 row scratch; one warp per row, each lane 8 columns at a time, the
// row held in registers (kI 16-byte pieces per lane: C <= 256 kI), so it is
// read from device memory once. The normed values are recomputed for the
// max and for the codes rather than kept (cheaper than 8 kI registers).
template <int kI>
__global__ void __launch_bounds__(256) ln_quantize_reg_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ lnw,
    int8_t* __restrict__ xq, float* __restrict__ xs_out, int s_len, int c,
    float eps) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= s_len) return;
  const __nv_bfloat16* xr = x + static_cast<size_t>(row) * c;
  uint4 v[kI];
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int k = lane * 8 + i * 256;
    v[i] = k < c ? *reinterpret_cast<const uint4*>(xr + k) : make_uint4(0, 0, 0, 0);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = __bfloat162float(e[j]);
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  const float rs = 1.0f / sqrtf(ss / static_cast<float>(c) + eps);
  // the normed, ln_w-scaled value of element j of piece i, twice rounded
  auto h_of = [&](int i, int j, float w) {
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[i]);
    return bf16_round(bf16_round(__bfloat162float(e[j]) * rs) * w);
  };
  float am = 0.0f;
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int k = lane * 8 + i * 256;
    if (k >= c) continue;
    const float4 w0 = *reinterpret_cast<const float4*>(lnw + k);
    const float4 w1 = *reinterpret_cast<const float4*>(lnw + k + 4);
    const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) am = fmaxf(am, fabsf(h_of(i, j, w[j])));
  }
  am = warp_max(am);
  const float xs = fmaxf(am, kEps) / 127.0f;
  int8_t* qr = xq + static_cast<size_t>(row) * c;
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int k = lane * 8 + i * 256;
    if (k >= c) continue;
    const float4 w0 = *reinterpret_cast<const float4*>(lnw + k);
    const float4 w1 = *reinterpret_cast<const float4*>(lnw + k + 4);
    const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    int q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) q[j] = quant(h_of(i, j, w[j]), xs);
    *reinterpret_cast<uint2*>(qr + k) =
        make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
  }
  if (lane == 0) xs_out[row] = xs;
}

constexpr int kRegPieces = 8;  // ln_quantize_reg_kernel: rows up to 2048

// B3/B4 prologue for rows wider than ln_quantize_reg_kernel holds: the
// same arithmetic, the row read three times (sum of squares, max, codes),
// from L1/L2.
__global__ void __launch_bounds__(256) ln_quantize_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ lnw,
    int8_t* __restrict__ xq, float* __restrict__ xs_out, int s_len, int c,
    float eps) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= s_len) return;
  const __nv_bfloat16* xr = x + static_cast<size_t>(row) * c;
  int8_t* qr = xq + static_cast<size_t>(row) * c;
  float ss = 0.0f;
  for (int k = lane * 8; k < c; k += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + k);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float f = __bfloat162float(e[i]);
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  const float rs = 1.0f / sqrtf(ss / static_cast<float>(c) + eps);
  float am = 0.0f;
  for (int pass = 0; pass < 2; ++pass) {
    const float xs = fmaxf(am, kEps) / 127.0f;
    for (int k = lane * 8; k < c; k += 256) {
      const uint4 v = *reinterpret_cast<const uint4*>(xr + k);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
      float h[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float t = bf16_round(__bfloat162float(e[i]) * rs);
        h[i] = bf16_round(t * lnw[k + i]);
      }
      if (pass == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) am = fmaxf(am, fabsf(h[i]));
      } else {
        uint32_t w0 = 0, w1 = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          w0 |= (static_cast<uint32_t>(quant(h[i], xs)) & 0xffu) << (8 * i);
          w1 |= (static_cast<uint32_t>(quant(h[i + 4], xs)) & 0xffu)
                << (8 * i);
        }
        *reinterpret_cast<uint2*>(qr + k) = make_uint2(w0, w1);
      }
    }
    if (pass == 0) am = warp_max(am);
    else if (lane == 0) xs_out[row] = xs;
  }
}

// D (64 x 128, s32) = A (64 x 32, s8) B (32 x 128, s8) + (scale_d ? D : 0);
// A and B K-major in shared memory; exact
__device__ __forceinline__ void wgmma_m64n128k32_s8(
    uint32_t (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 144, s32) = A (64 x 32, s8) B (32 x 144, s8) + (scale_d ? D : 0);
// A and B K-major in shared memory; exact
__device__ __forceinline__ void wgmma_m64n144k32_s8(
    uint32_t (&d)[72], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 256, s32) = A (64 x 32, s8) B (32 x 256, s8) + (scale_d ? D : 0);
// A and B K-major in shared memory; exact
__device__ __forceinline__ void wgmma_m64n256k32_s8(
    uint32_t (&d)[128], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}


template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int kN>
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[kN / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(kN == 128 || kN == 144 || kN == 256, "no such s8 wgmma here");
  if constexpr (kN == 256) {
    wgmma_m64n256k32_s8(d, da, db, scale_d);
  } else if constexpr (kN == 144) {
    wgmma_m64n144k32_s8(d, da, db, scale_d);
  } else {
    wgmma_m64n128k32_s8(d, da, db, scale_d);
  }
}

// A consumer warpgroup's product over nk stages into acc (64 rows x kN):
// four k32 steps per stage, 32 bytes apart within the swizzled rows; stage
// t's products are issued before stage t - 1's slot is released (lane 0 of
// each warp arrives), so the tensor cores never wait on the release. Every
// warpgroup runs every product (rows past S are zeros): a wgmma on a
// divergent path would make ptxas serialize the pipeline.
template <int kN>
__device__ __forceinline__ void consume(uint32_t (&acc)[kN / 2],
                                        unsigned char* ring, int stage_bytes,
                                        int a_off, int a_bytes, int stages,
                                        uint64_t* full, uint64_t* empty,
                                        int nk, int lane, int& it) {
  for (int kt = 0; kt < nk; ++kt, ++it) {
    const int st = it % stages;
    mbar_wait(&full[st], (it / stages) & 1);
    unsigned char* slot = ring + st * stage_bytes;
    const uint64_t da = sw128_desc(slot + a_off, 16);
    const uint64_t db = sw128_desc(slot + a_bytes, 16);
    reg_fence(acc);
    qv::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKB / 32; ++kk) {
      wgmma_s8<kN>(acc, da + kk * 2, db + kk * 2, kt > 0 || kk > 0);
    }
    qv::wgmma_commit();
    if (kt > 0) {
      qv::wgmma_wait<1>();
      reg_fence(acc);
      if (lane == 0) mbar_arrive(&empty[(it - 1) % stages]);
    }
  }
  qv::wgmma_wait<0>();
  reg_fence(acc);
  if (lane == 0) mbar_arrive(&empty[(it - 1) % stages]);
}

struct GemmArgs {
  const float* xs;              // (S,) row scales of the quantized rows
  const float* sc;              // (N_total,) weight column scales
  const __nv_bfloat16* bias;    // (N_total,)
  void* out;                    // B3: (S, N) bf16; B4/B6: (S, Np) int8
  float* qs;                    // B4/B6: (S,) row scales of the codes
  int s_len, c, n;              // n: N (B3) or Np (B4/B6)
  int stages, nch, cluster;     // B4/B6: ring stages, chunks per CTA, CTAs
};

// The ring's barriers: full (one producer arrival plus the transaction
// bytes), empty (lane 0 of every consumer warp)
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int stages, int consumer_warps) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer thread's loads for one unit of work: nk stages, each the A
// box of a_row and the weight boxes of w_row0 (and w_row1 when >= 0), 128
// bytes of K apiece; `it` counts stages across units
__device__ __forceinline__ void produce(const CUtensorMap* ta,
                                        const CUtensorMap* tw,
                                        unsigned char* ring, int stage_bytes,
                                        int a_bytes, int w_half, int stages,
                                        uint64_t* full, uint64_t* empty,
                                        int nk, int a_row, int w_row0,
                                        int w_row1, int& it) {
  for (int kt = 0; kt < nk; ++kt, ++it) {
    const int st = it % stages;
    // the slot's previous stage released by every consumer warp
    if (it >= stages) mbar_wait(&empty[st], (it / stages - 1) & 1);
    mbar_expect_tx(&full[st], stage_bytes);
    unsigned char* slot = ring + st * stage_bytes;
    tma_load_2d(slot, ta, kt * kKB, a_row, &full[st]);
    tma_load_2d(slot + a_bytes, tw, kt * kKB, w_row0, &full[st]);
    if (w_row1 >= 0) {
      tma_load_2d(slot + a_bytes + w_half, tw, kt * kKB, w_row1, &full[st]);
    }
  }
}

// B3: the persistent grid walks tiles t = blockIdx.x, + gridDim.x, ...;
// tile t is row band t / ntn and column tile t % ntn, so the CTAs in
// flight share row bands. Each consumer warpgroup owns 64 rows of the
// band and all 256 columns (128 s32 accumulators per thread).
__global__ void __launch_bounds__(128 * (kB3WG + 1), 1)
gemm_bias_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tw, const GemmArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kB3Stages * kB3Stage);
  uint64_t* empty = full + kB3Stages;
  const int wg = threadIdx.x >> 7;
  const int ntn = (p.n + kB3BN - 1) / kB3BN;
  const int ntiles = (p.s_len + kB3BM - 1) / kB3BM * ntn;
  const int nk = (p.c + kKB - 1) / kKB;
  init_ring(full, empty, kB3Stages, 4 * kB3WG);

  if (wg == kB3WG) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kB3WG * 128) {
      int it = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        produce(&ta, &tw, ring, kB3Stage, kB3A, 0, kB3Stages, full, empty,
                nk, t / ntn * kB3BM, t % ntn * kB3BN, -1, it);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16* bias = p.bias;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  uint32_t acc[kB3BN / 2];
  int it = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    consume<kB3BN>(acc, ring, kB3Stage, wg * 64 * kKB, kB3A, kB3Stages, full,
                   empty, nk, lane, it);
    // bf16((acc * xs) * sc) + b, in the JAX order, stored as bf16 pairs
    const int row0 = t / ntn * kB3BM + 64 * wg + 16 * warp + g;
    const int col0 = t % ntn * kB3BN + 2 * t4;
    float xr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xr[h] = row0 + 8 * h < p.s_len ? p.xs[row0 + 8 * h] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kB3BN / 8; ++j) {
      const int col = col0 + 8 * j;
      if (col >= p.n) continue;  // N % 8 == 0: col + 1 < N as well
      const float2 s2 = *reinterpret_cast<const float2*>(p.sc + col);
      const float b0 = __bfloat162float(bias[col]);
      const float b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= p.s_len) continue;
        const float y0 = bf16_round(
            (static_cast<float>(static_cast<int>(acc[4 * j + 2 * h])) * xr[h]) * s2.x);
        const float y1 = bf16_round(
            (static_cast<float>(static_cast<int>(acc[4 * j + 2 * h + 1])) * xr[h]) * s2.y);
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * p.n + col) =
            __floats2bfloat162_rn(y0 + b0, y1 + b1);
      }
    }
  }
}

// Offset (in floats) of 8-column group j of local row lr in a chunk's f32
// slice of kW columns. 64 columns: the group index XOR the row's low bits
// (rows 256 bytes apart would put a warp's eight rows on the same banks);
// 72: plain rows, 288 bytes apart, already spread over the banks.
template <int kW>
__device__ __forceinline__ int slice_off(int lr, int j) {
  if constexpr (kW == 64) {
    return lr * kW + ((j ^ (lr & 7)) << 3);
  } else {
    return lr * kW + (j << 3);
  }
}

// B4/B6: grid (cluster x bands), clusters of p.cluster CTAs along x, all
// on one row band; the CTA of cluster rank r takes chunk slots r, r +
// cluster, ... (p.nch of them; a slot past the last chunk is skipped).
// One f32 slice of 128 rows x kW columns per chunk.
template <int kW>
__global__ void __launch_bounds__(128 * (kMlpWG + 1), 1)
gemm_silu_quant_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tw,
                       const GemmArgs p) {
  constexpr int kWG = kMlpWG;
  constexpr int kBM = kMlpBM;
  constexpr int kA = kBM * kKB;
  constexpr int kStage = kA + 2 * kW * kKB;
  constexpr int kGroups = kW / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  float* slice = reinterpret_cast<float*>(ring + p.stages * kStage);
  float* rowmax = slice + p.nch * kBM * kW;
  float* rscale = rowmax + kBM;
  uint64_t* full = reinterpret_cast<uint64_t*>(rscale + kBM);
  uint64_t* empty = full + p.stages;
  const int wg = threadIdx.x >> 7;
  const int cl = p.cluster;
  const int rank = static_cast<int>(cluster_rank());
  const int band = blockIdx.x / cl;
  const int m = p.n / kW;
  const int mine = rank < m ? (m - 1 - rank) / cl + 1 : 0;  // chunks
  const int nk = (p.c + kKB - 1) / kKB;
  init_ring(full, empty, p.stages, 4 * kWG);

  if (wg == kWG) {  // the producer warpgroup
    if (threadIdx.x == kWG * 128) {
      int it = 0;
      for (int i = 0; i < mine; ++i) {
        const int ch = rank + i * cl;
        produce(&ta, &tw, ring, kStage, kA, kW * kKB, p.stages, full, empty,
                nk, band * kBM, ch * kW, p.n + ch * kW, it);
      }
    }
    // the cluster barriers of the consumers below
    cluster_arrive();
    cluster_wait();
    cluster_arrive();
    cluster_wait();
    return;
  }

  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int lr0 = 64 * wg + 16 * warp + g;  // this thread's rows lr0, lr0 + 8
  float xr[2], rm[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = band * kBM + lr0 + 8 * h;
    xr[h] = row < p.s_len ? p.xs[row] : 0.f;
  }
  uint32_t acc[kW];  // 64 rows x 2 kW columns: kW gate, then kW up
  int it = 0;
  for (int i = 0; i < mine; ++i) {
    const int ch = rank + i * cl;
    consume<2 * kW>(acc, ring, kStage, wg * 64 * kKB, kA, p.stages, full,
                    empty, nk, lane, it);
    // gate column 8j + 2t4 + e sits in acc[4j + 2h + e], its up column in
    // acc[4(j + kGroups) + 2h + e]: silu(g) * u from this thread's
    // registers, into the slice and the rows' |max|
    float* sl = slice + i * kBM * kW;
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int gc = ch * kW + 8 * j + 2 * t4;
      const int uc = p.n + gc;
      const float2 sg = *reinterpret_cast<const float2*>(p.sc + gc);
      const float2 su = *reinterpret_cast<const float2*>(p.sc + uc);
      const float bg[2] = {__bfloat162float(p.bias[gc]),
                           __bfloat162float(p.bias[gc + 1])};
      const float bu[2] = {__bfloat162float(p.bias[uc]),
                           __bfloat162float(p.bias[uc + 1])};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float gv = bf16_round(
              bf16_round((static_cast<float>(static_cast<int>(acc[4 * j + 2 * h + e])) *
                          xr[h]) * (e ? sg.y : sg.x)) + bg[e]);
          const float uv = bf16_round(
              bf16_round((static_cast<float>(static_cast<int>(
                              acc[4 * (j + kGroups) + 2 * h + e])) *
                          xr[h]) * (e ? su.y : su.x)) + bu[e]);
          mv[e] = gv * (1.0f / (1.0f + expf(-gv))) * uv;
        }
        const int lr = lr0 + 8 * h;
        *reinterpret_cast<float2*>(sl + slice_off<kW>(lr, j) + 2 * t4) =
            make_float2(mv[0], mv[1]);
        rm[h] = fmaxf(rm[h], fmaxf(fabsf(mv[0]), fabsf(mv[1])));
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rm[h] = qv::warp_max4(rm[h]);
    if (t4 == 0) rowmax[lr0 + 8 * h] = rm[h];
  }
  cluster_arrive();  // this CTA's row maxima written
  cluster_wait();    // ... and every other CTA's
  const int ct = threadIdx.x;  // 0 .. 128 * kWG - 1
  if (ct < kBM) {
    float a = 0.f;
    for (int r = 0; r < cl; ++r) a = fmaxf(a, ld_cluster(rowmax + ct, r));
    const float s = fmaxf(a, kEps) / 127.0f;
    rscale[ct] = s;
    const int row = band * kBM + ct;
    if (rank == 0 && row < p.s_len) p.qs[row] = s;
  }
  cluster_arrive();  // done reading the other CTAs' maxima
  bar_sync(1, 128 * kWG);  // rscale written
  int8_t* q = static_cast<int8_t*>(p.out);
  for (int i = 0; i < mine; ++i) {
    const int ch = rank + i * cl;
    const float* sl = slice + i * kBM * kW;
    for (int e = ct; e < kBM * kGroups; e += 128 * kWG) {  // 8 columns of a row
      const int lr = e / kGroups, j = e - lr * kGroups;
      const int row = band * kBM + lr;
      if (row >= p.s_len) continue;
      const float s = rscale[lr];
      const float* src = sl + slice_off<kW>(lr, j);
      const float4 v0 = *reinterpret_cast<const float4*>(src);
      const float4 v1 = *reinterpret_cast<const float4*>(src + 4);
      *reinterpret_cast<uint2*>(q + static_cast<size_t>(row) * p.n + ch * kW + 8 * j) =
          make_uint2(pack4(quant(v0.x, s), quant(v0.y, s), quant(v0.z, s), quant(v0.w, s)),
                     pack4(quant(v1.x, s), quant(v1.y, s), quant(v1.z, s), quant(v1.w, s)));
    }
  }
  cluster_wait();  // no CTA leaves while another may still read its maxima
}

cudaError_t launch_ln_quantize(const void* x, const void* lnw, void* xq,
                               void* xs, int s_len, int c, float eps,
                               cudaStream_t stream) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* w = static_cast<const float*>(lnw);
  if (c <= 256 * kRegPieces) {
    ln_quantize_reg_kernel<kRegPieces><<<(s_len + 7) / 8, 256, 0, stream>>>(
        xb, w, static_cast<int8_t*>(xq), static_cast<float*>(xs), s_len, c, eps);
  } else {
    ln_quantize_kernel<<<(s_len + 7) / 8, 256, 0, stream>>>(
        xb, w, static_cast<int8_t*>(xq), static_cast<float*>(xs), s_len, c, eps);
  }
  return cudaGetLastError();
}

// The tensor map of (rows, c) int8 rows, row-major: dims (c, rows), boxes
// of 128 bytes x box_rows, 128-byte swizzle; zeros past either end
cudaError_t rows_map(CUtensorMap* map, const void* base, int c, int rows,
                     int box_rows) {
  const qv::EncodeTiled encode = qv::encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)c, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)c};
  const cuuint32_t box[2] = {(cuuint32_t)kKB, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

GemmArgs args_of(const void* xs, const void* sc, const void* b, void* out,
                 void* qs, int s_len, int c, int n) {
  GemmArgs p = {};
  p.xs = static_cast<const float*>(xs);
  p.sc = static_cast<const float*>(sc);
  p.bias = static_cast<const __nv_bfloat16*>(b);
  p.out = out;
  p.qs = static_cast<float*>(qs);
  p.s_len = s_len;
  p.c = c;
  p.n = n;
  return p;
}

cudaError_t launch_gemm_bias(const void* xq, const void* xs, const void* w,
                             const void* sc, const void* b, void* out,
                             int s_len, int c, int n, int grid,
                             cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_bias_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kB3Smem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap ta, tw;
  cudaError_t err = rows_map(&ta, xq, c, s_len, kB3BM);
  if (err == cudaSuccess) err = rows_map(&tw, w, c, n, kB3BN);
  if (err != cudaSuccess) return err;
  gemm_bias_kernel<<<grid, 128 * (kB3WG + 1), kB3Smem, stream>>>(
      ta, tw, args_of(xs, sc, b, out, nullptr, s_len, c, n));
  return cudaGetLastError();
}

// the B4/B6 instantiations, by chunk width
const void* mlp_instance(int w) {
  if (w == 64) return reinterpret_cast<const void*>(gemm_silu_quant_kernel<64>);
  if (w == 72) return reinterpret_cast<const void*>(gemm_silu_quant_kernel<72>);
  return nullptr;
}

// gemm_silu_quant_kernel<w> with its shared memory and non-portable
// cluster sizes opted into (once per instantiation and size)
cudaError_t mlp_kernel(int w, int smem, const void** kernel) {
  static int opted[2] = {0, 0};
  *kernel = mlp_instance(w);
  if (*kernel == nullptr) return cudaErrorInvalidValue;
  int& done = opted[w == 72];
  if (smem > done) {
    cudaError_t err = cudaFuncSetAttribute(
        *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          *kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return err;
    done = smem;
  }
  return cudaSuccess;
}

cudaLaunchConfig_t mlp_config(int cluster, int bands, int smem,
                              cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * bands);
  cfg.blockDim = dim3(128 * (kMlpWG + 1));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t launch_silu_quant(const void* xq, const void* xs, const void* w,
                              const void* sc, const void* b, void* q,
                              void* qs, int s_len, int c, int np, int chunk, int cluster, int nch, int stages,
                              cudaStream_t stream) {
  if (chunk <= 0 || np % chunk || cluster < 1 || cluster > 16 || stages < 2 ||
      (np / chunk + cluster - 1) / cluster > nch) {
    return cudaErrorInvalidValue;
  }
  const int smem = mlp_smem(chunk, stages, nch);
  const void* kernel;
  cudaError_t err = mlp_kernel(chunk, smem, &kernel);
  CUtensorMap ta, tw;
  if (err == cudaSuccess) err = rows_map(&ta, xq, c, s_len, kMlpBM);
  if (err == cudaSuccess) err = rows_map(&tw, w, c, 2 * np, chunk);
  if (err != cudaSuccess) return err;
  GemmArgs p = args_of(xs, sc, b, q, qs, s_len, c, np);
  p.stages = stages;
  p.nch = nch;
  p.cluster = cluster;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = mlp_config(
      cluster, (s_len + kMlpBM - 1) / kMlpBM, smem, stream, &attr);
  void* args[] = {&ta, &tw, &p};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// B3. x (S, C) bf16, lnw (C,) f32, w (N, C) int8, sc (N,) f32, b (N,) bf16;
// scratch xq (S, C) int8, xs (S,) f32 -> out (S, N) bf16. C % 32 == 0,
// N % 8 == 0; grid: the persistent CTAs (ops/fused_vision_mlp.py::b3_grid).
extern "C" int qv_ln_gemm_bias(const void* x, const void* lnw, const void* w,
                               const void* sc, const void* b, void* xq,
                               void* xs, void* out, int s_len, int c, int n,
                               float eps, int grid, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_ln_quantize(x, lnw, xq, xs, s_len, c, eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_gemm_bias(xq, xs, w, sc, b, out, s_len, c, n, grid, st));
}

// B4. x (S, C) bf16, lnw (C,) f32, w (2*Np, C) int8, sc/b (2*Np,); scratch
// xq (S, C) int8, xs (S,) f32 -> q (S, Np) int8, s (S,) f32. The plan
// (ops/fused_vision_mlp.py::mlp_plan): chunks of `chunk` gate columns,
// clusters of `cluster` CTAs, at most nch chunks per CTA, `stages` ring
// stages.
extern "C" int qv_ln_dual_gemm_silu_quant(
    const void* x, const void* lnw, const void* w, const void* sc,
    const void* b, void* xq, void* xs, void* q, void* s, int s_len, int c,
    int np, float eps, int chunk, int cluster, int nch, int stages,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_ln_quantize(x, lnw, xq, xs, s_len, c, eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_silu_quant(xq, xs, w, sc, b, q, s, s_len, c,
                                            np, chunk, cluster, nch, stages,
                                            st));
}

// B6. xq (S, C) int8, xs (S,) f32, then as B4.
extern "C" int qv_dual_gemm_silu_quant(
    const void* xq, const void* xs, const void* w, const void* sc,
    const void* b, void* q, void* s, int s_len, int c, int np, int chunk,
    int cluster, int nch, int stages, void* stream) {
  return static_cast<int>(launch_silu_quant(
      xq, xs, w, sc, b, q, s, s_len, c, np, chunk, cluster, nch, stages,
      static_cast<cudaStream_t>(stream)));
}

// Registers, local (spill) bytes, static and dynamic shared memory of the
// kernels, by index: 0 ln_quantize_reg_kernel (rows up to 2048), 1
// gemm_bias_kernel (its launch registers, before setmaxnreg), 2 and 3
// gemm_silu_quant_kernel<64> and <72> (dynamic shared memory: the plan's,
// not known here, reported as 0), 4 ln_quantize_kernel (wider rows).
extern "C" int qv_fused_kernel_info(int which, int* regs, int* local_bytes,
                                    int* static_smem, int* dynamic_smem) {
  const void* k[5] = {
      reinterpret_cast<const void*>(ln_quantize_reg_kernel<kRegPieces>),
      reinterpret_cast<const void*>(gemm_bias_kernel), mlp_instance(64),
      mlp_instance(72), reinterpret_cast<const void*>(ln_quantize_kernel)};
  if (which < 0 || which > 4) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, k[which]);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *static_smem = (int)a.sharedSizeBytes;
  *dynamic_smem = which == 1 ? kB3Smem : 0;
  return 0;
}

// How many clusters of B4/B6's kernel the card keeps resident at once for
// a plan (cudaOccupancyMaxActiveClusters); 0 means the plan cannot launch.
extern "C" int qv_fused_max_clusters(int chunk, int cluster, int nch,
                                     int stages, int* n) {
  const int smem = mlp_smem(chunk, stages, nch);
  const void* kernel;
  cudaError_t err = mlp_kernel(chunk, smem, &kernel);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = mlp_config(cluster, 1, smem, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
}
