// The language model's int8 glue around torch._int_mm, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves each act-quantized product
// of the decoder and its glue to XLA (quickvideo_tpu/ops/quantization.py,
// qdot / qdot_multi / qdot_pre, called from models/qwen25_vl/language.py),
// which fuses the glue into the product. Eager PyTorch ran it as a dozen
// full-tensor f32 passes a product. Here each piece of glue is one pass,
// with the rounding points of the port's plain op sequence
// (ops/int8_glue.py, the `*_plain` functions):
//
//   row_quantize_kernel<true>  (rms_quantize) rmsnorm: the sum of squares
//       in f32, rsqrtf(sum / C + eps), x * r rounded to bf16, times ln_w
//       rounded to bf16; then the per-row int8 quantize: scale
//       max(|h|, 1e-8) / 127 by true division, codes rint(h / scale)
//       clipped to +-127;
//   row_quantize_kernel<false> (quantize_rows) the quantize alone;
//   rescale_kernel  (rescale) bf16((float(acc) * xs) * sc), then
//       bf16(y + bias) and bf16(residual + y) where given;
//   swiglu_quantize_kernel  (swiglu_quantize) g and u rescaled and rounded
//       as above, s = bf16(g / (1 + expf(-g))) as torch's bf16 silu, m =
//       bf16(s * u), then the quantize.
// Products and sums are __fmul_rn / __fadd_rn: no FMA contraction, so the
// rescale and the SwiGLU give the plain sequence's bits on the card; the
// rmsnorm's row sum is taken in another order than torch's mean, so its
// codes can flip by one at a rounding boundary.
//
// What bounds them: bytes (a few operations a byte). At the 7B's group step
// (M = 3,600 rows, C = 3,584, I = 18,944) the glue of one layer reads and
// writes about 1.3 GB here, most of it the s32 results of torch._int_mm read
// once (the SwiGLU's 545 MB); nothing between the product and the next
// product's int8 input goes to device memory.
//
// Design. The row reductions (rms_quantize, quantize_rows, swiglu_quantize)
// take one CTA per row, so a row is read from device memory once and its sum
// and max are reduced inside the CTA: the row quantize holds each thread's
// up to kRowPieces x 8 values in registers (C <= 8,192, the 72B's width);
// the SwiGLU holds the row's bf16 products in shared memory (2 I bytes:
// 37.9 KB at I = 18,944, 59.1 KB at the 72B's 29,568) between the max and
// the codes. The rescale is a flat elementwise pass, four columns a thread
// (16-byte loads of the s32 results and of the scales).
#include "common.cuh"

namespace {

constexpr int kRowThreads = 256;
constexpr int kRowPieces = 4;  // 8 values a piece: C <= 256 * 8 * 4
constexpr int kSwiThreads = 256;
constexpr int kRescaleThreads = 256;
constexpr float kEps = 1e-8f;

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// four bf16 at p (8-byte aligned) as floats
__device__ __forceinline__ float4 ld_bf16x4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}

__device__ __forceinline__ int quant(float v, float s) {
  return max(-127, min(127, __float2int_rn(__fdiv_rn(v, s))));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) |
         ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) |
         ((static_cast<uint32_t>(d) & 0xffu) << 24);
}

// the row scale of quantize_act: max(amax, 1e-8) / 127, divided once
__device__ __forceinline__ float row_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, kEps), 127.0f);
}

// sum / max over the CTA's kThreads threads; every thread gets the result.
// `red` holds one value a warp and is read after the barrier, so a second
// reduction must use another array.
template <int kThreads>
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) s = __fadd_rn(s, red[i]);
  return s;
}

template <int kThreads>
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) m = fmaxf(m, red[i]);
  return m;
}

// rms_quantize (kNorm) and quantize_rows: one CTA a row; thread t holds the
// 8-value pieces starting at columns 8 (t + 256 i), i < kRowPieces.
template <bool kNorm>
__global__ void __launch_bounds__(kRowThreads) row_quantize_kernel(
    const __nv_bfloat16* __restrict__ x, long long ldx,
    const __nv_bfloat16* __restrict__ lnw, int8_t* __restrict__ xq,
    float* __restrict__ xs_out, int c, float eps) {
  __shared__ float red_sum[kRowThreads / 32];
  __shared__ float red_max[kRowThreads / 32];
  const long long row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * ldx;
  float h[kRowPieces][8];
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < kRowPieces; ++i) {
    const int k = (threadIdx.x + i * kRowThreads) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (k < c) v = *reinterpret_cast<const uint4*>(xr + k);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      h[i][j] = __bfloat162float(e[j]);
      if (kNorm) ss = __fadd_rn(ss, __fmul_rn(h[i][j], h[i][j]));
    }
  }
  if (kNorm) {
    ss = block_sum<kRowThreads>(ss, red_sum);
    const float r =
        rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(c)), eps));
#pragma unroll
    for (int i = 0; i < kRowPieces; ++i) {
      const int k = (threadIdx.x + i * kRowThreads) * 8;
      if (k >= c) continue;
      const uint4 wv = *reinterpret_cast<const uint4*>(lnw + k);
      const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(&wv);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        h[i][j] = bf16r(
            __fmul_rn(bf16r(__fmul_rn(h[i][j], r)), __bfloat162float(w[j])));
    }
  }
  float am = 0.0f;
#pragma unroll
  for (int i = 0; i < kRowPieces; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) am = fmaxf(am, fabsf(h[i][j]));
  const float s = row_scale(block_max<kRowThreads>(am, red_max));
  int8_t* qr = xq + row * c;
#pragma unroll
  for (int i = 0; i < kRowPieces; ++i) {
    const int k = (threadIdx.x + i * kRowThreads) * 8;
    if (k >= c) continue;
    *reinterpret_cast<uint2*>(qr + k) = make_uint2(
        pack4(quant(h[i][0], s), quant(h[i][1], s), quant(h[i][2], s),
              quant(h[i][3], s)),
        pack4(quant(h[i][4], s), quant(h[i][5], s), quant(h[i][6], s),
              quant(h[i][7], s)));
  }
  if (threadIdx.x == 0) xs_out[row] = s;
}

// rescale: four columns a thread over the flat (M, N / 4) index space
__global__ void __launch_bounds__(kRescaleThreads) rescale_kernel(
    const int* __restrict__ acc, long long lda, const float* __restrict__ xs,
    const float* __restrict__ sc, const __nv_bfloat16* __restrict__ bias,
    const __nv_bfloat16* __restrict__ res, long long ldr,
    __nv_bfloat16* __restrict__ out, int m, int n) {
  const int nv = n / 4;
  const long long total = static_cast<long long>(m) * nv;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = i / nv;
    const int col = static_cast<int>(i - row * nv) * 4;
    const int4 a = *reinterpret_cast<const int4*>(acc + row * lda + col);
    const float4 s = *reinterpret_cast<const float4*>(sc + col);
    const float x_s = xs[row];
    float y[4] = {
        bf16r(__fmul_rn(__fmul_rn(__int2float_rn(a.x), x_s), s.x)),
        bf16r(__fmul_rn(__fmul_rn(__int2float_rn(a.y), x_s), s.y)),
        bf16r(__fmul_rn(__fmul_rn(__int2float_rn(a.z), x_s), s.z)),
        bf16r(__fmul_rn(__fmul_rn(__int2float_rn(a.w), x_s), s.w))};
    if (bias != nullptr) {
      const float4 b = ld_bf16x4(bias + col);
      y[0] = bf16r(__fadd_rn(y[0], b.x));
      y[1] = bf16r(__fadd_rn(y[1], b.y));
      y[2] = bf16r(__fadd_rn(y[2], b.z));
      y[3] = bf16r(__fadd_rn(y[3], b.w));
    }
    if (res != nullptr) {
      const float4 r = ld_bf16x4(res + row * ldr + col);
      y[0] = bf16r(__fadd_rn(r.x, y[0]));
      y[1] = bf16r(__fadd_rn(r.y, y[1]));
      y[2] = bf16r(__fadd_rn(r.z, y[2]));
      y[3] = bf16r(__fadd_rn(r.w, y[3]));
    }
    *reinterpret_cast<uint2*>(out + row * n + col) =
        make_uint2(qv::pack_bf16(y[0], y[1]), qv::pack_bf16(y[2], y[3]));
  }
}

// one rescaled, rounded value of the SwiGLU's inputs
__device__ __forceinline__ float rescaled(int a, float x_s, float sc) {
  return bf16r(__fmul_rn(__fmul_rn(__int2float_rn(a), x_s), sc));
}

// bf16(bf16(silu(g)) * u) for bf16-exact g and u, as torch's bf16 silu and
// product round them
__device__ __forceinline__ float swiglu(float g, float u) {
  const float s = bf16r(__fdiv_rn(g, __fadd_rn(1.0f, expf(-g))));
  return bf16r(__fmul_rn(s, u));
}

// swiglu_quantize: one CTA a row, four columns a thread per step; the row's
// bf16 products wait in shared memory (2 n bytes) for the row max
__global__ void __launch_bounds__(kSwiThreads) swiglu_quantize_kernel(
    const int* __restrict__ g, long long ldg, const int* __restrict__ u,
    long long ldu, const float* __restrict__ xs,
    const float* __restrict__ scg, const float* __restrict__ scu,
    int8_t* __restrict__ mq, float* __restrict__ ms, int n) {
  extern __shared__ uint2 prod[];  // n / 4 entries of four bf16
  __shared__ float red_max[kSwiThreads / 32];
  const long long row = blockIdx.x;
  const int* gr = g + row * ldg;
  const int* ur = u + row * ldu;
  const float x_s = xs[row];
  const int nv = n / 4;
  float am = 0.0f;
#pragma unroll 4
  for (int v = threadIdx.x; v < nv; v += kSwiThreads) {
    const int4 a = *reinterpret_cast<const int4*>(gr + 4 * v);
    const int4 b = *reinterpret_cast<const int4*>(ur + 4 * v);
    const float4 sg = *reinterpret_cast<const float4*>(scg + 4 * v);
    const float4 su = *reinterpret_cast<const float4*>(scu + 4 * v);
    const float m0 = swiglu(rescaled(a.x, x_s, sg.x), rescaled(b.x, x_s, su.x));
    const float m1 = swiglu(rescaled(a.y, x_s, sg.y), rescaled(b.y, x_s, su.y));
    const float m2 = swiglu(rescaled(a.z, x_s, sg.z), rescaled(b.z, x_s, su.z));
    const float m3 = swiglu(rescaled(a.w, x_s, sg.w), rescaled(b.w, x_s, su.w));
    am = fmaxf(am, fmaxf(fmaxf(fabsf(m0), fabsf(m1)),
                         fmaxf(fabsf(m2), fabsf(m3))));
    prod[v] = make_uint2(qv::pack_bf16(m0, m1), qv::pack_bf16(m2, m3));
  }
  // the barrier inside block_max also orders the products' stores before
  // the reads below
  const float s = row_scale(block_max<kSwiThreads>(am, red_max));
  int8_t* qr = mq + row * n;
  for (int v = threadIdx.x; v < nv; v += kSwiThreads) {
    const float4 p = ld_bf16x4(reinterpret_cast<const __nv_bfloat16*>(prod + v));
    *reinterpret_cast<uint32_t*>(qr + 4 * v) =
        pack4(quant(p.x, s), quant(p.y, s), quant(p.z, s), quant(p.w, s));
  }
  if (threadIdx.x == 0) ms[row] = s;
}

constexpr int kStaticSmemLimit = 48 * 1024;

}  // namespace

// rms_quantize. x (M, C) bf16 with row stride ldx (elements), lnw (C,) bf16
// -> xq (M, C) int8, xs (M,) f32. C % 8 == 0, C <= 8192; rows 16-byte
// aligned.
extern "C" int qv_rms_quantize(const void* x, long long ldx, const void* lnw,
                               void* xq, void* xs, int m, int c, float eps,
                               void* stream) {
  row_quantize_kernel<true><<<m, kRowThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), ldx,
      static_cast<const __nv_bfloat16*>(lnw), static_cast<int8_t*>(xq),
      static_cast<float*>(xs), c, eps);
  return static_cast<int>(cudaGetLastError());
}

// quantize_rows. As qv_rms_quantize, without the norm.
extern "C" int qv_quantize_rows(const void* x, long long ldx, void* xq,
                                void* xs, int m, int c, void* stream) {
  row_quantize_kernel<false><<<m, kRowThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), ldx, nullptr,
      static_cast<int8_t*>(xq), static_cast<float*>(xs), c, 0.0f);
  return static_cast<int>(cudaGetLastError());
}

// rescale. acc (M, N) s32 with row stride lda, xs (M,) f32, sc (N,) f32,
// bias (N,) bf16 or null, res (M, N) bf16 with row stride ldr or null ->
// out (M, N) bf16, contiguous. N, lda, ldr multiples of 4.
extern "C" int qv_rescale(const void* acc, long long lda, const void* xs,
                          const void* sc, const void* bias, const void* res,
                          long long ldr, void* out, int m, int n,
                          void* stream) {
  const long long total = static_cast<long long>(m) * (n / 4);
  const long long blocks = (total + kRescaleThreads - 1) / kRescaleThreads;
  rescale_kernel<<<static_cast<int>(blocks < (1 << 20) ? blocks : (1 << 20)),
                   kRescaleThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(acc), lda, static_cast<const float*>(xs),
      static_cast<const float*>(sc), static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(res), ldr,
      static_cast<__nv_bfloat16*>(out), m, n);
  return static_cast<int>(cudaGetLastError());
}

// swiglu_quantize. g, u (M, I) s32 with row strides ldg, ldu; xs (M,) f32;
// scg, scu (I,) f32 -> mq (M, I) int8, ms (M,) f32. I % 4 == 0; 2 I bytes
// of dynamic shared memory a CTA.
extern "C" int qv_swiglu_quantize(const void* g, long long ldg, const void* u,
                                  long long ldu, const void* xs,
                                  const void* scg, const void* scu, void* mq,
                                  void* ms, int m, int n, void* stream) {
  const int smem = 2 * n;
  if (smem > kStaticSmemLimit) {  // the opt-in above 48 KB, on this device
    const cudaError_t err = cudaFuncSetAttribute(
        swiglu_quantize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  swiglu_quantize_kernel<<<m, kSwiThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(g), ldg, static_cast<const int*>(u), ldu,
      static_cast<const float*>(xs), static_cast<const float*>(scg),
      static_cast<const float*>(scu), static_cast<int8_t*>(mq),
      static_cast<float*>(ms), n);
  return static_cast<int>(cudaGetLastError());
}

// Registers, local (spill) bytes, static and dynamic shared memory of the
// kernels, by index: 0 row_quantize_kernel<true> (rms_quantize), 1
// row_quantize_kernel<false> (quantize_rows), 2 rescale_kernel, 3
// swiglu_quantize_kernel (dynamic: 2 I bytes, reported as 0).
extern "C" int qv_glue_kernel_info(int which, int* regs, int* local_bytes,
                                   int* static_smem, int* dynamic_smem) {
  const void* k[4] = {
      reinterpret_cast<const void*>(row_quantize_kernel<true>),
      reinterpret_cast<const void*>(row_quantize_kernel<false>),
      reinterpret_cast<const void*>(rescale_kernel),
      reinterpret_cast<const void*>(swiglu_quantize_kernel)};
  if (which < 0 || which > 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, k[which]);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *static_smem = static_cast<int>(a.sharedSizeBytes);
  *dynamic_smem = 0;
  return 0;
}
