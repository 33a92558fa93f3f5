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
// Layout: the weight is the (out, in) row-major int8 tensor (K contiguous
// per output channel), the B operand layout of the integer tensor cores.
//
// Design.
//  * B3/B4 prologue: one warp per row normalizes, rounds and quantizes the
//    raw row into an int8 row scratch (S, C) plus its f32 scale. The TPU
//    kernel keeps these in VMEM because one grid step there covers every
//    output column of its row tile; here the output columns are spread
//    over many CTAs, and rebuilding the row tile inside each of them
//    repeats the prologue 27 times per 64-row block (measured on an H100:
//    2.5 of 3.9 ms of B4 at the 7B group shape). The scratch is 18 MB at
//    that shape and is read back mostly from L2.
//  * GEMM: one CTA per (64 rows, 128 output columns), 8 warps as 2 x 4
//    tiles of 32 x 32, mma.sync m16n8k32 s8 x s8 -> s32. The CTA copies
//    its whole (64, C) int8 row tile into shared memory once, and weight
//    tiles of 128 x 64 bytes stream through a two-stage cp.async ring.
//  * B4/B6: a CTA's 128 columns are 64 gate columns and the 64 up columns
//    that pair with them, so silu(g) * u is formed inside the CTA. The
//    row-wide requantize needs the max over all Np columns of a row, which
//    no single CTA holds (16 rows x 3456 f32 would be 221 KB). The design
//    writes silu(g) * u in f32 to a scratch (S, Np) buffer, folds each
//    CTA's row maxima into a per-row max with atomicMax on the float bits
//    (all values are >= 0), and a third small kernel quantizes the rows.
//    The scratch costs one f32 write and read of (S, Np) (~200 MB at the
//    7B group shape); a recompute pass or narrower row tiles are the
//    alternatives for a later PR.
//
// What bounds it. At the 7B group shape (S = 14,400, C = 1280, N = 3840 or
// 2 x 3456) the GEMM is 141 / 255 G int-ops, about 0.07 / 0.13 ms at the
// int8 tensor-core peak; the data is 37 MB of input rows, 5 / 9 MB of
// weights and 111 MB (B3 output) or 250 MB (B4 scratch + codes), 0.04-0.08
// ms at the HBM rate. This first version uses mma.sync with plain
// shared-memory fragment loads, not wgmma.
#include "common.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 128;
constexpr int kBK = 64;              // bytes of K per weight stage
constexpr int kThreads = 256;
constexpr int kBStride = kBK + 16;   // smem row stride of a weight stage
constexpr int kYStride = kBN + 4;    // smem row stride of the f32 epilogue tile
constexpr float kEps = 1e-8f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

__host__ __device__ inline size_t a_bytes(int c, bool dual) {
  size_t a = static_cast<size_t>(kBM) * (c + 16);
  const size_t y = static_cast<size_t>(kBM) * kYStride * sizeof(float);
  if (dual && y > a) a = y;
  return (a + 15) / 16 * 16;
}

size_t smem_bytes(int c, bool dual) {
  return a_bytes(c, dual) + 2 * kBN * kBStride + kBM * sizeof(float);
}

// B3/B4 prologue: normalize, round and quantize each raw row into the
// int8 row scratch; one warp per row, each lane 8 columns at a time. The
// row is read three times (sum of squares, max, codes), from L1/L2.
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

template <bool kDual>
__global__ void __launch_bounds__(kThreads) fused_gemm_kernel(
    const int8_t* __restrict__ xq,         // (S, C) quantized rows
    const float* __restrict__ xs_in,       // (S,) row scales
    const int8_t* __restrict__ w,          // (N_total, C) row-major
    const float* __restrict__ sc,          // (N_total,)
    const __nv_bfloat16* __restrict__ bias,  // (N_total,)
    __nv_bfloat16* __restrict__ out,       // !kDual: (S, N)
    float* __restrict__ mid,               // kDual: (S, Np) silu(g) * u
    float* __restrict__ amax,              // kDual: (S,) zeroed row maxima
    int s_len, int c, int n) {  // n: N (B3) or Np (B4/B6)
  extern __shared__ __align__(16) unsigned char smem[];
  const int a_stride = c + 16;
  int8_t* as = reinterpret_cast<int8_t*>(smem);
  int8_t* bs = reinterpret_cast<int8_t*>(smem + a_bytes(c, kDual));
  float* xs_s = reinterpret_cast<float*>(bs + 2 * kBN * kBStride);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kBM;
  const int n_rows_w = kDual ? 2 * n : n;

  // weight row (= output column) held by smem stage row j
  auto w_row = [&](int j) -> int {
    if (kDual) return j < 64 ? blockIdx.y * 64 + j : n + blockIdx.y * 64 + j - 64;
    return blockIdx.y * kBN + j;
  };
  auto load_w = [&](int stage, int k0) {
    int8_t* dst = bs + stage * kBN * kBStride;
    for (int i = tid; i < kBN * (kBK / 16); i += kThreads) {
      const int j = i >> 2;
      const int k = k0 + (i & 3) * 16;
      const int nr = w_row(j);
      const bool ok = nr < n_rows_w && k < c;
      cp_async16(dst + j * kBStride + (i & 3) * 16,
                 ok ? w + static_cast<size_t>(nr) * c + k : w, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  load_w(0, 0);  // the first weight stage flies while the row tile loads
  const int chunks = c / 16;
  for (int i = tid; i < kBM * chunks; i += kThreads) {
    const int r = i / chunks;
    const int k = (i - r * chunks) * 16;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < s_len)
      v = *reinterpret_cast<const uint4*>(
          xq + static_cast<size_t>(row0 + r) * c + k);
    *reinterpret_cast<uint4*>(as + r * a_stride + k) = v;
  }
  for (int r = tid; r < kBM; r += kThreads)
    xs_s[r] = row0 + r < s_len ? xs_in[row0 + r] : 1.0f;

  const int wm = warp >> 2;  // rows wm*32 .. +32
  const int wn = warp & 3;   // columns wn*32 .. +32
  const int g = lane >> 2;
  const int t = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (c + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_w((kt + 1) & 1, (kt + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* wst = bs + (kt & 1) * kBN * kBStride;
    const int k0 = kt * kBK;
    const int ksteps = min(kBK, c - k0) / 32;
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* ap =
            as + (wm * 32 + i * 16 + g) * a_stride + k0 + ks * 32 + 4 * t;
        a[i][0] = *reinterpret_cast<const uint32_t*>(ap);
        a[i][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * a_stride);
        a[i][2] = *reinterpret_cast<const uint32_t*>(ap + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * a_stride + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* bp = wst + (wn * 32 + j * 8 + g) * kBStride + ks * 32 + 4 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) qv::mma_s8_16832(acc[i][j], a[i], b0, b1);
      }
    }
    __syncthreads();  // this stage (and, after the last, the row tile) is free
  }

  if (!kDual) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = blockIdx.y * kBN + wn * 32 + j * 8 + 2 * t;
        if (col >= n) continue;  // n % 8 == 0: col + 1 < n as well
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + i * 16 + g + 8 * h;
          if (row0 + r >= s_len) continue;
          const float xr = xs_s[r];
          const float y0 = bf16_round(
              (static_cast<float>(acc[i][j][2 * h]) * xr) * sc[col]);
          const float y1 = bf16_round(
              (static_cast<float>(acc[i][j][2 * h + 1]) * xr) * sc[col + 1]);
          const __nv_bfloat162 o = __floats2bfloat162_rn(
              y0 + __bfloat162float(bias[col]),
              y1 + __bfloat162float(bias[col + 1]));
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<size_t>(row0 + r) * n + col) = o;
        }
      }
    return;
  }

  // B4/B6: rescale + bias into an f32 tile (over the row tile's smem), then
  // pair gate column c with up column c + 64
  float* ys = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cl = wn * 32 + j * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int wr = w_row(cl + e);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + i * 16 + g + 8 * h;
          const float y = bf16_round(
              (static_cast<float>(acc[i][j][2 * h + e]) * xs_s[r]) * sc[wr]);
          ys[r * kYStride + cl + e] =
              bf16_round(y + __bfloat162float(bias[wr]));
        }
      }
    }
  __syncthreads();
  for (int e = tid; e < kBM * 64; e += kThreads) {
    const int r = e >> 6;
    const int cc = e & 63;
    const float gv = ys[r * kYStride + cc];
    const float uv = ys[r * kYStride + 64 + cc];
    const float m = gv * (1.0f / (1.0f + expf(-gv))) * uv;
    const bool valid = row0 + r < s_len;
    if (valid) mid[static_cast<size_t>(row0 + r) * n + blockIdx.y * 64 + cc] = m;
    // the 32 lanes of a warp share one row
    const float wmax = warp_max(valid ? fabsf(m) : 0.0f);
    if (lane == 0 && valid)
      atomicMax(reinterpret_cast<int*>(amax + row0 + r), __float_as_int(wmax));
  }
}

// Per-row int8 requantize of silu(g) * u: one warp per row.
__global__ void __launch_bounds__(256) requantize_kernel(
    const float* __restrict__ mid, const float* __restrict__ amax,
    int8_t* __restrict__ q, float* __restrict__ s, int s_len, int np) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= s_len) return;
  const float sv = fmaxf(amax[row], kEps) / 127.0f;
  if (lane == 0) s[row] = sv;
  const float* mr = mid + static_cast<size_t>(row) * np;
  int8_t* qr = q + static_cast<size_t>(row) * np;
  for (int k = lane * 4; k < np; k += 128) {
    const float4 v = *reinterpret_cast<const float4*>(mr + k);
    const uint32_t packed = (static_cast<uint32_t>(quant(v.x, sv)) & 0xffu) |
                            ((static_cast<uint32_t>(quant(v.y, sv)) & 0xffu) << 8) |
                            ((static_cast<uint32_t>(quant(v.z, sv)) & 0xffu) << 16) |
                            ((static_cast<uint32_t>(quant(v.w, sv)) & 0xffu) << 24);
    *reinterpret_cast<uint32_t*>(qr + k) = packed;
  }
}

template <bool kDual>
cudaError_t launch_gemm(const void* xq, const void* xs, const void* w,
                        const void* sc, const void* bias, void* out,
                        void* mid, void* amax, int s_len, int c, int n,
                        cudaStream_t stream) {
  const size_t smem = smem_bytes(c, kDual);
  auto kernel = fused_gemm_kernel<kDual>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((s_len + kBM - 1) / kBM,
                  kDual ? n / 64 : (n + kBN - 1) / kBN);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(w), static_cast<const float*>(sc),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(mid),
      static_cast<float*>(amax), s_len, c, n);
  return cudaGetLastError();
}

cudaError_t launch_ln_quantize(const void* x, const void* lnw, void* xq,
                               void* xs, int s_len, int c, float eps,
                               cudaStream_t stream) {
  ln_quantize_kernel<<<(s_len + 7) / 8, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(lnw),
      static_cast<int8_t*>(xq), static_cast<float*>(xs), s_len, c, eps);
  return cudaGetLastError();
}

cudaError_t launch_requantize(const void* mid, const void* amax, void* q,
                              void* s, int s_len, int np,
                              cudaStream_t stream) {
  requantize_kernel<<<(s_len + 7) / 8, 256, 0, stream>>>(
      static_cast<const float*>(mid), static_cast<const float*>(amax),
      static_cast<int8_t*>(q), static_cast<float*>(s), s_len, np);
  return cudaGetLastError();
}

}  // namespace

// B3. x (S, C) bf16, lnw (C,) f32, w (N, C) int8, sc (N,) f32, b (N,) bf16;
// scratch xq (S, C) int8, xs (S,) f32 -> out (S, N) bf16. C % 32 == 0,
// N % 8 == 0.
extern "C" int qv_ln_gemm_bias(const void* x, const void* lnw, const void* w,
                               const void* sc, const void* b, void* xq,
                               void* xs, void* out, int s_len, int c, int n,
                               float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_ln_quantize(x, lnw, xq, xs, s_len, c, eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_gemm<false>(xq, xs, w, sc, b, out, nullptr, nullptr, s_len, c,
                           n, st);
  return static_cast<int>(err);
}

// B4. x (S, C) bf16, lnw (C,) f32, w (2*Np, C) int8, sc/b (2*Np,); scratch
// xq (S, C) int8, xs (S,) f32, mid (S, Np) f32 and amax (S,) f32 zeroed
// -> q (S, Np) int8, s (S,) f32.
extern "C" int qv_ln_dual_gemm_silu_quant(
    const void* x, const void* lnw, const void* w, const void* sc,
    const void* b, void* xq, void* xs, void* mid, void* amax, void* q,
    void* s, int s_len, int c, int np, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_ln_quantize(x, lnw, xq, xs, s_len, c, eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_gemm<true>(xq, xs, w, sc, b, nullptr, mid, amax, s_len, c, np,
                          st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_requantize(mid, amax, q, s, s_len, np, st));
}

// B6. xq (S, C) int8, xs (S,) f32, then as B4.
extern "C" int qv_dual_gemm_silu_quant(
    const void* xq, const void* xs, const void* w, const void* sc,
    const void* b, void* mid, void* amax, void* q, void* s, int s_len, int c,
    int np, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_gemm<true>(xq, xs, w, sc, b, nullptr, mid,
                                            amax, s_len, c, np, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_requantize(mid, amax, q, s, s_len, np, st));
}
