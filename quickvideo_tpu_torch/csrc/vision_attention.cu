// Kernels B2 and B5: block-diagonal vision attention, for Hopper (sm_90a).
//
// B2 replaces the TPU kernel quickvideo_tpu/ops/vision_attention.py::_kernel2d
// (entry block_diag_attention_2d): rotary on q and k, then
// softmax(q k^T * scale) v restricted to contiguous spans of `span` rows
// (64/48/36-row windows of the window blocks, or whole frames of the
// full-attention blocks).
//
// B5 replaces the TPU kernel quickvideo_tpu/ops/vision_attention.py::_kernel
// (entry block_diag_attention): the same attention on rows whose rotary was
// applied outside (the head-major vision route), optionally with a
// per-column validity vector: a key whose valid byte is 0 is masked out, and
// a row whose span holds no valid key is written as 0. Both kernels are one
// template: kRotary stages q and k rotated (B2) or with plain 16-byte copies
// (B5); kMasked reads the validity of each staged key tile. The TPU kernel's
// spans-per-tile packing, 1536-row span cap and 128-lane tiles were VMEM and
// lane artifacts: here any span >= 1 that divides S is taken.
//
// Layout: q/k/v are (S, nh, 80) with any row stride (the three slices of
// the fused qkv projection are passed without a copy); cos/sin are
// (S, 80) f32; out is (S, nh, 80). There is no 128-lane head padding: that
// was a TPU layout artifact.
//
// Design.
//  * One CTA per (block of 64 query rows, head); 4 warps x 16 rows. The key
//    range of a CTA is the union of the spans its rows touch, so any span
//    length works, from 4 rows (several spans share one row block and a
//    same-span mask separates them) to spans far above 1536 rows (per-frame
//    spans at high resolution). The key loop runs an online softmax, so no
//    span x span score tile is ever held.
//  * B2 applies rotary while q and k tiles are staged into shared memory
//    (f32 math, rounded to bf16 for the tensor cores); B5 copies them.
//  * QK^T and PV use mma.sync m16n8k16 (bf16 in, f32 accumulate); the head
//    dim 80 is 5 k-steps of 16 and 10 n-tiles of 8. The softmax weights are
//    rounded to bf16 for PV, as the TPU kernels round p to v's dtype.
//
// What bounds it. At the 7B window blocks (S = 14,400 rows, spans <= 64)
// the work per row is tiny and the kernel is bound by reading q/k/v once
// (plus, for B2, the rotary tables); at the full-attention blocks (900-row
// spans and more) it is tensor-core work. This first version stages every
// tile through shared memory with plain loads and (B2) re-rotates k per
// query block.
#include "common.cuh"

namespace {

constexpr int kHD = 80;
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kThreads = 128;
constexpr int kQStride = kHD + 8;  // smem row stride of q and k tiles
constexpr int kVStride = kBN + 8;  // smem row stride of v^T

struct VisionParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const float* cos;  // kRotary only
  const float* sin;
  const uint8_t* valid;  // kMasked only: (S,) 1 = valid key
  long long q_ss, k_ss, v_ss, o_ss, cs_ss;  // row strides (elements)
  int s, span;
  float scale_log2;
};

// Stage rows [row0, row0 + 64) of head h into `dst`, rotated:
// x * cos + rotate_half(x) * sin, rotate_half(x) = [-x[40:], x[:40]].
// Rows at or past `row_end` are zero.
__device__ __forceinline__ void stage_rotated(
    __nv_bfloat16* dst, const __nv_bfloat16* src, long long ss, int h,
    int row0, int row_end, const VisionParams& p) {
  constexpr int kHalf = kHD / 2;
  for (int i = threadIdx.x; i < kBM * kHalf; i += kThreads) {
    const int r = i / kHalf;
    const int c = (i % kHalf) * 2;  // even column, pairs (c, c + 1)
    const int row = row0 + r;
    float o0 = 0.f, o1 = 0.f;
    if (row < row_end) {
      const __nv_bfloat16* x = src + (long long)row * ss + h * kHD;
      const int pc = c < kHalf ? c + kHalf : c - kHalf;
      const float sign = c < kHalf ? -1.f : 1.f;
      const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + c);
      const __nv_bfloat162 yv = *reinterpret_cast<const __nv_bfloat162*>(x + pc);
      const float* cs = p.cos + (long long)row * p.cs_ss + c;
      const float* sn = p.sin + (long long)row * p.cs_ss + c;
      o0 = __bfloat162float(xv.x) * cs[0] + sign * __bfloat162float(yv.x) * sn[0];
      o1 = __bfloat162float(xv.y) * cs[1] + sign * __bfloat162float(yv.y) * sn[1];
    }
    *reinterpret_cast<uint32_t*>(&dst[r * kQStride + c]) = qv::pack_bf16(o0, o1);
  }
}

// Stage rows [row0, row0 + 64) of head h into `dst` as they are, 16 bytes
// per copy. Rows at or past `row_end` are zero.
__device__ __forceinline__ void stage_plain(
    __nv_bfloat16* dst, const __nv_bfloat16* src, long long ss, int h,
    int row0, int row_end) {
  for (int i = threadIdx.x; i < kBM * (kHD / 8); i += kThreads) {
    const int r = i / (kHD / 8);
    const int c8 = (i % (kHD / 8)) * 8;
    const int row = row0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row < row_end) {
      x = *reinterpret_cast<const uint4*>(src + (long long)row * ss + h * kHD + c8);
    }
    *reinterpret_cast<uint4*>(&dst[r * kQStride + c8]) = x;
  }
}

template <bool kRotary>
__device__ __forceinline__ void stage(
    __nv_bfloat16* dst, const __nv_bfloat16* src, long long ss, int h,
    int row0, int row_end, const VisionParams& p) {
  if constexpr (kRotary) {
    stage_rotated(dst, src, ss, h, row0, row_end, p);
  } else {
    stage_plain(dst, src, ss, h, row0, row_end);
  }
}

template <bool kRotary, bool kMasked>
__global__ void __launch_bounds__(kThreads)
vision_attn_kernel(VisionParams p) {
  __shared__ __align__(16) __nv_bfloat16 qs[kBM * kQStride];
  __shared__ __align__(16) __nv_bfloat16 ks[kBN * kQStride];
  __shared__ __align__(16) __nv_bfloat16 vt[kHD * kVStride];
  __shared__ uint8_t kval[kMasked ? kBN : 1];  // validity of the staged keys

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kBM;
  const int row_last = min(row0 + kBM, p.s) - 1;
  const int span_lo = row0 / p.span;
  const int span_hi = row_last / p.span;
  const int kstart = span_lo * p.span;
  const int kend = min((span_hi + 1) * p.span, p.s);

  stage<kRotary>(qs, p.q, p.q_ss, h, row0, p.s, p);
  __syncthreads();

  uint32_t qf[kHD / 16][4];
  const int rl = warp * 16 + gq;  // local row of accumulator rows 0 / 1
#pragma unroll
  for (int kk = 0; kk < kHD / 16; ++kk) {
    const int c = kk * 16 + 2 * t4;
    qf[kk][0] = qv::ld32(&qs[rl * kQStride + c]);
    qf[kk][1] = qv::ld32(&qs[(rl + 8) * kQStride + c]);
    qf[kk][2] = qv::ld32(&qs[rl * kQStride + c + 8]);
    qf[kk][3] = qv::ld32(&qs[(rl + 8) * kQStride + c + 8]);
  }
  int row_span[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + rl + 8 * i;
    row_ok[i] = r < p.s;
    row_span[i] = r / p.span;
  }

  float acc[kHD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kHD / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const __nv_bfloat16* vbase = p.v + h * kHD;

  for (int key0 = kstart; key0 < kend; key0 += kBN) {
    __syncthreads();
    stage<kRotary>(ks, p.k, p.k_ss, h, key0, kend, p);
    if constexpr (kMasked) {
      if (tid < kBN) {
        const int key = key0 + tid;
        kval[tid] = key < kend ? p.valid[key] : 0;
      }
    }
    for (int i = tid; i < kBN * (kHD / 8); i += kThreads) {
      const int r = i / (kHD / 8);
      const int c8 = (i % (kHD / 8)) * 8;
      const int key = key0 + r;
      uint4 vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (key < kend) {
        vv4 = *reinterpret_cast<const uint4*>(vbase + (long long)key * p.v_ss + c8);
      }
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c8 + j) * kVStride + r] = ve[j];
    }
    __syncthreads();

    float s[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt) {
        const __nv_bfloat16* kp = &ks[(nt * 8 + gq) * kQStride + kk * 16 + 2 * t4];
        qv::mma_bf16_16816(s[nt], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
                           qv::ld32(kp), qv::ld32(kp + 8));
      }
    }

    // the mask is needed unless every row and every key of this tile lie in
    // one span
    const bool one_span = span_lo == span_hi && row_last - row0 == kBM - 1 &&
                          key0 / p.span == span_lo &&
                          (key0 + kBN - 1) / p.span == span_lo &&
                          key0 + kBN <= kend;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale_log2;
        if (!one_span) {
          const int key = key0 + nt * 8 + 2 * t4 + (e & 1);
          const int i = e >> 1;
          if (!row_ok[i] || key >= kend || key / p.span != row_span[i]) {
            x = -INFINITY;
          }
        }
        if constexpr (kMasked) {
          if (!kval[nt * 8 + 2 * t4 + (e & 1)]) x = -INFINITY;
        }
        s[nt][e] = x;
      }
    }

    float m_use[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt) {
        mx = fmaxf(mx, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
      }
      mx = qv::warp_max4(mx);
      const float m_new = fmaxf(m_run[i], mx);
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = exp2f(m_run[i] - m_use[i]);
      m_run[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nt][e] - m_use[e >> 1]);
        s[nt][e] = pe;
        rs[e >> 1] += pe;
      }
    }
    l_run[0] = l_run[0] * alpha[0] + rs[0];
    l_run[1] = l_run[1] * alpha[1] + rs[1];
#pragma unroll
    for (int dt = 0; dt < kHD / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t a0 = qv::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = qv::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = qv::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = qv::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < kHD / 8; ++dt) {
        const __nv_bfloat16* vp = &vt[(dt * 8 + gq) * kVStride + kk * 16 + 2 * t4];
        qv::mma_bf16_16816(acc[dt], a0, a1, a2, a3, qv::ld32(vp), qv::ld32(vp + 8));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = qv::warp_sum4(l_run[i]);
    if (!row_ok[i]) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* orow = p.o + (long long)(row0 + rl + 8 * i) * p.o_ss + h * kHD;
#pragma unroll
    for (int dt = 0; dt < kHD / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t4) =
          qv::pack_bf16(acc[dt][2 * i] * inv, acc[dt][2 * i + 1] * inv);
    }
  }
}

}  // namespace

extern "C" int qv_vision_attention(
    const void* q, const void* k, const void* v, void* o, const void* cos,
    const void* sin, long long q_ss, long long k_ss, long long v_ss,
    long long o_ss, long long cs_ss, int s, int nh, int span, float scale,
    void* stream) {
  VisionParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.valid = nullptr;
  p.q_ss = q_ss; p.k_ss = k_ss; p.v_ss = v_ss; p.o_ss = o_ss; p.cs_ss = cs_ss;
  p.s = s; p.span = span;
  p.scale_log2 = scale * 1.4426950408889634f;
  dim3 grid((s + kBM - 1) / kBM, nh);
  vision_attn_kernel<true, false>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// B5: q/k/v/o as for B2 (already rotated); `valid` is null (unmasked) or an
// (S,) byte vector, 1 for a valid key.
extern "C" int qv_block_diag_attention(
    const void* q, const void* k, const void* v, void* o, const void* valid,
    long long q_ss, long long k_ss, long long v_ss, long long o_ss, int s,
    int nh, int span, float scale, void* stream) {
  VisionParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.cos = p.sin = nullptr;
  p.valid = static_cast<const uint8_t*>(valid);
  p.q_ss = q_ss; p.k_ss = k_ss; p.v_ss = v_ss; p.o_ss = o_ss; p.cs_ss = 0;
  p.s = s; p.span = span;
  p.scale_log2 = scale * 1.4426950408889634f;
  dim3 grid((s + kBM - 1) / kBM, nh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (valid) {
    vision_attn_kernel<false, true><<<grid, kThreads, 0, st>>>(p);
  } else {
    vision_attn_kernel<false, false><<<grid, kThreads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}
