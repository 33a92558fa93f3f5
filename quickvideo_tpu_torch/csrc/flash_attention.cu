// Kernel B1: GQA flash attention over one layer of the stacked KV cache,
// for Hopper (sm_90a): bf16 cache (flash_fwd_kernel), and the int8 caches on
// the int8-QK route (flash_fwd_int8_kernel).
//
// Replaces the TPU kernel quickvideo_tpu/ops/flash_attention.py::_flash_kernel
// (entry _flash_past_attention_impl) in both its modes:
//   unified causal  query row i of a group of G rows attends cache slots
//                   [0, length + i]; the caller has already appended the
//                   group's K/V at [length, length + G);
//   pure past       every row attends [0, length) (length 0: out 0, lse
//                   NEG_INF), the query-based mode's past partial;
// each with or without the log-sum-exp (natural log, f32 (Hq, G) through
// strides), and with a bf16 or f32 output. The three are template
// parameters (kPast, kLse, OutT), so the main path's instantiation (unified,
// no lse, bf16) compiles to the code it had before the other modes existed.
// Variants:
//   bf16   bf16 q, K, V (the "bfloat16" cache);
//   int8   int8 K and V with one f32 scale per (head, token) row, int8 q
//          with one f32 scale per (head, row) ("int8" cache, int8-QK);
//   int8k  int8 K with scales, bf16 V, int8 q ("int8k" cache, int8-QK).
//
// Operands: q (Hq, G, 128) and the layer view k/v (Hkv, cap, 128) are passed
// as pointers with strides, so the layer view k_all[li] is never copied. The
// output is written through strides as well ((G, Hq, 128) storage lets the
// o-projection read it without a transpose).
//
// Design.
//  * GQA packing: one CTA serves one kv head and a block of 64 "packed rows",
//    packed row r = (position r / rep, query head kv*rep + r % rep). The rep
//    (= 7 on the 7B) query heads that share a kv head read each K/V tile from
//    shared memory once. rep need not be a power of two.
//  * 4 warps x 16 rows; keys in tiles of 64 through shared memory. bf16: QK^T
//    on mma.sync m16n8k16 (bf16 in, f32 accumulate). int8-QK: QK^T on
//    mma.sync m16n8k32 (s8 in, exact s32 accumulate; the int8 q fragments
//    stay in registers, 4 k-steps of 32 at D = 128), then
//    s = (float(acc) * qs[row]) * ks[col], the JAX kernel's order; q was
//    pre-scaled by scale*log2 e before it was quantized, so qs absorbed the
//    softmax scale and no second scale is applied. The tile's key scales
//    are staged in shared memory. PV is mma.sync m16n8k16 in bf16 in every
//    variant; int8 V codes are converted to bf16 (exactly) while staging the
//    transposed V tile, and p * vs[col] is formed before the bf16 packing,
//    as `pv = p * vs` in the JAX kernel. The P tile is re-packed from the
//    score accumulators in registers.
//  * Online softmax in f32, in log2 units (bf16: scores scaled by
//    scale*log2 e); the denominator sums the f32 p.
//  * The key loop stops at min(length + last position of the CTA + 1, cap):
//    nothing past the valid prefix is read. Tiles wholly below every row's
//    bound skip the mask.
//  * Split-K (decode): when there are too few CTAs to fill the card (q = 1
//    decode has Hkv CTAs), a third grid axis splits each CTA's key range;
//    the splits write f32 partials plus (max, sum) per row and a second
//    kernel merges them. Prefill shapes run unsplit. The merge serves every
//    variant.
//
// What bounds it. Prefill (G = 3600 on the 7B group step) is tensor-core
// work: ~4*G*(length+G/2)*128*Hq flops; this version uses warp-level
// mma.sync with synchronous tile loads (not wgmma/TMA), so it reaches a
// fraction of the peak, and the int8 tiles' halved bytes show in its time.
// Decode (G = 1) is bound by the K/V bytes of the layer; the GQA packing
// reads each K/V tile once per kv head and split-K spreads the read over
// the SMs. An int8 cache reads 128 + 4 bytes per K or V row instead of 256.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kD = 128;            // head dim
constexpr int kBM = 64;            // packed rows per CTA (4 warps x 16)
constexpr int kBN = 64;            // keys per tile
constexpr int kThreads = 128;
constexpr int kKStride = kD + 8;   // smem row stride of K (bank-conflict pad)
constexpr int kK8Stride = kD + 16; // smem row stride of int8 K (bytes): 36
                                   // words, so the 8 rows of a fragment load
                                   // hit 8 distinct bank quads
constexpr int kVStride = kBN + 8;  // smem row stride of V^T

constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;  // lse of a row that sees no slot
constexpr int kPadRow = -2;        // bound of a padding row; a real row's
                                   // bound is >= -1 (pure past, length 0)

struct FlashParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  void* o;           // OutT: bf16 or f32
  float* lse;        // (hq, g) through lse_sh / lse_st, kLse only
  float* part_o;     // (n_split, hq, g, D) f32, split-K only
  float2* part_ml;   // (n_split, hq, g) (max, sum), split-K only
  long long q_sh, q_st, k_sh, k_st, v_sh, v_st, o_sh, o_st, lse_sh, lse_st;
  int hq, rep, g, length, cap, n_split;
  float scale_log2;
};

// The CTA's key range and this thread's two rows (accumulator rows g and
// g+8 of its warp), the same in every variant.
struct CtaRows {
  int head[2], pos[2];
  int bound[2];       // last visible slot (inclusive); kPadRow for padding
  int bound_lo;       // every real row of the CTA sees at least [0, bound_lo]
  int kend;           // nothing at or past kend is read
  int kb0, kb1;       // this split's key tiles
  bool has_pad_rows;
};

template <bool kPast>
__device__ __forceinline__ CtaRows cta_rows(const FlashParams& p) {
  const int warp = threadIdx.x >> 5;
  const int gq = (threadIdx.x & 31) >> 2;
  const int nrows = p.g * p.rep;
  const int row0 = blockIdx.x * kBM;
  CtaRows c;
  const int pos_hi = min(row0 + kBM - 1, nrows - 1) / p.rep;
  c.has_pad_rows = row0 + kBM > nrows;
  if constexpr (kPast) {
    c.bound_lo = p.length - 1;
    c.kend = min(p.length, p.cap);
  } else {
    c.bound_lo = p.length + row0 / p.rep;
    c.kend = min(p.length + pos_hi + 1, p.cap);
  }
  const int nkb = (c.kend + kBN - 1) / kBN;
  c.kb0 = 0;
  c.kb1 = nkb;
  if (p.n_split > 1) {
    const int chunk = (nkb + p.n_split - 1) / p.n_split;
    c.kb0 = min(nkb, (int)blockIdx.z * chunk);
    c.kb1 = min(nkb, c.kb0 + chunk);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + warp * 16 + gq + 8 * i;
    const bool ok = r < nrows;
    c.pos[i] = ok ? r / p.rep : 0;
    c.head[i] = blockIdx.y * p.rep + (ok ? r % p.rep : 0);
    c.bound[i] = !ok ? kPadRow : kPast ? p.length - 1 : p.length + c.pos[i];
  }
  return c;
}

// causal / length / padding mask is needed where the tile at key0 can cross
// some row's bound
__device__ __forceinline__ bool tile_needs_mask(const CtaRows& c, int key0) {
  return c.has_pad_rows || key0 + kBN - 1 > c.bound_lo;
}

// natural-log lse from the log2-space running max and the sum of p
__device__ __forceinline__ float lse_of(float m_log2, float l) {
  return l > 0.f ? m_log2 * kLn2 + logf(l) : kNegInf;
}

template <typename OutT>
__device__ __forceinline__ void store_pair(OutT* dst, float a, float b) {
  if constexpr (std::is_same_v<OutT, float>) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = qv::pack_bf16(a, b);
  }
}

// Online softmax over one tile of scores in log2 units: s becomes
// p = exp2(s - m) (f32), and m_run, l_run (per-thread partial row sums of
// the f32 p) and acc are brought up to date.
__device__ __forceinline__ void online_softmax(float (&s)[kBN / 8][4],
                                               float (&m_run)[2],
                                               float (&l_run)[2],
                                               float (&acc)[kD / 8][4]) {
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
    m_use[i] = m_new == -INFINITY ? 0.f : m_new;  // fully masked so far
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
  for (int dt = 0; dt < kD / 8; ++dt) {
    acc[dt][0] *= alpha[0];
    acc[dt][1] *= alpha[0];
    acc[dt][2] *= alpha[1];
    acc[dt][3] *= alpha[1];
  }
}

// O += P V against the transposed bf16 V tile: the score accumulators of
// key tiles 2kk, 2kk+1 are exactly the A fragment of a 16-key chunk
__device__ __forceinline__ void pv_product(const float (&s)[kBN / 8][4],
                                           const __nv_bfloat16* vt,
                                           float (&acc)[kD / 8][4]) {
  const int gq = (threadIdx.x & 31) >> 2;
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint32_t a0 = qv::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    const uint32_t a1 = qv::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    const uint32_t a2 = qv::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    const uint32_t a3 = qv::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      const __nv_bfloat16* vp = &vt[(dt * 8 + gq) * kVStride + kk * 16 + 2 * t4];
      qv::mma_bf16_16816(acc[dt], a0, a1, a2, a3, qv::ld32(vp), qv::ld32(vp + 8));
    }
  }
}

// The rows' output (unsplit) and lse, or their f32 partials and (max, sum)
// (split-K, merged by flash_merge_kernel)
template <bool kLse, typename OutT>
__device__ __forceinline__ void store_rows(const FlashParams& p,
                                           const CtaRows& c,
                                           const float (&acc)[kD / 8][4],
                                           const float (&m_run)[2],
                                           const float (&l_run)[2]) {
  const int t4 = threadIdx.x & 3;
  const float l_tot[2] = {qv::warp_sum4(l_run[0]), qv::warp_sum4(l_run[1])};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (c.bound[i] == kPadRow) continue;
    if (p.n_split == 1) {
      const float inv = l_tot[i] > 0.f ? 1.f / l_tot[i] : 0.f;
      OutT* orow = static_cast<OutT*>(p.o) + c.head[i] * p.o_sh +
                   (long long)c.pos[i] * p.o_st;
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) {
        store_pair(orow + dt * 8 + 2 * t4, acc[dt][2 * i] * inv,
                   acc[dt][2 * i + 1] * inv);
      }
      if constexpr (kLse) {
        if (t4 == 0) {
          p.lse[c.head[i] * p.lse_sh + (long long)c.pos[i] * p.lse_st] =
              lse_of(m_run[i], l_tot[i]);
        }
      }
    } else {
      const long long prow =
          ((long long)blockIdx.z * p.hq + c.head[i]) * p.g + c.pos[i];
      float* orow = p.part_o + prow * kD;
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) {
        *reinterpret_cast<float2*>(orow + dt * 8 + 2 * t4) =
            make_float2(acc[dt][2 * i], acc[dt][2 * i + 1]);
      }
      if (t4 == 0) p.part_ml[prow] = make_float2(m_run[i], l_tot[i]);
    }
  }
}

// Both kernels are capped at 168 registers, for 3 CTAs per SM. The int8
// variants are a kernel of their own because folding both into one
// template cost the bf16 kernel three registers, which took it from 3
// CTAs per SM to 2 and its group step from 2.72 to 3.10 ms (measured on an
// H100).
template <bool kPast, bool kLse, typename OutT>
__global__ void __launch_bounds__(kThreads, 3)
flash_fwd_kernel(FlashParams p) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBN * kKStride];
  __shared__ __align__(16) __nv_bfloat16 vt[kD * kVStride];

  const int tid = threadIdx.x;
  const int gq = (tid & 31) >> 2;  // accumulator row within the warp's 16
  const int t4 = tid & 3;
  const CtaRows c = cta_rows<kPast>(p);
  const __nv_bfloat16* qrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qrow[i] = c.bound[i] != kPadRow
                  ? p.q + c.head[i] * p.q_sh + (long long)c.pos[i] * p.q_st
                  : nullptr;
  }

  // Q fragments stay in registers for the whole key loop
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int col = kk * 16 + 2 * t4;
    qf[kk][0] = qrow[0] ? qv::ld32(qrow[0] + col) : 0u;
    qf[kk][1] = qrow[1] ? qv::ld32(qrow[1] + col) : 0u;
    qf[kk][2] = qrow[0] ? qv::ld32(qrow[0] + col + 8) : 0u;
    qf[kk][3] = qrow[1] ? qv::ld32(qrow[1] + col + 8) : 0u;
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  const __nv_bfloat16* kbase = p.k + blockIdx.y * p.k_sh;
  const __nv_bfloat16* vbase = p.v + blockIdx.y * p.v_sh;

  for (int kb = c.kb0; kb < c.kb1; ++kb) {
    const int key0 = kb * kBN;
    __syncthreads();  // previous tile fully consumed
    // K tile row-major, V tile transposed; rows past kend are zero
    for (int i = tid; i < kBN * (kD / 8); i += kThreads) {
      const int r = i / (kD / 8);
      const int c8 = (i % (kD / 8)) * 8;
      const int key = key0 + r;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (key < c.kend) {
        kv4 = *reinterpret_cast<const uint4*>(kbase + key * p.k_st + c8);
        vv4 = *reinterpret_cast<const uint4*>(vbase + key * p.v_st + c8);
      }
      *reinterpret_cast<uint4*>(&ks[r * kKStride + c8]) = kv4;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c8 + j) * kVStride + r] = ve[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt) {
        const __nv_bfloat16* kp = &ks[(nt * 8 + gq) * kKStride + kk * 16 + 2 * t4];
        qv::mma_bf16_16816(s[nt], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
                           qv::ld32(kp), qv::ld32(kp + 8));
      }
    }

    // scale into log2 units; mask
    const bool need_mask = tile_needs_mask(c, key0);
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale_log2;
        if (need_mask) {
          const int key = key0 + nt * 8 + 2 * t4 + (e & 1);
          if (key > c.bound[e >> 1]) x = -INFINITY;
        }
        s[nt][e] = x;
      }
    }
    online_softmax(s, m_run, l_run, acc);
    pv_product(s, vt, acc);
  }
  store_rows<kLse, OutT>(p, c, acc, m_run, l_run);
}

// The int8-QK variants: int8 K (and V when kV8) with per-token f32 scales,
// int8 q with per-row f32 scales.
struct FlashInt8Params {
  FlashParams b;     // strides, sizes, output, split-K partials
  const int8_t* q8;  // (hq, g, D) codes through b.q_sh / b.q_st
  const float* qs;   // (hq, g) contiguous; absorbed scale*log2 e
  const int8_t* k8;  // layer's K codes through b.k_sh / b.k_st
  const void* v;     // layer's V: int8 codes (kV8) or bf16
  const float* ksc;  // layer's (hkv, cap) K scales, stride 1 along cap
  const float* vsc;  // the same for V (kV8 only)
  long long ks_sh, vs_sh;
};

template <bool kV8, bool kPast, bool kLse, typename OutT>
__global__ void __launch_bounds__(kThreads, 3)
flash_fwd_int8_kernel(FlashInt8Params pi) {
  using VT = std::conditional_t<kV8, int8_t, __nv_bfloat16>;
  const FlashParams& p = pi.b;
  __shared__ __align__(16) int8_t ks[kBN * kK8Stride];
  __shared__ __align__(16) __nv_bfloat16 vt[kD * kVStride];
  __shared__ float ksc_s[kBN];
  __shared__ float vsc_s[kBN];

  const int tid = threadIdx.x;
  const int gq = (tid & 31) >> 2;  // accumulator row within the warp's 16
  const int t4 = tid & 3;
  const int hk = blockIdx.y;
  const CtaRows c = cta_rows<kPast>(p);
  const int8_t* qrow[2];
  float qsc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = c.bound[i] != kPadRow;
    qrow[i] = ok ? pi.q8 + c.head[i] * p.q_sh + (long long)c.pos[i] * p.q_st
                 : nullptr;
    qsc[i] = ok ? pi.qs[(long long)c.head[i] * p.g + c.pos[i]] : 0.f;
  }

  // int8 Q fragments stay in registers: 4 k-steps of 32 columns
  uint32_t qf[kD / 32][4];
#pragma unroll
  for (int kk = 0; kk < kD / 32; ++kk) {
    const int col = kk * 32 + 4 * t4;
    qf[kk][0] = qrow[0] ? qv::ld32(qrow[0] + col) : 0u;
    qf[kk][1] = qrow[1] ? qv::ld32(qrow[1] + col) : 0u;
    qf[kk][2] = qrow[0] ? qv::ld32(qrow[0] + col + 16) : 0u;
    qf[kk][3] = qrow[1] ? qv::ld32(qrow[1] + col + 16) : 0u;
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  const int8_t* kbase = pi.k8 + hk * p.k_sh;
  const VT* vbase = static_cast<const VT*>(pi.v) + hk * p.v_sh;

  for (int kb = c.kb0; kb < c.kb1; ++kb) {
    const int key0 = kb * kBN;
    __syncthreads();  // previous tile fully consumed
    // K codes row-major with the tile's scales; V transposed (int8 codes
    // converted to bf16, exactly); rows past kend are zero, as are their
    // scales
    for (int i = tid; i < kBN * (kD / 16); i += kThreads) {
      const int r = i / (kD / 16);
      const int c16 = (i % (kD / 16)) * 16;
      const int key = key0 + r;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u);
      if (key < c.kend) {
        kv4 = *reinterpret_cast<const uint4*>(kbase + key * p.k_st + c16);
      }
      *reinterpret_cast<uint4*>(&ks[r * kK8Stride + c16]) = kv4;
    }
    if (tid < kBN) {
      const int key = key0 + tid;
      ksc_s[tid] = key < c.kend ? pi.ksc[hk * pi.ks_sh + key] : 0.f;
      if constexpr (kV8) {
        vsc_s[tid] = key < c.kend ? pi.vsc[hk * pi.vs_sh + key] : 0.f;
      }
    }
    constexpr int kVPer = 16 / sizeof(VT);  // V elements per 16-byte load
    for (int i = tid; i < kBN * (kD / kVPer); i += kThreads) {
      const int r = i / (kD / kVPer);
      const int col = (i % (kD / kVPer)) * kVPer;
      const int key = key0 + r;
      uint4 vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (key < c.kend) {
        vv4 = *reinterpret_cast<const uint4*>(vbase + key * p.v_st + col);
      }
      const VT* ve = reinterpret_cast<const VT*>(&vv4);
#pragma unroll
      for (int j = 0; j < kVPer; ++j) {
        if constexpr (kV8) {
          vt[(col + j) * kVStride + r] = __float2bfloat16_rn((float)ve[j]);
        } else {
          vt[(col + j) * kVStride + r] = ve[j];
        }
      }
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys: exact s32 products
    int si[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      si[nt][0] = si[nt][1] = si[nt][2] = si[nt][3] = 0;
    }
#pragma unroll
    for (int kk = 0; kk < kD / 32; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt) {
        const int8_t* kp = &ks[(nt * 8 + gq) * kK8Stride + kk * 32 + 4 * t4];
        qv::mma_s8_16832(si[nt], qf[kk], qv::ld32(kp), qv::ld32(kp + 16));
      }
    }

    // into log2 units as (acc * qs[row]) * ks[col], the JAX kernel's order
    // (qs absorbed scale*log2 e); mask
    float s[kBN / 8][4];
    const bool need_mask = tile_needs_mask(c, key0);
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = ((float)si[nt][e] * qsc[e >> 1]) *
                  ksc_s[nt * 8 + 2 * t4 + (e & 1)];
        if (need_mask) {
          const int key = key0 + nt * 8 + 2 * t4 + (e & 1);
          if (key > c.bound[e >> 1]) x = -INFINITY;
        }
        s[nt][e] = x;
      }
    }
    online_softmax(s, m_run, l_run, acc);
    // the int8 variant scales p's columns by the V scales (pv = p * vs)
    if constexpr (kV8) {
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= vsc_s[nt * 8 + 2 * t4 + (e & 1)];
      }
    }
    pv_product(s, vt, acc);
  }
  store_rows<kLse, OutT>(p, c, acc, m_run, l_run);
}

// split-K merge: one CTA of kD threads per (head, position) row
template <bool kLse, typename OutT>
__global__ void __launch_bounds__(kD)
flash_merge_kernel(FlashParams p) {
  const int row = blockIdx.x;  // head * g + pos
  const int head = row / p.g;
  const int pos = row % p.g;
  const int d = threadIdx.x;
  float m = -INFINITY;
  for (int z = 0; z < p.n_split; ++z) {
    m = fmaxf(m, p.part_ml[(long long)z * p.hq * p.g + row].x);
  }
  float l = 0.f, acc = 0.f;
  if (m != -INFINITY) {
    for (int z = 0; z < p.n_split; ++z) {
      const long long prow = (long long)z * p.hq * p.g + row;
      const float2 ml = p.part_ml[prow];
      const float w = exp2f(ml.x - m);
      l += ml.y * w;
      acc += p.part_o[prow * kD + d] * w;
    }
  }
  const float o = l > 0.f ? acc / l : 0.f;
  OutT* orow = static_cast<OutT*>(p.o) + head * p.o_sh + (long long)pos * p.o_st;
  if constexpr (std::is_same_v<OutT, float>) {
    orow[d] = o;
  } else {
    orow[d] = __float2bfloat16(o);
  }
  if constexpr (kLse) {
    if (d == 0) p.lse[head * p.lse_sh + (long long)pos * p.lse_st] = lse_of(m, l);
  }
}

template <bool kLse, typename OutT>
cudaError_t merge_if_split(const FlashParams& p, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  flash_merge_kernel<kLse, OutT><<<p.hq * p.g, kD, 0, st>>>(p);
  return cudaGetLastError();
}

// Calls f(kPast, kLse, Tag<OutT>) with the modes as compile-time constants
// (std::bool_constant values and a type tag), so every mode is its own
// kernel instantiation.
template <typename T>
struct Tag {
  using type = T;
};

template <typename F>
cudaError_t with_mode(int past, int lse, int out_f32, F&& f) {
  auto by_out = [&](auto kp, auto kl) {
    return out_f32 ? f(kp, kl, Tag<float>{}) : f(kp, kl, Tag<__nv_bfloat16>{});
  };
  auto by_lse = [&](auto kp) {
    return lse ? by_out(kp, std::true_type{}) : by_out(kp, std::false_type{});
  };
  return past ? by_lse(std::true_type{}) : by_lse(std::false_type{});
}

void fill_common(FlashParams& p, void* o, void* lse, void* part_o,
                 void* part_ml, long long q_sh, long long q_st, long long k_sh,
                 long long k_st, long long v_sh, long long v_st,
                 long long o_sh, long long o_st, long long lse_sh,
                 long long lse_st, int hq, int hkv, int g, int length,
                 int cap, int n_split) {
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.part_o = static_cast<float*>(part_o);
  p.part_ml = static_cast<float2*>(part_ml);
  p.q_sh = q_sh; p.q_st = q_st; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sh = v_sh; p.v_st = v_st; p.o_sh = o_sh; p.o_st = o_st;
  p.lse_sh = lse_sh; p.lse_st = lse_st;
  p.hq = hq; p.rep = hq / hkv; p.g = g;
  p.length = length; p.cap = cap; p.n_split = n_split;
}

}  // namespace

// The arguments both entry points share, in this order: o, lse, part_o,
// part_ml; strides in elements (q_sh, q_st, k_sh, k_st, v_sh, v_st, o_sh,
// o_st, lse_sh, lse_st); hq, hkv, g, length, cap, n_split; past (pure-past
// mode), with_lse, out_f32 (f32 output, else bf16).
#define QV_FLASH_COMMON_PARAMS                                               \
  void *o, void *lse, void *part_o, void *part_ml, long long q_sh,           \
      long long q_st, long long k_sh, long long k_st, long long v_sh,        \
      long long v_st, long long o_sh, long long o_st, long long lse_sh,      \
      long long lse_st, int hq, int hkv, int g, int length, int cap,         \
      int n_split, int past, int with_lse, int out_f32
#define QV_FLASH_COMMON_ARGS                                                 \
  o, lse, part_o, part_ml, q_sh, q_st, k_sh, k_st, v_sh, v_st, o_sh, o_st,   \
      lse_sh, lse_st, hq, hkv, g, length, cap, n_split

// bf16 cache: q, k, v bf16
extern "C" int qv_flash_attention(const void* q, const void* k, const void* v,
                                  QV_FLASH_COMMON_PARAMS, float scale,
                                  void* stream) {
  FlashParams p;
  fill_common(p, QV_FLASH_COMMON_ARGS);
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((g * p.rep + kBM - 1) / kBM, hkv, n_split);
  return (int)with_mode(past, with_lse, out_f32, [&](auto kp, auto kl,
                                                     auto ot) {
    using OutT = typename decltype(ot)::type;
    flash_fwd_kernel<decltype(kp)::value, decltype(kl)::value, OutT>
        <<<grid, kThreads, 0, st>>>(p);
    return merge_if_split<decltype(kl)::value, OutT>(p, st);
  });
}

// int8 caches on the int8-QK route: q8 int8 with qs (hq, g) f32 contiguous
// (qs absorbed scale*log2 e); k int8 with its layer's (hkv, cap) scales
// ksc; v int8 with vsc (the "int8" cache), or bf16 with vsc == nullptr
// ("int8k"). Strides in elements; ks_sh / vs_sh are the scales' head
// strides.
extern "C" int qv_flash_attention_int8(
    const void* q8, const void* qs, const void* k, const void* ksc,
    const void* v, const void* vsc, QV_FLASH_COMMON_PARAMS, long long ks_sh,
    long long vs_sh, void* stream) {
  FlashInt8Params pi = {};
  FlashParams& p = pi.b;
  fill_common(p, QV_FLASH_COMMON_ARGS);
  pi.q8 = static_cast<const int8_t*>(q8);
  pi.qs = static_cast<const float*>(qs);
  pi.k8 = static_cast<const int8_t*>(k);
  pi.v = v;
  pi.ksc = static_cast<const float*>(ksc);
  pi.vsc = static_cast<const float*>(vsc);
  pi.ks_sh = ks_sh; pi.vs_sh = vs_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((g * p.rep + kBM - 1) / kBM, hkv, n_split);
  return (int)with_mode(past, with_lse, out_f32, [&](auto kp, auto kl,
                                                     auto ot) {
    using OutT = typename decltype(ot)::type;
    constexpr bool kP = decltype(kp)::value, kL = decltype(kl)::value;
    if (vsc != nullptr) {
      flash_fwd_int8_kernel<true, kP, kL, OutT><<<grid, kThreads, 0, st>>>(pi);
    } else {
      flash_fwd_int8_kernel<false, kP, kL, OutT><<<grid, kThreads, 0, st>>>(pi);
    }
    return merge_if_split<kL, OutT>(p, st);
  });
}

extern "C" const char* qv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
