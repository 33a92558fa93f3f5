// Kernel B1: GQA flash attention over one layer of the stacked KV cache,
// for Hopper (sm_90a). Three kernels:
//   flash_prefill_kernel    bf16 cache, prefill shapes (G * rep >= 192
//                           packed rows: the group steps, the final prefill
//                           of a long question);
//   flash_fwd_kernel        bf16 cache, small G (decode at G = 1, a short
//                           final prefill or query-based group 0);
//   flash_fwd_int8_kernel   the int8 caches on the int8-QK route, every G.
// ops/flash_attention.py::_plan picks by shape (and variant) alone.
//
// Each replaces the TPU kernel
// quickvideo_tpu/ops/flash_attention.py::_flash_kernel (entry
// _flash_past_attention_impl, pallas_call at :502) in both its modes:
//   unified causal  query row i of a group of G rows attends cache slots
//                   [0, length + i]; the caller has already appended the
//                   group's K/V at [length, length + G);
//   pure past       every row attends [0, length) (length 0: out 0, lse
//                   NEG_INF), the query-based mode's past partial;
// each with or without the log-sum-exp (natural log, f32 (Hq, G) through
// strides), and with a bf16 or f32 output. The three are template
// parameters (kPast, kLse, OutT), so every mode is its own instantiation.
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
// Common to all three.
//  * GQA packing: a CTA serves one kv head and a block of "packed rows",
//    packed row r = (position r / rep, query head kv*rep + r % rep). The rep
//    (= 7 on the 7B) query heads that share a kv head read each K/V tile from
//    shared memory once. rep need not be a power of two.
//  * Keys in tiles of 64. Online softmax in f32, in log2 units (bf16: scores
//    scaled by scale*log2 e); the denominator sums the f32 p; P is rounded
//    to bf16 for the PV product.
//  * A CTA's keys stop at min(length + its last position + 1, cap). Tiles
//    wholly below every row's bound skip the mask.
//  * Split-K: when the CTAs do not fill the card, a third grid axis splits
//    each CTA's key range; the splits write f32 partials plus (max, sum) per
//    row and flash_merge_kernel merges them (every variant).
//
// The small-G and int8 kernels: 4 warps x 16 packed rows per CTA, K/V tiles
// staged by plain loads between barriers (V transposed by scalar stores),
// mma.sync m16n8k16 for both products (int8-QK: QK^T on m16n8k32, exact s32,
// then s = (float(acc) * qs[row]) * ks[col], the JAX kernel's order; qs
// absorbed scale*log2 e; the tile's key scales staged in shared memory;
// int8 V codes converted to bf16 exactly while staging, p * vs[col] formed
// before the bf16 packing, as `pv = p * vs` in the JAX kernel).
//
// The prefill kernel (below: one producer warpgroup on a TMA ring of K/V
// tiles, three consumer warpgroups of 64 rows on wgmma).
//
// What bounds them. Prefill is tensor-core work: 4 * 128 flops per
// attended (query head, slot) pair, about 2.9 ms at 989 TFLOP/s for the
// 1024-frame headline's last group step (G = 3600 over 53,744 slots). The
// bytes are small beside it if each K/V tile is read once per kv head, but
// a CTA of 64 packed rows (the small-G kernel's) reads its head's whole
// prefix again: 394 row blocks x 27.5 MB per kv head at that step, ~43 GB
// from L2 or device memory per call, against a bound that counts 110 MB.
// That, the loads and products taking turns, and mma.sync instead of wgmma
// held the 64-row kernel at 7-8% of the operations bound (measured on an
// H100). The prefill kernel shares each K/V tile among 192 packed rows
// (three times fewer re-reads), keeps the loads in flight on TMA while the
// consumers compute, and runs both products on wgmma with the previous
// tile's P V overlapping this tile's softmax. Decode (G = 1) is bound by
// the K/V bytes of the layer: the small-G kernel reads each tile once per kv
// head and split-K spreads the read over the SMs. An int8 cache reads 128 +
// 4 bytes per K or V row instead of 256.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up
#include <dlfcn.h>
#include <limits.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kD = 128;            // head dim
constexpr int kBM = 64;            // packed rows per CTA of the small-G and
                                   // int8 kernels (4 warps x 16)
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

// -- the prefill kernel --------------------------------------------------------
//
// One CTA: one kv head, kPRows packed rows (kPWG consumer warpgroups of 64
// rows each) and one producer warpgroup. The producer's first thread keeps
// the K/V ring full with TMA (a 3D tensor map over the layer view: head dim,
// slot, kv head; 64-slot x 64-column boxes under the 128-byte swizzle, two
// per 128-wide row, zeros past the map's slot count); the consumers stage
// their Q rows once by cp.async into the same swizzled layout, then per key
// tile issue S = Q K^T (wgmma m64n64k16 x 8, both operands K-major from
// shared memory) and O += P V (m64n128k16 x 4, P from registers, V read
// MN-major through the transpose bit), the previous tile's P V running
// while they do this tile's softmax. setmaxnreg moves the producer's
// registers to the consumers.
constexpr int kPWG = 3;                      // consumer warpgroups
constexpr int kPRows = 64 * kPWG;            // packed rows per CTA
constexpr int kPStages = 4;                  // K/V ring slots
constexpr int kPThreads = 128 * (kPWG + 1);  // + the producer warpgroup
constexpr int kConsumerRegs = 160;           // 128 * (3 * 160 + 24) <= 64K
constexpr int kProducerRegs = 24;
constexpr int kBox = 64 * 128;  // bytes of one 64-row x 64-column bf16 box
constexpr int kTile = 2 * kBox; // a 64-row x 128-column tile: two boxes
// Q tiles, K and V rings, full and empty barriers, alignment slack
constexpr int kPrefillSmem =
    (kPWG + 2 * kPStages) * kTile + 2 * kPStages * 8 + 1024;

using qv::smem_u32;

// byte offset of 16-byte chunk c (0..15) of row r of a tile: the layout TMA
// writes under CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte-aligned box (the
// chunk index XOR the row's index within its 8-row, 1024-byte atom)
__device__ __forceinline__ int sw128(int r, int c) {
  return (c >> 3) * kBox + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma descriptor of a 128-byte-swizzled operand (layout type 1): 8-row
// groups 1024 bytes apart (SBO); LBO is the distance between 64-column
// boxes along N for an MN-major operand, unused for a K-major one
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// D (64 x 128, f32) += A (64 x 16, registers) B (16 x 128, MN-major in
// shared memory: the transpose bit)
__device__ __forceinline__ void wgmma_m64n128k16_rs(
    float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// spin until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: box (c0, c1, c2) of `map` into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// the 128 threads of consumer warpgroup wg (named barriers 1..kPWG)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// This CTA's kv head, first packed row and key tiles [kb0, kb1). Row
// blocks run in reverse (blockIdx.y 0 takes the last block): in unified
// mode the longest key ranges start first. Mirrored by
// ops/flash_attention.py::cta_key_tiles.
struct PrefillCta {
  int hk, row0, kb0, kb1;
};

template <bool kPast>
__device__ __forceinline__ PrefillCta prefill_cta(const FlashParams& p) {
  const int nrows = p.g * p.rep;
  const int nrb = (nrows + kPRows - 1) / kPRows;
  PrefillCta c;
  c.hk = blockIdx.x;
  c.row0 = (nrb - 1 - (int)blockIdx.y) * kPRows;
  const int pos_hi = (min(c.row0 + kPRows, nrows) - 1) / p.rep;
  const int kend = kPast ? min(p.length, p.cap)
                         : min(p.length + pos_hi + 1, p.cap);
  const int nkb = (kend + kBN - 1) / kBN;
  const int chunk = (nkb + p.n_split - 1) / p.n_split;
  c.kb0 = min(nkb, (int)blockIdx.z * chunk);
  c.kb1 = min(nkb, c.kb0 + chunk);
  return c;
}

// The warpgroup's 64 output rows through its Q tile (free once its products
// are done): registers -> swizzled shared memory -> 16-byte row chunks into
// the output (unsplit: o through its strides, scaled by 1 / l) or the f32
// partials (split-K: unscaled). An f32 row takes two passes of 64 columns.
// Padding rows are not written.
template <typename T>
__device__ __forceinline__ void store_out(const FlashParams& p,
                                          const PrefillCta& c, int wg,
                                          unsigned char* stage,
                                          const float (&o)[64],
                                          const float (&scl)[2], bool split) {
  constexpr int kPassCols = 256 / sizeof(T);  // columns per 256-byte row
  constexpr int kPasses = kD / kPassCols;
  const int tid = threadIdx.x & 127, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t4 = tid & 3;
  const int nrows = p.g * p.rep;
  const int wrow0 = c.row0 + 64 * wg;
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
#pragma unroll
    for (int j = 0; j < kPassCols / 8; ++j) {
      const int dt = pass * (kPassCols / 8) + j;  // 8-column group of o
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 16 * warp + g + 8 * i;
        const int byte = (8 * j + 2 * t4) * sizeof(T);
        unsigned char* dst = stage + sw128(r, byte >> 4) + (byte & 15);
        const float a = o[dt * 4 + 2 * i] * scl[i];
        const float b = o[dt * 4 + 2 * i + 1] * scl[i];
        if constexpr (std::is_same_v<T, float>) {
          *reinterpret_cast<float2*>(dst) = make_float2(a, b);
        } else {
          *reinterpret_cast<uint32_t*>(dst) = qv::pack_bf16(a, b);
        }
      }
    }
    wg_sync(wg);
    for (int j = tid; j < 64 * 16; j += 128) {
      const int r = j >> 4, ch = j & 15;
      const int pr = wrow0 + r;
      if (pr >= nrows) continue;
      const int head = c.hk * p.rep + pr % p.rep, pos = pr / p.rep;
      T* row = split ? reinterpret_cast<T*>(
                           p.part_o + (((long long)blockIdx.z * p.hq + head) *
                                           p.g + pos) * kD)
                     : static_cast<T*>(p.o) + head * p.o_sh +
                           (long long)pos * p.o_st;
      *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(row) +
                                pass * 256 + ch * 16) =
          *reinterpret_cast<const uint4*>(stage + sw128(r, ch));
    }
    if (pass + 1 < kPasses) wg_sync(wg);
  }
}

template <bool kPast, bool kLse, typename OutT>
__global__ void __launch_bounds__(kPThreads, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const FlashParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;                   // [kPWG] Q tiles
  unsigned char* ks = qs + kPWG * kTile;      // [kPStages] K tiles
  unsigned char* vs = ks + kPStages * kTile;  // [kPStages] V tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + kPStages * kTile);
  uint64_t* empty = full + kPStages;
  const int wg = threadIdx.x >> 7;
  const PrefillCta c = prefill_cta<kPast>(p);
  const int n = c.kb1 - c.kb0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kPStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kPWG);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kPWG) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kPWG * 128) {
      for (int t = 0; t < n; ++t) {
        const int st = t % kPStages;
        // the slot's previous tile released by every consumer warp
        if (t >= kPStages) mbar_wait(&empty[st], (t / kPStages - 1) & 1);
        mbar_expect_tx(&full[st], 2 * kTile);
        const int key0 = (c.kb0 + t) * kBN;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          tma_load(ks + st * kTile + h * kBox, &tk, 64 * h, key0, c.hk,
                   &full[st]);
          tma_load(vs + st * kTile + h * kBox, &tv, 64 * h, key0, c.hk,
                   &full[st]);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nrows = p.g * p.rep;
  const int wrow0 = c.row0 + 64 * wg;
  unsigned char* qw = qs + wg * kTile;

  // this warpgroup's Q rows, once (packed rows are not one TMA box);
  // padding rows are zeros
  for (int i = tid; i < 64 * 16; i += 128) {
    const int r = i >> 4, ch = i & 15;
    const bool ok = wrow0 + r < nrows;
    const int pr = ok ? wrow0 + r : 0;
    const __nv_bfloat16* src = p.q +
                               (c.hk * p.rep + pr % p.rep) * p.q_sh +
                               (long long)(pr / p.rep) * p.q_st + ch * 8;
    qv::cp_async16(qw + sw128(r, ch), src, ok);
  }
  qv::cp_async_commit();
  qv::cp_async_wait<0>();
  qv::fence_proxy_async();
  wg_sync(wg);

  // this thread's rows' last visible slots; padding rows see everything
  // (they are never stored), so only real rows' bounds decide the mask
  int bound[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pr = wrow0 + 16 * warp + g + 8 * i;
    bound[i] = pr >= nrows ? INT_MAX
               : kPast     ? p.length - 1
                           : p.length + pr / p.rep;
  }
  const int bound_lo = wrow0 >= nrows ? INT_MAX
                       : kPast        ? p.length - 1
                                      : p.length + wrow0 / p.rep;

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float alpha[2];
  float s[32];
  uint32_t pa[kBN / 16][4];  // P of the previous tile: the A operand of P V
  const uint64_t qdesc = sw128_desc(qw, 16);

  // S = Q K_t^T: 8 k-steps of 16 columns, 32 bytes apart within a box
  auto issue_s = [&](int t) {
    const int st = t % kPStages;
    mbar_wait(&full[st], (t / kPStages) & 1);
    const uint64_t kdesc = sw128_desc(ks + st * kTile, 16);
    qv::reg_fence(s);
    qv::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint64_t off = (kk >> 2) * (kBox >> 4) + (kk & 3) * 2;
      qv::wgmma_m64n64k16_ss(s, qdesc + off, kdesc + off, kk > 0);
    }
    qv::wgmma_commit();
  };
  // O += P V_t: keys [16kk, 16kk + 16) are rows 16kk.. of both V boxes
  auto issue_pv = [&](int t) {
    const uint64_t vdesc = sw128_desc(vs + (t % kPStages) * kTile, kBox);
    qv::reg_fence(o);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      wgmma_m64n128k16_rs(o, pa[kk], vdesc + kk * (16 * 128 >> 4));
    }
    qv::wgmma_commit();
  };
  // softmax of S_t in place (s becomes P_t, unrounded), in log2 units:
  // scale_log2 > 0 commutes with the max and goes into one FFMA per score;
  // alpha rescales the running sums. Only tiles that cross some real row's
  // bound are masked.
  auto softmax = [&](int t) {
    const int key0 = (c.kb0 + t) * kBN;
    if (key0 + kBN - 1 > bound_lo) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = key0 + (i >> 2) * 8 + 2 * t4 + (i & 1);
        if (key > bound[(i >> 1) & 1]) s[i] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new =
          fmaxf(m_run[i], qv::warp_max4(mx[i]) * p.scale_log2);
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;  // fully masked so far
      alpha[i] = qv::ex2(m_run[i] - m_use[i]);
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float pe = qv::ex2(fmaf(s[i], p.scale_log2, -m_use[(i >> 1) & 1]));
      s[i] = pe;
      l_run[(i >> 1) & 1] += pe;
    }
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      pa[kk][0] = qv::pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = qv::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = qv::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = qv::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  // Every warpgroup runs every product, also on padding rows (zero Q): a
  // wgmma on a divergent path would make ptxas serialize the pipeline. The
  // first tile is peeled; the slot of tile t - 1 is released once its P V
  // is done.
  if (n > 0) {
    issue_s(0);
    qv::wgmma_wait<0>();
    qv::reg_fence(s);
    softmax(0);
    pack_p();
    for (int t = 1; t < n; ++t) {
      issue_s(t);
      issue_pv(t - 1);
      qv::wgmma_wait<1>();  // S_t done; P_{t-1} V_{t-1} may still run
      qv::reg_fence(s);
      softmax(t);
      qv::wgmma_wait<0>();  // P_{t-1} V_{t-1} is in O; pa and the slot free
      qv::reg_fence(o);
      if (lane == 0) mbar_arrive(&empty[(t - 1) % kPStages]);
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_p();
    }
    qv::wgmma_fence();
    issue_pv(n - 1);
    qv::wgmma_wait<0>();
    qv::reg_fence(o);
  }

  const bool split = p.n_split > 1;
  float l_tot[2], scl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_tot[i] = qv::warp_sum4(l_run[i]);
    scl[i] = split ? 1.f : l_tot[i] > 0.f ? 1.f / l_tot[i] : 0.f;
    const int pr = wrow0 + 16 * warp + g + 8 * i;
    if (t4 != 0 || pr >= nrows) continue;
    const int head = c.hk * p.rep + pr % p.rep, pos = pr / p.rep;
    if (split) {
      p.part_ml[((long long)blockIdx.z * p.hq + head) * p.g + pos] =
          make_float2(m_run[i], l_tot[i]);
    } else if constexpr (kLse) {
      p.lse[head * p.lse_sh + (long long)pos * p.lse_st] =
          lse_of(m_run[i], l_tot[i]);
    }
  }
  wg_sync(wg);  // every warp of the warpgroup is done with its Q tile
  if (split) {
    store_out<float>(p, c, wg, qw, o, scl, true);
  } else {
    store_out<OutT>(p, c, wg, qw, o, scl, false);
  }
}

// dynamic shared memory above 48 KB, opted into once per instantiation
template <bool kPast, bool kLse, typename OutT>
cudaError_t prefill_smem_once() {
  static cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<kPast, kLse, OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kPrefillSmem);
  return err;
}

// cuTensorMapEncodeTiled, from the driver library that the CUDA runtime has
// loaded into the process: nothing links against libcuda at build time
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// The tensor map of one layer view (hkv, cap, kD) with strides st (slot)
// and sh (head), in elements: dims (kD, slots, hkv), boxes of 64 columns x
// kBN slots x 1 head, 128-byte swizzle. Slots at or past `slots` (the
// call's reach) read as zeros, so nothing past the valid prefix and the
// group is loaded.
cudaError_t layer_map(CUtensorMap* map, const void* base, long long st,
                      long long sh, int slots, int hkv) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[3] = {kD, (cuuint64_t)std::max(slots, 1), (cuuint64_t)hkv};
  const cuuint64_t strides[2] = {(cuuint64_t)st * 2, (cuuint64_t)sh * 2};
  const cuuint32_t box[3] = {64, kBN, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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

// bf16 cache, prefill shapes (G * rep >= the prefill kernel's 192 rows; the
// wrapper's _plan picks): arguments as qv_flash_attention; q rows 16-byte
// aligned. Row blocks of kPRows on grid (hkv, blocks, n_split).
extern "C" int qv_flash_prefill(const void* q, const void* k, const void* v,
                                QV_FLASH_COMMON_PARAMS, float scale,
                                void* stream) {
  FlashParams p;
  fill_common(p, QV_FLASH_COMMON_ARGS);
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.scale_log2 = scale * 1.4426950408889634f;
  const int slots = std::min(past ? length : length + g, cap);
  CUtensorMap tk, tv;
  cudaError_t err = layer_map(&tk, k, k_st, k_sh, slots, hkv);
  if (err == cudaSuccess) err = layer_map(&tv, v, v_st, v_sh, slots, hkv);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(hkv, (g * p.rep + kPRows - 1) / kPRows, n_split);
  return (int)with_mode(past, with_lse, out_f32, [&](auto kp, auto kl,
                                                     auto ot) {
    using OutT = typename decltype(ot)::type;
    constexpr bool kP = decltype(kp)::value, kL = decltype(kl)::value;
    const cudaError_t e = prefill_smem_once<kP, kL, OutT>();
    if (e != cudaSuccess) return e;
    flash_prefill_kernel<kP, kL, OutT>
        <<<grid, kPThreads, kPrefillSmem, st>>>(tk, tv, p);
    return merge_if_split<kL, OutT>(p, st);
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

// Registers, local (spill) bytes, static and dynamic shared memory of B1's
// kernels, by index: 8 * family + mode, family 0 the small-G kernel, 1 the
// prefill kernel, 2 int8, 3 int8k, 4 the split-K merge (modes 0-3); mode
// bits 4 pure past, 2 lse, 1 f32 output. Returns a CUDA error.
extern "C" int qv_flash_kernel_info(int which, int* regs, int* local_bytes,
                                    int* static_smem, int* dynamic_smem) {
  if (which < 0 || which >= 36) return (int)cudaErrorInvalidValue;
  const int family = which / 8, m = which % 8;
  cudaFuncAttributes a;
  int dyn = 0;
  const cudaError_t err = with_mode(m & 4, m & 2, m & 1, [&](auto kp, auto kl,
                                                            auto ot) {
    using OutT = typename decltype(ot)::type;
    constexpr bool kP = decltype(kp)::value, kL = decltype(kl)::value;
    switch (family) {
      case 0: return cudaFuncGetAttributes(&a, flash_fwd_kernel<kP, kL, OutT>);
      case 1:
        dyn = kPrefillSmem;
        return cudaFuncGetAttributes(&a, flash_prefill_kernel<kP, kL, OutT>);
      case 2:
        return cudaFuncGetAttributes(&a,
                                     flash_fwd_int8_kernel<true, kP, kL, OutT>);
      case 3:
        return cudaFuncGetAttributes(
            &a, flash_fwd_int8_kernel<false, kP, kL, OutT>);
      default: return cudaFuncGetAttributes(&a, flash_merge_kernel<kL, OutT>);
    }
  });
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *static_smem = (int)a.sharedSizeBytes;
  *dynamic_smem = dyn;
  return 0;
}

extern "C" const char* qv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
