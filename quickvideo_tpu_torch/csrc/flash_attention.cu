// Kernel B1: GQA flash attention over one layer of the stacked KV cache,
// for Hopper (sm_90a). Two kernels, each for every cache variant:
//   flash_prefill_kernel  prefill shapes (G * rep >= 192 packed rows: the
//                         group steps, the final prefill of a long
//                         question); tensor-core bound;
//   flash_decode_kernel   the rest (decode at G = 1, a short final prefill,
//                         query-based group 0); bound by the bytes of K/V.
// ops/flash_attention.py::_plan picks by shape alone.
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
// Variants (template parameter kVar):
//   bf16   bf16 q, K, V (the "bfloat16" cache);
//   int8   int8 K and V with one f32 scale per (head, token) row, int8 q
//          with one f32 scale per (head, row) ("int8" cache, int8-QK);
//   int8k  int8 K with scales, bf16 V, int8 q ("int8k" cache, int8-QK).
// The int8-QK arithmetic is the JAX kernel's: QK^T exact in s32, then
// s = (float(acc) * qs[row]) * ks[col] (qs absorbed scale * log2 e), the
// denominator sums the f32 p, and the PV operand is p * vs[col] (int8) or
// p, rounded to bf16, against V codes converted to bf16 exactly.
//
// Operands: q (Hq, G, 128) is read through strides; the layer views k/v
// (Hkv, cap, 128) and their (Hkv, cap) scales are read by TMA through
// tensor maps that end at the call's reach (length + G, or length in pure
// past), so the box's out-of-bounds fill gives zeros past it: nothing past
// the valid prefix and the group is loaded, and NaN there cannot reach P V.
// The output is written through strides ((G, Hq, 128) storage lets the
// o-projection read it without a transpose).
//
// Common to both:
//  * GQA packing: a CTA serves one kv head and a block of "packed rows",
//    packed row r = (position r / rep, query head kv*rep + r % rep). The rep
//    (= 7 on the 7B) query heads that share a kv head read each K/V tile from
//    shared memory once. rep need not be a power of two.
//  * Keys in tiles of 64, staged in a ring of slots that one producer thread
//    keeps full by TMA (full / empty mbarriers): no CTA-wide barrier stands
//    between the load of tile t + 1 and the use of tile t. Online softmax in
//    f32, in log2 units; P is rounded to bf16 for the PV product.
//  * A CTA's keys stop at min(length + its last position + 1, cap). Row
//    blocks run in reverse (the longest key ranges first in unified mode).
//    Tiles wholly below every row's bound skip the mask.
//  * Split-K: when the CTAs do not fill the card, a third grid axis splits
//    each CTA's key range; the splits write f32 partials plus (max, sum) per
//    row, merged by flash_merge_kernel (a second launch: measured on an H100
//    it beat a merge inside the decode kernel by the split that finishes
//    last, whose one CTA read every split's partial alone).
//
// What bounds them. Prefill is tensor-core work: 4 * 128 flops per attended
// (query head, slot) pair, about 2.9 ms at 989 TFLOP/s for the 1024-frame
// headline's last group step (G = 3600 over 53,744 slots). The prefill
// kernel shares each K/V tile among 192 packed rows (three consumer
// warpgroups of 64 rows on wgmma), so a kv head's prefix is read G * rep /
// 192 times, not G * rep / 64. Decode (G = 1) is bound by the bytes of the
// layer's K/V (and scales): 117 MB per call over 57,344 bf16 slots, 35 us at
// 3.35 TB/s. The decode kernel sizes its rows to the packed rows (one m16
// row tile: 7 real rows at G = 1), lets its four warps split each tile's
// keys, and keeps a deep ring of tiles in flight on every SM (one CTA per
// SM, six to twelve slots); an int8 cache reads 128 + 4 bytes per K or V
// row instead of 256.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up
#include <dlfcn.h>
#include <limits.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kD = 128;   // head dim
constexpr int kBN = 64;   // keys per tile
constexpr int kBox = 64 * 128;  // bytes of one 64-row x 128-byte TMA box
constexpr int kTile = 2 * kBox; // a 64-row x 128-column bf16 tile: two boxes

constexpr int kBf16 = 0, kInt8 = 1, kInt8k = 2;  // cache variants

constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;  // lse of a row that sees no slot

struct FlashParams {
  const void* q;     // bf16 rows, or int8 codes on the int8-QK route
  const float* qs;   // int8-QK: (hq, g) per-row q scales, contiguous
  void* o;           // OutT: bf16 or f32
  float* lse;        // (hq, g) through lse_sh / lse_st, kLse only
  float* part_o;     // (n_split, hq, g, D) f32, split-K only
  float2* part_ml;   // (n_split, hq, g) (max, sum), split-K only
  long long q_sh, q_st, o_sh, o_st, lse_sh, lse_st;
  int hq, rep, g, length, cap, n_split;
  float scale_log2;
};

// natural-log lse from the log2-space running max and the sum of p
__device__ __forceinline__ float lse_of(float m_log2, float l) {
  return l > 0.f ? m_log2 * kLn2 + logf(l) : kNegInf;
}

template <typename OutT>
__device__ __forceinline__ void store_one(OutT* dst, float x) {
  if constexpr (std::is_same_v<OutT, float>) {
    *dst = x;
  } else {
    *dst = __float2bfloat16(x);
  }
}

// split-K merge: one CTA per (head, position) row, kMergeWays groups of
// kD threads, group j taking splits j, j + kMergeWays, ... (independent
// loads). The row's max m over the splits' maxima first; then column d of
// each group's partials weighted by 2^(m_z - m), and the weighted sums;
// the groups' sums added in a fixed order. lse from both.
constexpr int kMergeWays = 4;

template <bool kLse, typename OutT>
__global__ void __launch_bounds__(kD * kMergeWays)
flash_merge_kernel(FlashParams p) {
  __shared__ float red[kMergeWays];
  __shared__ float part[kMergeWays][kD + 1];  // [group][column], sum last
  const int row = blockIdx.x;  // head * g + pos
  const int d = threadIdx.x % kD, j = threadIdx.x / kD;
  const long long zst = (long long)p.hq * p.g;
  float m = -INFINITY;
  for (int z = j; z < p.n_split; z += kMergeWays) {
    m = fmaxf(m, p.part_ml[z * zst + row].x);
  }
  if (d == 0) red[j] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int i = 1; i < kMergeWays; ++i) m = fmaxf(m, red[i]);
  float l = 0.f, acc = 0.f;
  if (m != -INFINITY) {
#pragma unroll 4
    for (int z = j; z < p.n_split; z += kMergeWays) {
      const long long prow = z * zst + row;
      const float2 ml = p.part_ml[prow];
      const float w = exp2f(ml.x - m);
      l += ml.y * w;
      acc += p.part_o[prow * kD + d] * w;
    }
  }
  part[j][d] = acc;
  if (d == 0) part[j][kD] = l;
  __syncthreads();
  if (j != 0) return;
  acc = part[0][d];
  l = part[0][kD];
#pragma unroll
  for (int i = 1; i < kMergeWays; ++i) {
    acc += part[i][d];
    l += part[i][kD];
  }
  const int head = row / p.g, pos = row % p.g;
  OutT* orow = static_cast<OutT*>(p.o) + head * p.o_sh + (long long)pos * p.o_st;
  store_one(orow + d, l > 0.f ? acc / l : 0.f);
  if constexpr (kLse) {
    if (d == 0) p.lse[head * p.lse_sh + (long long)pos * p.lse_st] = lse_of(m, l);
  }
}

template <bool kLse, typename OutT>
cudaError_t merge_if_split(const FlashParams& p, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  flash_merge_kernel<kLse, OutT><<<p.hq * p.g, kD * kMergeWays, 0, st>>>(p);
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

// -- the 128-byte swizzle (TMA, mbarrier, descriptor helpers: common.cuh) -----

using qv::smem_u32;

// byte offset of 16-byte chunk c of row r of a tile: the layout TMA writes
// under CU_TENSOR_MAP_SWIZZLE_128B into 1024-byte-aligned boxes of 128-byte
// rows (the chunk index XOR the row's index within its 8-row, 1024-byte
// atom); chunks 8.. lie in the next box
__device__ __forceinline__ int sw128(int r, int c) {
  return (c >> 3) * kBox + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

using qv::align1024;
using qv::bar_sync;
using qv::mbar_arrive;
using qv::mbar_expect_tx;
using qv::mbar_init;
using qv::mbar_wait;
using qv::sw128_desc;
using qv::tma_load;
using qv::tma_load_2d;

// the K (and V) tile of key0 into a ring slot: bf16 rows as two 64-column
// boxes, int8 rows as one 128-byte box
template <bool kByte>
__device__ __forceinline__ void load_rows(unsigned char* dst,
                                          const CUtensorMap* map, int key0,
                                          int hk, uint64_t* bar) {
  tma_load(dst, map, 0, key0, hk, bar);
  if constexpr (!kByte) tma_load(dst + kBox, map, 64, key0, hk, bar);
}

// Byte k of xb = x ^ 0x80808080 (four int8 codes, each + 128) as the f32
// value of code k, exactly: 0x4B0000XX is 2^23 + XX. A byte permute and an
// FADD, where a cast would take an I2F (quarter rate on this card).
__device__ __forceinline__ float s8_byte(uint32_t xb, int k) {
  return __int_as_float(__byte_perm(xb, 0x4B000000u, 0x7540 | k)) - 8388736.f;
}

// two int8 codes, bytes e and e + 2 of x, as one bf16 pair (exact)
__device__ __forceinline__ uint32_t s8pair_bf16(uint32_t x, int e) {
  const uint32_t xb = x ^ 0x80808080u;
  return qv::pack_bf16(s8_byte(xb, e), s8_byte(xb, e + 2));
}

// This CTA's kv head, first packed row and key tiles [kb0, kb1), for row
// blocks of kRows. Row blocks run in reverse (blockIdx.y 0 takes the last
// block): in unified mode the longest key ranges start first. Mirrored by
// ops/flash_attention.py::cta_key_tiles.
struct B1Cta {
  int hk, row0, kb0, kb1;
};

template <bool kPast, int kRows>
__device__ __forceinline__ B1Cta b1_cta(const FlashParams& p) {
  const int nrows = p.g * p.rep;
  const int nrb = (nrows + kRows - 1) / kRows;
  B1Cta c;
  c.hk = blockIdx.x;
  c.row0 = (nrb - 1 - (int)blockIdx.y) * kRows;
  const int pos_hi = (min(c.row0 + kRows, nrows) - 1) / p.rep;
  const int kend = kPast ? min(p.length, p.cap)
                         : min(p.length + pos_hi + 1, p.cap);
  const int nkb = (kend + kBN - 1) / kBN;
  const int chunk = (nkb + p.n_split - 1) / p.n_split;
  c.kb0 = min(nkb, (int)blockIdx.z * chunk);
  c.kb1 = min(nkb, c.kb0 + chunk);
  return c;
}

// -- the decode kernel ---------------------------------------------------------
//
// One CTA: one kv head, one m16 tile of packed rows (7 real rows at G = 1 on
// the 7B) and one split of the key range; four consumer warps and one
// producer warp. The producer's first lane keeps a ring of kStages K/V
// tiles (and their scales, about 200 KB) full by TMA. Each consumer warp takes 16 keys of
// every tile: S = Q K^T on mma.sync (bf16 m16n8k16, or s8 m16n8k32 with exact
// s32 sums), K fragments by ldmatrix from the swizzled tile; the online
// softmax over its keys; O += P V with V read where it lies by
// ldmatrix.trans (int8 codes: each 32-bit lane value holds two keys x two
// columns; they become bf16 pairs in registers, exactly, and the output
// columns of the two mma tiles they feed interleave). Nothing but the
// tile's mbarriers orders the warps. At the end the four warps' (max, sum,
// O) combine through shared memory in a fixed order, and the CTA writes its
// rows, or its split's partial for flash_merge_kernel.
constexpr int kDRows = 16;        // packed rows per CTA
constexpr int kDWarps = 4;        // consumer warps
constexpr int kDThreads = 32 * (kDWarps + 1);

template <int kVar>
struct DecodeRing {
  static constexpr int kKBytes = kVar == kBf16 ? kTile : kBox;
  static constexpr int kVBytes = kVar == kInt8 ? kBox : kTile;
  static constexpr int kScaleBytes =
      kVar == kBf16 ? 0 : (kVar == kInt8 ? 2 : 1) * kBN * 4;
  static constexpr int kTx = kKBytes + kVBytes + kScaleBytes;  // per tile
  static constexpr int kStage = (kTx + 1023) / 1024 * 1024;
  // about 200 KB of ring, one CTA per SM: faster at decode on an H100 than
  // half the depth at two CTAs per SM, or a third at three
  static constexpr int kStages = kVar == kBf16 ? 6 : kVar == kInt8 ? 12 : 8;
  static constexpr int kSmem = kStages * kStage + 2 * kStages * 8 + 1024;
};

template <int kVar, bool kPast, bool kLse, typename OutT>
__global__ void __launch_bounds__(kDThreads, 1)
flash_decode_kernel(const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tks,
                    const __grid_constant__ CUtensorMap tvs,
                    const FlashParams p) {
  using R = DecodeRing<kVar>;
  constexpr int S = R::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * R::kStage);
  uint64_t* empty = full + S;
  const B1Cta c = b1_cta<kPast, kDRows>(p);
  const int n = c.kb1 - c.kb0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kDWarps);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kDWarps) {  // the producer
    if (lane == 0) {
      for (int t = 0; t < n; ++t) {
        const int st = t % S;
        if (t >= S) mbar_wait(&empty[st], (t / S - 1) & 1);
        mbar_expect_tx(&full[st], R::kTx);
        const int key0 = (c.kb0 + t) * kBN;
        unsigned char* slot = smem + st * R::kStage;
        load_rows<kVar != kBf16>(slot, &tk, key0, c.hk, &full[st]);
        load_rows<kVar == kInt8>(slot + R::kKBytes, &tv, key0, c.hk, &full[st]);
        if constexpr (kVar != kBf16) {
          unsigned char* sc = slot + R::kKBytes + R::kVBytes;
          tma_load_2d(sc, &tks, key0, c.hk, &full[st]);
          if constexpr (kVar == kInt8) {
            tma_load_2d(sc + kBN * 4, &tvs, key0, c.hk, &full[st]);
          }
        }
      }
    }
    return;
  }

  const int g = lane >> 2, t4 = lane & 3;
  const int nrows = p.g * p.rep;
  // this thread's rows g and g + 8 of the CTA's 16: their last visible
  // slots (padding rows see everything and are never stored) and q scales
  int bound[2], head[2], pos[2];
  float qsc[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pr = c.row0 + g + 8 * i;
    const bool ok = pr < nrows;
    head[i] = c.hk * p.rep + (ok ? pr % p.rep : 0);
    pos[i] = ok ? pr / p.rep : 0;
    bound[i] = !ok ? INT_MAX : kPast ? p.length - 1 : p.length + pos[i];
    if constexpr (kVar != kBf16) {
      if (ok) qsc[i] = p.qs[head[i] * p.g + pos[i]];
    }
  }
  const int bound_lo = kPast ? p.length - 1 : p.length + c.row0 / p.rep;

  // Q fragments stay in registers for the whole key loop: 8 k-steps of 16
  // bf16 columns, or 4 of 32 int8 columns
  constexpr int kQSteps = kVar == kBf16 ? kD / 16 : kD / 32;
  constexpr int kQBytes = kVar == kBf16 ? 2 : 1;
  uint32_t qf[kQSteps][4];
  {
    const unsigned char* qrow[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qrow[i] = c.row0 + g + 8 * i < nrows
                    ? static_cast<const unsigned char*>(p.q) +
                          (head[i] * p.q_sh + (long long)pos[i] * p.q_st) *
                              kQBytes
                    : nullptr;
    }
#pragma unroll
    for (int kk = 0; kk < kQSteps; ++kk) {
      const int b = kk * 32 + 4 * t4;  // byte of the step's first column
      qf[kk][0] = qrow[0] ? qv::ld32(qrow[0] + b) : 0u;
      qf[kk][1] = qrow[1] ? qv::ld32(qrow[1] + b) : 0u;
      qf[kk][2] = qrow[0] ? qv::ld32(qrow[0] + b + 16) : 0u;
      qf[kk][3] = qrow[1] ? qv::ld32(qrow[1] + b + 16) : 0u;
    }
  }

  float o[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const int kw = 16 * warp;  // this warp's keys within each tile
  // ldmatrix rows of this lane: K (matrices key block x chunk parity), V
  // (matrices chunk parity x key block)
  const int k_row = kw + (lane >> 4) * 8 + (lane & 7), k_par = (lane >> 3) & 1;
  const int v_row = kw + ((lane >> 3) & 1) * 8 + (lane & 7), v_par = lane >> 4;

  for (int t = 0; t < n; ++t) {
    const int st = t % S;
    mbar_wait(&full[st], (t / S) & 1);
    const unsigned char* kt = smem + st * R::kStage;
    const unsigned char* vt = kt + R::kKBytes;
    const float* ksc = reinterpret_cast<const float*>(vt + R::kVBytes);
    const int key0 = (c.kb0 + t) * kBN + kw;

    // S = Q K^T over this warp's 16 keys: n8 tiles j = 0, 1
    float s[2][4];
    if constexpr (kVar == kBf16) {
#pragma unroll
      for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kQSteps; ++kk) {
        uint32_t b[4];
        qv::ldsm_x4(b, kt + sw128(k_row, 2 * kk + k_par));
        qv::mma_bf16_16816(s[0], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
                           b[0], b[1]);
        qv::mma_bf16_16816(s[1], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
                           b[2], b[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= p.scale_log2;
      }
    } else {
      int si[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kQSteps; ++kk) {
        uint32_t b[4];
        qv::ldsm_x4(b, kt + sw128(k_row, 2 * kk + k_par));
        qv::mma_s8_16832(si[0], qf[kk], b[0], b[1]);
        qv::mma_s8_16832(si[1], qf[kk], b[2], b[3]);
      }
      // log2 units as (acc * qs[row]) * ks[col], the JAX kernel's order
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 ks2 =
            *reinterpret_cast<const float2*>(ksc + kw + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = (static_cast<float>(si[j][e]) * qsc[e >> 1]) *
                    ((e & 1) ? ks2.y : ks2.x);
        }
      }
    }
    if (key0 + 15 > bound_lo) {  // some row's bound falls in these keys
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (key0 + 8 * j + 2 * t4 + (e & 1) > bound[e >> 1]) s[j][e] = -INFINITY;
        }
      }
    }

    // online softmax over the 16 keys: s becomes p = 2^(s - m) in f32
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mx = qv::warp_max4(fmaxf(fmaxf(s[0][2 * i], s[0][2 * i + 1]),
                                           fmaxf(s[1][2 * i], s[1][2 * i + 1])));
      const float m_new = fmaxf(m_run[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // all masked
      alpha[i] = exp2f(m_run[i] - m_use);
      m_run[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j][2 * i] = exp2f(s[j][2 * i] - m_use);
        s[j][2 * i + 1] = exp2f(s[j][2 * i + 1] - m_use);
        rs += s[j][2 * i] + s[j][2 * i + 1];
      }
      l_run[i] = l_run[i] * alpha[i] + rs;
    }
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
    if constexpr (kVar == kInt8) {  // pv = p * vs, before the bf16 packing
      const float* vsc = ksc + kBN;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 vs2 =
            *reinterpret_cast<const float2*>(vsc + kw + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= (e & 1) ? vs2.y : vs2.x;
      }
    }

    // O += P V: the score accumulators of n8 tiles 0, 1 are the A fragment
    const uint32_t a0 = qv::pack_bf16(s[0][0], s[0][1]);
    const uint32_t a1 = qv::pack_bf16(s[0][2], s[0][3]);
    const uint32_t a2 = qv::pack_bf16(s[1][0], s[1][1]);
    const uint32_t a3 = qv::pack_bf16(s[1][2], s[1][3]);
    if constexpr (kVar != kInt8) {
      // bf16 V: chunk pair (2cc, 2cc + 1) feeds n8 tiles 2cc, 2cc + 1
#pragma unroll
      for (int cc = 0; cc < kD / 16; ++cc) {
        uint32_t b[4];
        qv::ldsm_x4_t(b, vt + sw128(v_row, 2 * cc + v_par));
        qv::mma_bf16_16816(o[2 * cc], a0, a1, a2, a3, b[0], b[1]);
        qv::mma_bf16_16816(o[2 * cc + 1], a0, a1, a2, a3, b[2], b[3]);
      }
    } else {
      // int8 V: a 16-byte chunk c holds 16 columns; read as b16, lane value
      // b (keys 2 t4, 2 t4 + 1 x columns 2 g, 2 g + 1) gives the even column
      // 2 g to n8 tile 2c and the odd one to tile 2c + 1
#pragma unroll
      for (int cc = 0; cc < kD / 32; ++cc) {
        uint32_t b[4];
        qv::ldsm_x4_t(b, vt + sw128(v_row, 2 * cc + v_par));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            qv::mma_bf16_16816(o[4 * cc + 2 * h + e], a0, a1, a2, a3,
                               s8pair_bf16(b[2 * h], e),
                               s8pair_bf16(b[2 * h + 1], e));
          }
        }
      }
    }
    // the slot's generic-proxy reads (ldmatrix, the scales) ordered before
    // the async-proxy TMA that refills it: without this fence the refill
    // overtook a slow warp's V reads (measured on an H100)
    qv::fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // Combine the four warps' states through shared memory (the ring is free
  // once every consumer warp is past its loop): per row the common max M,
  // each warp's O scaled by 2^(m_w - M) into its own buffer, summed in warp
  // order (a fixed order: the same inputs give the same bits).
  constexpr int kCThreads = 32 * kDWarps;
  bar_sync(1, kCThreads);
  float* ow = reinterpret_cast<float*>(smem);     // [warp][row][kD]
  float* ml = ow + kDWarps * kDRows * kD;         // [warp][row] (m, l)
  float l_tot[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_tot[i] = qv::warp_sum4(l_run[i]);
    if (t4 == 0) {
      ml[2 * (warp * kDRows + g + 8 * i)] = m_run[i];
      ml[2 * (warp * kDRows + g + 8 * i) + 1] = l_tot[i];
    }
  }
  bar_sync(1, kCThreads);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDWarps; ++w) mx = fmaxf(mx, ml[2 * (w * kDRows + r)]);
    const float f = mx == -INFINITY ? 0.f : exp2f(m_run[i] - mx);
    float* orow = ow + (warp * kDRows + r) * kD;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // int8 V interleaves the columns of n8 tiles 2c and 2c + 1
        const int col = kVar == kInt8
                            ? 16 * (dt >> 1) + 4 * t4 + 2 * e + (dt & 1)
                            : 8 * dt + 2 * t4 + e;
        orow[col] = o[dt][2 * i + e] * f;
      }
    }
  }
  bar_sync(1, kCThreads);

  const int d = threadIdx.x;  // one output column per thread
  const bool split = p.n_split > 1;
  for (int r = 0; r < kDRows; ++r) {
    const int pr = c.row0 + r;
    if (pr >= nrows) break;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDWarps; ++w) mx = fmaxf(mx, ml[2 * (w * kDRows + r)]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kDWarps; ++w) {
      const float mw = ml[2 * (w * kDRows + r)];
      l += mx == -INFINITY ? 0.f : ml[2 * (w * kDRows + r) + 1] * exp2f(mw - mx);
      acc += ow[(w * kDRows + r) * kD + d];
    }
    const int hd = c.hk * p.rep + pr % p.rep, ps = pr / p.rep;
    if (!split) {
      const float inv = l > 0.f ? 1.f / l : 0.f;
      store_one(static_cast<OutT*>(p.o) + hd * p.o_sh + (long long)ps * p.o_st + d,
                acc * inv);
      if constexpr (kLse) {
        if (d == 0) p.lse[hd * p.lse_sh + (long long)ps * p.lse_st] = lse_of(mx, l);
      }
    } else {
      const long long prow = ((long long)blockIdx.z * p.hq + hd) * p.g + ps;
      p.part_o[prow * kD + d] = acc;
      if (d == 0) p.part_ml[prow] = make_float2(mx, l);
    }
  }
}

// -- the prefill kernel --------------------------------------------------------
//
// One CTA: one kv head, kPRows packed rows (kPWG consumer warpgroups of 64
// rows each) and one producer warpgroup. The producer's first thread keeps
// the K/V ring full with TMA (a 3D tensor map over the layer view: head dim,
// slot, kv head; 64-slot boxes of 128-byte rows under the 128-byte swizzle,
// two per bf16 row, one per int8 row; zeros past the map's slot count; the
// tile's f32 scales by a 2D map on the same barrier); the consumers stage
// their Q rows once by cp.async into the same swizzled layout, then per key
// tile issue S = Q K^T (bf16: wgmma m64n64k16 x 8; int8-QK: s8 m64n64k32 x
// 4 with exact s32 sums; both operands K-major from shared memory) and O +=
// P V (m64n128k16 x 4, P from registers, V read MN-major through the
// transpose bit), the previous tile's P V running while they do this tile's
// softmax. With int8 V, the producer warpgroup's other three warps convert
// each landed tile of codes into a bf16 slot of the same swizzled layout
// (exact) and signal it on a third barrier. setmaxnreg moves the producer's
// registers to the consumers.
constexpr int kPWG = 3;                      // consumer warpgroups
constexpr int kPRows = 64 * kPWG;            // packed rows per CTA
constexpr int kPStages = 4;                  // K/V ring slots
constexpr int kPThreads = 128 * (kPWG + 1);  // + the producer warpgroup

template <int kVar>
struct PrefillSmem {
  static constexpr int kKBytes = kVar == kBf16 ? kTile : kBox;  // K slot
  static constexpr int kRawBytes = kVar == kInt8 ? kBox : 0;    // V codes
  static constexpr int kScaleBytes = kVar == kBf16 ? 0 : 2 * kBN * 4;
  static constexpr int kTx = kKBytes + (kVar == kInt8 ? kBox : kTile) +
                             (kVar == kBf16 ? 0 : kVar == kInt8 ? 2 : 1) * kBN * 4;
  // Q tiles (also the output's staging), K, V (bf16), V codes, scales,
  // full / empty / converted barriers, alignment slack
  static constexpr int kBytes =
      kPWG * kTile + kPStages * (kKBytes + kTile + kRawBytes + kScaleBytes) +
      3 * kPStages * 8 + 1024;
  // 128 * (3 * consumers + producer) <= 65,536; int8 V's converters keep
  // more registers
  static constexpr int kConsumerRegs = kVar == kInt8 ? 152 : 160;
  static constexpr int kProducerRegs = kVar == kInt8 ? 40 : 24;
};

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

// D (64 x 64, s32) = A (64 x 32, s8) B (32 x 64, s8) + (scale_d ? D : 0); A
// and B K-major in shared memory; exact
__device__ __forceinline__ void wgmma_m64n64k32_s8(
    uint32_t (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void reg_fence_u(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// the 128 threads of consumer warpgroup wg (named barriers 1..kPWG)
__device__ __forceinline__ void wg_sync(int wg) { bar_sync(wg + 1, 128); }

// The warpgroup's 64 output rows through its Q tile (free once its products
// are done): registers -> swizzled shared memory -> 16-byte row chunks into
// the output (unsplit: o through its strides, scaled by 1 / l) or the f32
// partials (split-K: unscaled). An f32 row takes two passes of 64 columns.
// Padding rows are not written.
template <typename T>
__device__ __forceinline__ void store_out(const FlashParams& p,
                                          const B1Cta& c, int wg,
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

template <int kVar, bool kPast, bool kLse, typename OutT>
__global__ void __launch_bounds__(kPThreads, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tks,
                     const __grid_constant__ CUtensorMap tvs,
                     const FlashParams p) {
  using L = PrefillSmem<kVar>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;                          // [kPWG] Q tiles
  unsigned char* ks = qs + kPWG * kTile;             // [kPStages] K tiles
  unsigned char* vs = ks + kPStages * L::kKBytes;    // [kPStages] bf16 V
  unsigned char* vraw = vs + kPStages * kTile;       // [kPStages] V codes
  unsigned char* scs = vraw + kPStages * L::kRawBytes;  // [kPStages] scales
  uint64_t* full = reinterpret_cast<uint64_t*>(scs + kPStages * L::kScaleBytes);
  uint64_t* empty = full + kPStages;
  uint64_t* vready = empty + kPStages;  // int8 V: the bf16 slot is written
  const int wg = threadIdx.x >> 7;
  const B1Cta c = b1_cta<kPast, kPRows>(p);
  const int n = c.kb1 - c.kb0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kPStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kPWG);  // lane 0 of every consumer warp
      if constexpr (kVar == kInt8) mbar_init(&vready[s], 3);  // converters
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kPWG) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::kProducerRegs));
    const int pw = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    if (pw == 0 && lane == 0) {
      for (int t = 0; t < n; ++t) {
        const int st = t % kPStages;
        // the slot's previous tile released by every consumer warp
        if (t >= kPStages) mbar_wait(&empty[st], (t / kPStages - 1) & 1);
        mbar_expect_tx(&full[st], L::kTx);
        const int key0 = (c.kb0 + t) * kBN;
        load_rows<kVar != kBf16>(ks + st * L::kKBytes, &tk, key0, c.hk,
                                 &full[st]);
        if constexpr (kVar == kInt8) {
          load_rows<true>(vraw + st * kBox, &tv, key0, c.hk, &full[st]);
        } else {
          load_rows<false>(vs + st * kTile, &tv, key0, c.hk, &full[st]);
        }
        if constexpr (kVar != kBf16) {
          unsigned char* sc = scs + st * L::kScaleBytes;
          tma_load_2d(sc, &tks, key0, c.hk, &full[st]);
          if constexpr (kVar == kInt8) {
            tma_load_2d(sc + kBN * 4, &tvs, key0, c.hk, &full[st]);
          }
        }
      }
    }
    if constexpr (kVar == kInt8) {
      if (pw == 0) return;
      // warps 1-3: each landed tile of V codes (64 rows x 8 chunks of 16)
      // into the bf16 slot, 16 codes -> two 16-byte chunks, exactly
      const int ct = threadIdx.x - kPWG * 128 - 32;  // 0..95
      for (int t = 0; t < n; ++t) {
        const int st = t % kPStages;
        mbar_wait(&full[st], (t / kPStages) & 1);
        const unsigned char* raw = vraw + st * kBox;
        unsigned char* dst = vs + st * kTile;
        for (int i = ct; i < 64 * 8; i += 96) {
          const int r = i >> 3, ch = i & 7;
          const uint4 x = *reinterpret_cast<const uint4*>(raw + sw128(r, ch));
          const uint32_t w[4] = {x.x, x.y, x.z, x.w};
          uint32_t b[8];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t xb = w[j] ^ 0x80808080u;
            b[2 * j] = qv::pack_bf16(s8_byte(xb, 0), s8_byte(xb, 1));
            b[2 * j + 1] = qv::pack_bf16(s8_byte(xb, 2), s8_byte(xb, 3));
          }
          *reinterpret_cast<uint4*>(dst + sw128(r, 2 * ch)) =
              make_uint4(b[0], b[1], b[2], b[3]);
          *reinterpret_cast<uint4*>(dst + sw128(r, 2 * ch + 1)) =
              make_uint4(b[4], b[5], b[6], b[7]);
        }
        qv::fence_proxy_async();  // visible to the consumers' wgmma
        __syncwarp();
        if (lane == 0) mbar_arrive(&vready[st]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::kConsumerRegs));
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nrows = p.g * p.rep;
  const int wrow0 = c.row0 + 64 * wg;
  unsigned char* qw = qs + wg * kTile;

  // this warpgroup's Q rows, once (packed rows are not one TMA box);
  // padding rows are zeros. bf16: 16 chunks per row over two boxes; int8
  // codes: 8 chunks, one box
  constexpr int kQChunks = kVar == kBf16 ? 16 : 8;
  for (int i = tid; i < 64 * kQChunks; i += 128) {
    const int r = i / kQChunks, ch = i % kQChunks;
    const bool ok = wrow0 + r < nrows;
    const int pr = ok ? wrow0 + r : 0;
    const unsigned char* src =
        static_cast<const unsigned char*>(p.q) +
        ((c.hk * p.rep + pr % p.rep) * p.q_sh + (long long)(pr / p.rep) * p.q_st) *
            (kVar == kBf16 ? 2 : 1) +
        ch * 16;
    qv::cp_async16(qw + sw128(r, ch), src, ok);
  }
  qv::cp_async_commit();
  qv::cp_async_wait<0>();
  qv::fence_proxy_async();
  wg_sync(wg);

  // this thread's rows' last visible slots; padding rows see everything
  // (they are never stored), so only real rows' bounds decide the mask
  int bound[2];
  float qsc[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pr = wrow0 + 16 * warp + g + 8 * i;
    bound[i] = pr >= nrows ? INT_MAX
               : kPast     ? p.length - 1
                           : p.length + pr / p.rep;
    if constexpr (kVar != kBf16) {
      if (pr < nrows) qsc[i] = p.qs[(c.hk * p.rep + pr % p.rep) * p.g + pr / p.rep];
    }
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
  uint32_t si[32];           // int8-QK: the s32 scores
  uint32_t pa[kBN / 16][4];  // P of the previous tile: the A operand of P V
  const uint64_t qdesc = sw128_desc(qw, 16);

  // S = Q K_t^T. bf16: 8 k-steps of 16 columns, 32 bytes apart within a
  // box; int8: 4 k-steps of 32 codes, 32 bytes apart in the one box
  auto issue_s = [&](int t) {
    const int st = t % kPStages;
    mbar_wait(&full[st], (t / kPStages) & 1);
    const uint64_t kdesc = sw128_desc(ks + st * L::kKBytes, 16);
    if constexpr (kVar == kBf16) {
      qv::reg_fence(s);
      qv::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint64_t off = (kk >> 2) * (kBox >> 4) + (kk & 3) * 2;
        qv::wgmma_m64n64k16_ss(s, qdesc + off, kdesc + off, kk > 0);
      }
    } else {
      reg_fence_u(si);
      qv::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 32; ++kk) {
        wgmma_m64n64k32_s8(si, qdesc + kk * 2, kdesc + kk * 2, kk > 0);
      }
    }
    qv::wgmma_commit();
  };
  // after S_t's wait: int8-QK scores into log2 units as (acc * qs[row]) *
  // ks[col], the JAX kernel's order
  auto scale_s = [&](int t) {
    if constexpr (kVar != kBf16) {
      reg_fence_u(si);
      const float* ksc =
          reinterpret_cast<const float*>(scs + (t % kPStages) * L::kScaleBytes);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 k2 = *reinterpret_cast<const float2*>(ksc + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * j + e] =
              (static_cast<float>(static_cast<int>(si[4 * j + e])) *
               qsc[e >> 1]) * ((e & 1) ? k2.y : k2.x);
        }
      }
    } else {
      qv::reg_fence(s);
    }
  };
  // O += P V_t: keys [16kk, 16kk + 16) are rows 16kk.. of both V boxes
  auto issue_pv = [&](int t) {
    const int st = t % kPStages;
    if constexpr (kVar == kInt8) mbar_wait(&vready[st], (t / kPStages) & 1);
    const uint64_t vdesc = sw128_desc(vs + st * kTile, kBox);
    qv::reg_fence(o);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      wgmma_m64n128k16_rs(o, pa[kk], vdesc + kk * (16 * 128 >> 4));
    }
    qv::wgmma_commit();
  };
  // softmax of S_t in place (s becomes P_t, unrounded), in log2 units
  // (bf16: scale_log2 > 0 commutes with the max and goes into one FFMA per
  // score); alpha rescales the running sums. Only tiles that cross some
  // real row's bound are masked.
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
    const float sc = kVar == kBf16 ? p.scale_log2 : 1.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_run[i], qv::warp_max4(mx[i]) * sc);
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;  // fully masked so far
      alpha[i] = qv::ex2(m_run[i] - m_use[i]);
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float pe = kVar == kBf16
                           ? qv::ex2(fmaf(s[i], sc, -m_use[(i >> 1) & 1]))
                           : qv::ex2(s[i] - m_use[(i >> 1) & 1]);
      s[i] = pe;
      l_run[(i >> 1) & 1] += pe;
    }
  };
  // P_t into bf16 A fragments; int8 V: p * vs[col] first (pv = p * vs)
  auto pack_p = [&](int t) {
    if constexpr (kVar == kInt8) {
      const float* vsc = reinterpret_cast<const float*>(
                             scs + (t % kPStages) * L::kScaleBytes) + kBN;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 v2 = *reinterpret_cast<const float2*>(vsc + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[4 * j + e] *= (e & 1) ? v2.y : v2.x;
      }
    }
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
    scale_s(0);
    softmax(0);
    pack_p(0);
    for (int t = 1; t < n; ++t) {
      issue_s(t);
      issue_pv(t - 1);
      qv::wgmma_wait<1>();  // S_t done; P_{t-1} V_{t-1} may still run
      scale_s(t);
      softmax(t);
      qv::wgmma_wait<0>();  // P_{t-1} V_{t-1} is in O; pa and the slot free
      qv::reg_fence(o);
      // int8-QK: the slot's scales were read by generic loads; ordered
      // before the TMA that refills it
      if constexpr (kVar != kBf16) qv::fence_proxy_async();
      if (lane == 0) mbar_arrive(&empty[(t - 1) % kPStages]);
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_p(t);
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
template <typename K>
cudaError_t smem_once(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int kVar, bool kPast, bool kLse, typename OutT>
cudaError_t prefill_smem_once() {
  static cudaError_t err = smem_once(flash_prefill_kernel<kVar, kPast, kLse, OutT>,
                                     PrefillSmem<kVar>::kBytes);
  return err;
}

template <int kVar, bool kPast, bool kLse, typename OutT>
cudaError_t decode_smem_once() {
  static cudaError_t err = smem_once(flash_decode_kernel<kVar, kPast, kLse, OutT>,
                                     DecodeRing<kVar>::kSmem);
  return err;
}

using qv::EncodeTiled;
using qv::encode_tiled;

// The tensor map of one layer view (hkv, cap, kD) of bf16 (bytes = 2) or
// int8 (bytes = 1) rows with strides st (slot) and sh (head), in elements:
// dims (kD, slots, hkv), boxes of 128 bytes x kBN slots x 1 head, 128-byte
// swizzle. Slots at or past `slots` (the call's reach) read as zeros, so
// nothing past the valid prefix and the group is loaded.
cudaError_t layer_map(CUtensorMap* map, const void* base, int bytes,
                      long long st, long long sh, int slots, int hkv) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[3] = {kD, (cuuint64_t)std::max(slots, 1), (cuuint64_t)hkv};
  const cuuint64_t strides[2] = {(cuuint64_t)st * bytes, (cuuint64_t)sh * bytes};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / bytes), kBN, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      3, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of a layer's (hkv, cap) f32 scales with head stride sh
// (elements): dims (slots, hkv), boxes of kBN slots; zeros past `slots`
cudaError_t scale_map(CUtensorMap* map, const void* base, long long sh,
                      int slots, int hkv) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)std::max(slots, 1), (cuuint64_t)hkv};
  const cuuint64_t strides[1] = {(cuuint64_t)sh * 4};
  const cuuint32_t box[2] = {kBN, 1};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The four maps of one call: K, V and (int8-QK) their scales. A map that
// the variant does not read is a copy of K's (a valid kernel argument).
struct LayerMaps {
  CUtensorMap k, v, ks, vs;
};

cudaError_t layer_maps(LayerMaps* m, int var, const void* k, const void* ksc,
                       const void* v, const void* vsc, long long k_sh,
                       long long k_st, long long v_sh, long long v_st,
                       long long ks_sh, long long vs_sh, int slots, int hkv) {
  cudaError_t err =
      layer_map(&m->k, k, var == kBf16 ? 2 : 1, k_st, k_sh, slots, hkv);
  if (err == cudaSuccess) {
    err = layer_map(&m->v, v, var == kInt8 ? 1 : 2, v_st, v_sh, slots, hkv);
  }
  m->ks = m->vs = m->k;
  if (err == cudaSuccess && var != kBf16) {
    err = scale_map(&m->ks, ksc, ks_sh, slots, hkv);
  }
  if (err == cudaSuccess && var == kInt8) {
    err = scale_map(&m->vs, vsc, vs_sh, slots, hkv);
  }
  return err;
}

// Calls f(std::integral_constant<int, kVar>) for the call's variant
template <typename F>
cudaError_t with_variant(int var, F&& f) {
  switch (var) {
    case kBf16: return f(std::integral_constant<int, kBf16>{});
    case kInt8: return f(std::integral_constant<int, kInt8>{});
    default: return f(std::integral_constant<int, kInt8k>{});
  }
}

}  // namespace

// The arguments the entry points share, in this order: q (bf16, or int8
// codes), qs ((hq, g) f32 contiguous, int8-QK only, absorbed scale * log2
// e), k, ksc (k's (hkv, cap) f32 scales, int8 K only), v, vsc (int8 V
// only); o, lse, part_o, part_ml; strides in elements (q_sh, q_st, k_sh,
// k_st, v_sh, v_st, o_sh, o_st, lse_sh, lse_st, ks_sh, vs_sh); hq, hkv, g,
// length, cap, n_split; past (pure-past mode), with_lse, out_f32 (f32
// output, else bf16); scale (bf16 only). The variant follows from the
// pointers: qs null is the bf16 cache, vsc null with qs int8k, else int8.
// q rows, K/V rows and scale rows 16-byte aligned (TMA, cp.async).
#define QV_FLASH_PARAMS                                                      \
  const void *q, const void *qs, const void *k, const void *ksc,             \
      const void *v, const void *vsc, void *o, void *lse, void *part_o,      \
      void *part_ml, long long q_sh, long long q_st, long long k_sh,         \
      long long k_st, long long v_sh, long long v_st, long long o_sh,        \
      long long o_st, long long lse_sh, long long lse_st, long long ks_sh,   \
      long long vs_sh, int hq, int hkv, int g, int length, int cap,          \
      int n_split, int past, int with_lse, int out_f32, float scale

namespace {

int variant_of(const void* qs, const void* vsc) {
  return qs == nullptr ? kBf16 : vsc == nullptr ? kInt8k : kInt8;
}

FlashParams params_of(const void* q, const void* qs, void* o, void* lse,
                      void* part_o, void* part_ml, long long q_sh,
                      long long q_st, long long o_sh, long long o_st,
                      long long lse_sh, long long lse_st, int hq, int hkv,
                      int g, int length, int cap, int n_split, float scale) {
  FlashParams p = {};
  p.q = q;
  p.qs = static_cast<const float*>(qs);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.part_o = static_cast<float*>(part_o);
  p.part_ml = static_cast<float2*>(part_ml);
  p.q_sh = q_sh; p.q_st = q_st; p.o_sh = o_sh; p.o_st = o_st;
  p.lse_sh = lse_sh; p.lse_st = lse_st;
  p.hq = hq; p.rep = hq / hkv; p.g = g;
  p.length = length; p.cap = cap; p.n_split = n_split;
  p.scale_log2 = scale * 1.4426950408889634f;
  return p;
}

}  // namespace

#define QV_FLASH_SETUP                                                        \
  FlashParams p = params_of(q, qs, o, lse, part_o, part_ml, q_sh, q_st, o_sh, \
                            o_st, lse_sh, lse_st, hq, hkv, g, length, cap,    \
                            n_split, scale);                                  \
  const int var = variant_of(qs, vsc);                                        \
  LayerMaps maps;                                                             \
  cudaError_t err = layer_maps(&maps, var, k, ksc, v, vsc, k_sh, k_st, v_sh,  \
                               v_st, ks_sh, vs_sh,                            \
                               std::min(past ? length : length + g, cap),     \
                               hkv);                                          \
  if (err != cudaSuccess) return (int)err;                                    \
  cudaStream_t st = static_cast<cudaStream_t>(stream)

// Prefill shapes (G * rep >= the prefill kernel's 192 rows; the wrapper's
// _plan picks): row blocks of kPRows on grid (hkv, blocks, n_split); the
// split-K partials merged by flash_merge_kernel.
extern "C" int qv_flash_prefill(QV_FLASH_PARAMS, void* stream) {
  QV_FLASH_SETUP;
  dim3 grid(hkv, (g * p.rep + kPRows - 1) / kPRows, n_split);
  return (int)with_variant(var, [&](auto kv) {
    return with_mode(past, with_lse, out_f32, [&](auto kp, auto kl, auto ot) {
      using OutT = typename decltype(ot)::type;
      constexpr int kV = decltype(kv)::value;
      constexpr bool kP = decltype(kp)::value, kL = decltype(kl)::value;
      const cudaError_t e = prefill_smem_once<kV, kP, kL, OutT>();
      if (e != cudaSuccess) return e;
      flash_prefill_kernel<kV, kP, kL, OutT>
          <<<grid, kPThreads, PrefillSmem<kV>::kBytes, st>>>(
              maps.k, maps.v, maps.ks, maps.vs, p);
      return merge_if_split<kL, OutT>(p, st);
    });
  });
}

// The other shapes: row blocks of kDRows on grid (hkv, blocks, n_split);
// the split-K partials merged by flash_merge_kernel.
extern "C" int qv_flash_decode(QV_FLASH_PARAMS, void* stream) {
  QV_FLASH_SETUP;
  dim3 grid(hkv, (g * p.rep + kDRows - 1) / kDRows, n_split);
  return (int)with_variant(var, [&](auto kv) {
    return with_mode(past, with_lse, out_f32, [&](auto kp, auto kl, auto ot) {
      using OutT = typename decltype(ot)::type;
      constexpr int kV = decltype(kv)::value;
      constexpr bool kP = decltype(kp)::value, kL = decltype(kl)::value;
      const cudaError_t e = decode_smem_once<kV, kP, kL, OutT>();
      if (e != cudaSuccess) return e;
      flash_decode_kernel<kV, kP, kL, OutT>
          <<<grid, kDThreads, DecodeRing<kV>::kSmem, st>>>(
              maps.k, maps.v, maps.ks, maps.vs, p);
      return merge_if_split<kL, OutT>(p, st);
    });
  });
}

// Registers, local (spill) bytes, static and dynamic shared memory of B1's
// kernels, by index: 8 * family + mode, family 0-2 the decode kernel (bf16,
// int8, int8k), 3-5 the prefill kernel (bf16, int8, int8k), 6 the split-K
// merge (modes 0-3); mode bits 4 pure past, 2 lse, 1 f32 output. Returns a
// CUDA error.
extern "C" int qv_flash_kernel_info(int which, int* regs, int* local_bytes,
                                    int* static_smem, int* dynamic_smem) {
  if (which < 0 || which >= 52) return (int)cudaErrorInvalidValue;
  const int family = which / 8, m = which % 8;
  cudaFuncAttributes a;
  int dyn = 0;
  const cudaError_t err = with_variant(family % 3, [&](auto kv) {
    return with_mode(m & 4, m & 2, m & 1, [&](auto kp, auto kl, auto ot) {
      using OutT = typename decltype(ot)::type;
      constexpr int kV = decltype(kv)::value;
      constexpr bool kP = decltype(kp)::value, kL = decltype(kl)::value;
      if (family < 3) {
        dyn = DecodeRing<kV>::kSmem;
        return cudaFuncGetAttributes(&a, flash_decode_kernel<kV, kP, kL, OutT>);
      }
      if (family < 6) {
        dyn = PrefillSmem<kV>::kBytes;
        return cudaFuncGetAttributes(&a, flash_prefill_kernel<kV, kP, kL, OutT>);
      }
      return cudaFuncGetAttributes(&a, flash_merge_kernel<kL, OutT>);
    });
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
