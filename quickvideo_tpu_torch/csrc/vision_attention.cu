// Kernels B2 and B5: block-diagonal vision attention, and the vision rotary
// pass, for Hopper (sm_90a).
//
// What they replace.
//  * B2 replaces quickvideo_tpu/ops/vision_attention.py::_kernel2d (entry
//    block_diag_attention_2d): rotary on q and k, then softmax(q k^T * scale) v
//    restricted to contiguous spans of `span` rows (64/48/36-row windows of
//    the window blocks, whole frames of the full-attention blocks).
//  * B5 replaces quickvideo_tpu/ops/vision_attention.py::_kernel (entry
//    block_diag_attention): the same attention on rows rotated outside (the
//    head-major route), optionally with a validity byte per key: an invalid
//    key is masked out, and a row whose span holds no valid key is 0.
//  * The rotary pass (`vision_rotary_kernel`) is the rotary of _kernel2d
//    (vision_attention.py:165-168) and of the head-major route
//    (quickvideo_tpu/models/qwen25_vl/vision.py:231-241) as one elementwise
//    pass over q and k.
// The TPU kernels' spans-per-tile packing, 1536-row span cap and 128-lane
// heads were VMEM and lane artifacts: here any span >= 1 that divides S is
// taken. q/k/v are (S, nh, 80) with any 16-byte row stride (the three slices
// of the fused qkv projection, read in place); out is (S, nh, 80).
//
// Rotary rounding. The JAX package casts cos/sin to the activation dtype and
// rotates in that dtype; XLA rounds after every operation (measured on the
// CPU: bf16(bf16(x*c) + bf16(rotate_half(x)*s)) is bit-equal to it, a single
// f32 rounding is not). The kernels do the same: bf16 tables, each product
// (exact in f32) rounded to bf16, their sum rounded to bf16. Every q and k row
// is rotated exactly once per call.
//
// Dispatch (ops/vision_attention.py picks by span, nothing else):
//  * span <= 64: `short_span_kernel`. These shapes (the 28 window blocks of
//    every group, the image's buckets) read q, k, v once and write out once
//    with little arithmetic per byte: bound by bytes. A CTA takes one tile of
//    whole spans (floor(64 / span) spans, at most 64 rows; rows padded to the
//    16-row mma granularity), so every row does exactly its own span's keys
//    and a tile never needs a second key tile (a 64-row block over 36- or
//    48-row spans would straddle two). The CTA walks 2 heads of its row tile,
//    staging the next head's q/k/v with 16-byte cp.async into a second
//    buffer while this head computes (2 heads, not 4: twice the CTAs, so the
//    last wave of the grid is fuller);
//    B2's cos/sin rows are staged once per tile and q/k are rotated in
//    shared memory right after they land.
//    Fragments come from ldmatrix (V by ldmatrix.trans: no transpose pass);
//    QK^T and PV are mma.sync m16n8k16 (the tensor cores are not the limit
//    here). The span fits one key tile, so softmax is exact in one pass: p is
//    normalised before it is rounded to bf16, as the JAX kernel's _softmax_pv.
//    The output goes back through shared memory as 16-byte rows.
//  * span > 64: `long_span_kernel` (900-row frames, the image's 1564-row
//    frame, 2304-row spans). Bound by operations (4 * 80 per (row, key)
//    pair on the tensor cores), and in practice by what keeps the tensor
//    cores waiting: the softmax between the two products and the copies.
//    Four warpgroups per CTA (one CTA per SM: 16 warps at 128 registers),
//    each on 64 query rows of ONE span (a tile never pays for two frames'
//    keys), share each K/V tile, which quarters the copies per product.
//    Each issues wgmma: S = Q K^T as m64n64k16 x 5
//    k-steps from shared memory (K-major), then O += P V as m64n80k16 x 4
//    with P from registers (the S accumulator, rounded to bf16) and V read
//    MN-major with the transpose bit (no transpose pass). The product of
//    tile j - 1's P V runs on the tensor cores while the warpgroup does tile
//    j's softmax (one FFMA and one ex2 per score). K/V tiles of 64 keys come
//    through a ring of 4 slots, copied two tiles ahead by cp.async into the
//    canonical no-swizzle core-matrix layout that the wgmma descriptors
//    describe (TMA would need a 64- and a 16-column box per 80-wide row
//    under its 128-byte swizzle; cp.async into the canonical layout takes
//    the strided views as they are). Online softmax across key tiles. B2 on
//    these spans runs the rotary pass into a scratch buffer first, then
//    this kernel.
//  * The rotary pass: bound by bytes (q, k and the tables read once, the
//    rotated q and k written once); 16-byte loads, one thread per pair of
//    16-byte chunks that rotate_half pairs (column c with c +- 40).
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHD = 80;
constexpr int kChunks = kHD / 8;          // 16-byte chunks per head row
constexpr int kHalfChunks = kChunks / 2;  // rotate_half pairs chunk j, j + 5

// -- PTX helpers (common.cuh has the ldmatrix, cp.async and wgmma ones) ----

using namespace qv;

// D (64 x 80, f32) += A (64 x 16, registers) B (16 x 80, MN-major in shared
// memory: the transpose bit)
__device__ __forceinline__ void wgmma_m64n80k16_rs(
    float (&d)[40], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void st16(bf16* p, uint4 x) {
  *reinterpret_cast<uint4*>(p) = x;
}

// -- rotary ------------------------------------------------------------------

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x1 = columns [8j, 8j + 8) of a head row, x2 = [40 + 8j, 48 + 8j), rotated
// in place: x * cos + rotate_half(x) * sin, rotate_half(x) = [-x2, x1], at
// the JAX rounding points (each product rounded to bf16, then the sum)
__device__ __forceinline__ void rotate_chunks(uint4& x1, uint4& x2, uint4 c1,
                                              uint4 s1, uint4 c2, uint4 s2) {
  bf16* a = reinterpret_cast<bf16*>(&x1);
  bf16* b = reinterpret_cast<bf16*>(&x2);
  const bf16* ca = reinterpret_cast<const bf16*>(&c1);
  const bf16* sa = reinterpret_cast<const bf16*>(&s1);
  const bf16* cb = reinterpret_cast<const bf16*>(&c2);
  const bf16* sb = reinterpret_cast<const bf16*>(&s2);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float xa = __bfloat162float(a[i]);
    const float xb = __bfloat162float(b[i]);
    const float oa = round_bf16(xa * __bfloat162float(ca[i])) +
                     round_bf16(-xb * __bfloat162float(sa[i]));
    const float ob = round_bf16(xb * __bfloat162float(cb[i])) +
                     round_bf16(xa * __bfloat162float(sb[i]));
    a[i] = __float2bfloat16_rn(oa);
    b[i] = __float2bfloat16_rn(ob);
  }
}

struct RotaryParams {
  const bf16* q;
  const bf16* k;
  const bf16* cos;  // (S, 80), activation dtype
  const bf16* sin;
  bf16* qo;
  bf16* ko;
  long long q_ss, k_ss, cs_ss, qo_ss, ko_ss;  // row strides (elements)
  int s, nh;
};

constexpr int kRotThreads = 256;

__global__ void __launch_bounds__(kRotThreads)
vision_rotary_kernel(RotaryParams p) {
  const long long i = blockIdx.x * (long long)kRotThreads + threadIdx.x;
  if (i >= (long long)p.s * p.nh * kHalfChunks) return;
  const int j = static_cast<int>(i % kHalfChunks);
  const long long rh = i / kHalfChunks;
  const int h = static_cast<int>(rh % p.nh);
  const long long row = rh / p.nh;
  const int c1 = 8 * j, c2 = kHD / 2 + 8 * j;
  const bf16* cs = p.cos + row * p.cs_ss;
  const bf16* sn = p.sin + row * p.cs_ss;
  const uint4 cos1 = __ldg(reinterpret_cast<const uint4*>(cs + c1));
  const uint4 cos2 = __ldg(reinterpret_cast<const uint4*>(cs + c2));
  const uint4 sin1 = __ldg(reinterpret_cast<const uint4*>(sn + c1));
  const uint4 sin2 = __ldg(reinterpret_cast<const uint4*>(sn + c2));
  const bf16* q = p.q + row * p.q_ss + h * kHD;
  const bf16* k = p.k + row * p.k_ss + h * kHD;
  uint4 q1 = ld16(q + c1), q2 = ld16(q + c2);
  uint4 k1 = ld16(k + c1), k2 = ld16(k + c2);
  rotate_chunks(q1, q2, cos1, sin1, cos2, sin2);
  rotate_chunks(k1, k2, cos1, sin1, cos2, sin2);
  bf16* qo = p.qo + row * p.qo_ss + h * kHD;
  bf16* ko = p.ko + row * p.ko_ss + h * kHD;
  st16(qo + c1, q1);
  st16(qo + c2, q2);
  st16(ko + c1, k1);
  st16(ko + c2, k2);
}

// -- attention ---------------------------------------------------------------

struct SpanParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const bf16* cos;  // B2 short-span only: (S, 80) in the activation dtype
  const bf16* sin;
  const uint8_t* valid;  // kMasked only: (S,) 1 = valid key
  long long q_ss, k_ss, v_ss, o_ss, cs_ss;  // row strides (elements)
  int s, nh, span;
  float scale_log2;
};

// short spans: row-major tiles, 88-element rows (ldmatrix without bank
// conflicts: 176-byte rows put 8 consecutive rows on 8 disjoint bank quads)
constexpr int kSRows = 64;
constexpr int kSStride = kHD + 8;
constexpr int kSTile = kSRows * kSStride;
constexpr int kSThreads = 128;
constexpr int kHeadsPerCta = 2;

__host__ __device__ constexpr int short_smem_bytes(bool rotary) {
  return (6 + (rotary ? 2 : 0)) * kSTile * 2 + kSRows;
}

// cp.async rows [row0, row0 + 64) of one head (`src` points at its column
// 0) into a row-major tile; rows at or past row0 + rows are zero
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long ss, int row0, int rows) {
  for (int i = threadIdx.x; i < kSRows * kChunks; i += kSThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = r < rows;
    cp_async16(dst + r * kSStride + c * 8,
               src + (long long)(row0 + (ok ? r : 0)) * ss + c * 8, ok);
  }
}

// one warp: its 16 query rows [wr0, wr0 + 16) of a staged head against the
// keys of their spans; writes the bf16 output rows into `qs` (its own rows)
template <bool kMasked>
__device__ __forceinline__ void short_attend(bf16* qs, const bf16* ks,
                                             const bf16* vs,
                                             const uint8_t* kval, int wr0,
                                             int rows, int span,
                                             float scale_log2) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  uint32_t qf[kHD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kHD / 16; ++kk) {
    ldsm_x4(qf[kk], qs + (wr0 + (lane & 15)) * kSStride + kk * 16 +
                        (lane >> 4) * 8);
  }
  // keys of the warp's spans: [wlo, whi); of each accumulator row: [klo, khi)
  const int wlo = (wr0 / span) * span;
  const int whi = min((min(wr0 + 15, rows - 1) / span + 1) * span, rows);
  int klo[2], khi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr0 + g + 8 * i;
    klo[i] = (r / span) * span;
    khi[i] = min(klo[i] + span, rows);
  }

  float s[kSRows / 8][4];
#pragma unroll
  for (int nt = 0; nt < kSRows / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  }
#pragma unroll
  for (int np = 0; np < kSRows / 16; ++np) {
    if (np * 16 >= whi || np * 16 + 16 <= wlo) continue;
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk) {
      uint32_t b[4];
      ldsm_x4(b, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kSStride +
                     kk * 16 + ((lane >> 3) & 1) * 8);
      qv::mma_bf16_16816(s[2 * np], qf[kk][0], qf[kk][1], qf[kk][2],
                         qf[kk][3], b[0], b[1]);
      qv::mma_bf16_16816(s[2 * np + 1], qf[kk][0], qf[kk][1], qf[kk][2],
                         qf[kk][3], b[2], b[3]);
    }
  }

  // one-pass softmax over the row's span; p normalised before rounding
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < kSRows / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = nt * 8 + 2 * t4 + (e & 1);
      const int i = e >> 1;
      bool ok = key >= klo[i] && key < khi[i];
      if constexpr (kMasked) ok = ok && kval[key];
      const float x = ok ? s[nt][e] * scale_log2 : -INFINITY;
      s[nt][e] = x;
      mx[i] = fmaxf(mx[i], x);
    }
  }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = qv::warp_max4(mx[i]);
    if (mx[i] == -INFINITY) mx[i] = 0.f;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kSRows / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = exp2f(s[nt][e] - mx[e >> 1]);
      s[nt][e] = pe;
      sum[e >> 1] += pe;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = qv::warp_sum4(sum[i]);
    inv[i] = l > 0.f ? 1.f / l : 0.f;
  }

  float acc[kHD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kHD / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < kSRows / 16; ++kk) {
    if (kk * 16 >= whi || kk * 16 + 16 <= wlo) continue;
    const uint32_t a0 = qv::pack_bf16(s[2 * kk][0] * inv[0], s[2 * kk][1] * inv[0]);
    const uint32_t a1 = qv::pack_bf16(s[2 * kk][2] * inv[1], s[2 * kk][3] * inv[1]);
    const uint32_t a2 =
        qv::pack_bf16(s[2 * kk + 1][0] * inv[0], s[2 * kk + 1][1] * inv[0]);
    const uint32_t a3 =
        qv::pack_bf16(s[2 * kk + 1][2] * inv[1], s[2 * kk + 1][3] * inv[1]);
#pragma unroll
    for (int dp = 0; dp < kHD / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                            kSStride +
                        dp * 16 + (lane >> 4) * 8);
      qv::mma_bf16_16816(acc[2 * dp], a0, a1, a2, a3, b[0], b[1]);
      qv::mma_bf16_16816(acc[2 * dp + 1], a0, a1, a2, a3, b[2], b[3]);
    }
  }
#pragma unroll
  for (int dt = 0; dt < kHD / 8; ++dt) {
    const int c = dt * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(qs + (wr0 + g) * kSStride + c) =
        qv::pack_bf16(acc[dt][0], acc[dt][1]);
    *reinterpret_cast<uint32_t*>(qs + (wr0 + g + 8) * kSStride + c) =
        qv::pack_bf16(acc[dt][2], acc[dt][3]);
  }
}

template <bool kRotary, bool kMasked>
__global__ void __launch_bounds__(kSThreads)
short_span_kernel(SpanParams p, int tile_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);  // [2 stages][q, k, v]
  bf16* cst = tiles + 6 * kSTile;               // cos, sin (kRotary)
  uint8_t* kval = smem + short_smem_bytes(kRotary) - kSRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, p.s - row0);
  const int h0 = blockIdx.y * kHeadsPerCta;
  const int nheads = min(kHeadsPerCta, p.nh - h0);

  auto issue = [&](int h, int stage) {
    bf16* dst = tiles + stage * 3 * kSTile;
    stage_rows(dst, p.q + h * kHD, p.q_ss, row0, rows);
    stage_rows(dst + kSTile, p.k + h * kHD, p.k_ss, row0, rows);
    stage_rows(dst + 2 * kSTile, p.v + h * kHD, p.v_ss, row0, rows);
  };
  issue(h0, 0);
  if constexpr (kRotary) {
    stage_rows(cst, p.cos, p.cs_ss, row0, rows);
    stage_rows(cst + kSTile, p.sin, p.cs_ss, row0, rows);
  }
  cp_async_commit();
  if constexpr (kMasked) {
    for (int r = tid; r < kSRows; r += kSThreads) {
      kval[r] = r < rows ? p.valid[row0 + r] : 0;
    }
  }

  for (int i = 0; i < nheads; ++i) {
    const int stage = i & 1;
    if (i + 1 < nheads) {
      issue(h0 + i + 1, stage ^ 1);  // lands while this head computes
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    bf16* qs = tiles + stage * 3 * kSTile;
    bf16* ks = qs + kSTile;
    const bf16* vs = ks + kSTile;
    if constexpr (kRotary) {
      // each q and k row of the tile rotated once, in place
      for (int w = tid; w < 2 * rows * kHalfChunks; w += kSThreads) {
        const int kt = w >= rows * kHalfChunks;
        const int rem = w - kt * rows * kHalfChunks;
        const int r = rem / kHalfChunks, j = rem - r * kHalfChunks;
        bf16* x = (kt ? ks : qs) + r * kSStride;
        const bf16* cs = cst + r * kSStride;
        const bf16* sn = cs + kSTile;
        const int c1 = 8 * j, c2 = kHD / 2 + 8 * j;
        uint4 x1 = ld16(x + c1), x2 = ld16(x + c2);
        rotate_chunks(x1, x2, ld16(cs + c1), ld16(sn + c1), ld16(cs + c2),
                      ld16(sn + c2));
        st16(x + c1, x1);
        st16(x + c2, x2);
      }
      __syncthreads();
    }
    const int wr0 = warp * 16;
    if (wr0 < rows) {
      short_attend<kMasked>(qs, ks, vs, kval, wr0, rows, p.span,
                            p.scale_log2);
      __syncwarp();
      const int h = h0 + i;
      for (int c = lane; c < 16 * kChunks; c += 32) {
        const int r = wr0 + c / kChunks, ch = c % kChunks;
        if (r < rows) {
          st16(p.o + (long long)(row0 + r) * p.o_ss + h * kHD + ch * 8,
               ld16(qs + r * kSStride + ch * 8));
        }
      }
    }
    __syncthreads();  // this stage is refilled two heads on
  }
}

// long spans: 64 x 80 tiles in the canonical no-swizzle core-matrix layout.
// Core matrix (r / 8, c / 8) (8 rows x 8 columns, 128 contiguous bytes) sits
// at element ((r / 8) * 10 + c / 8) * 64, row r % 8 of it at + 8 * (r % 8).
// Along the head dim (K of QK^T) adjacent core matrices are 128 bytes apart,
// along rows 1280 bytes: the descriptors of Q and K (K-major) take LBO 128 /
// SBO 1280; V is the same layout read MN-major (N = head dim, K = keys):
// LBO 1280 (adjacent along keys) / SBO 128 (adjacent along the head dim).
constexpr int kLKeys = 64;
constexpr int kLTile = 64 * kHD;

constexpr int kWG = 4;      // consumer warpgroups per CTA
constexpr int kStages = 4;  // K/V ring slots
constexpr int kLThreads = 128 * kWG;
// bytes of dynamic shared memory: kWG Q tiles, kStages x (K, V), kval
constexpr int kLongSmem =
    (kWG + 2 * kStages) * kLTile * 2 + kStages * kLKeys;

__device__ __forceinline__ int canon(int r, int c8) {
  return ((r >> 3) * kChunks + c8) * 64 + (r & 7) * 8;
}

// cp.async rows [row0, row0 + 64) of one head into a canonical tile; rows
// at or past row0 + rows (rows may be <= 0) are zero. Eight consecutive
// threads take the 8 rows of one core matrix, so each 8-thread phase writes
// 128 contiguous bytes (no bank conflict; row-major order would put all 8 on
// the same 4 banks) and a warp reads 64 contiguous bytes of each of 8 rows.
__device__ __forceinline__ void stage_canon(bf16* dst, const bf16* src,
                                            long long ss, int row0, int rows) {
  for (int i = threadIdx.x; i < 64 * kChunks; i += kLThreads) {
    const int rg = i / (8 * kChunks), rem = i - rg * 8 * kChunks;
    const int c = rem >> 3, r = rg * 8 + (rem & 7);
    const bool ok = r < rows;
    cp_async16(dst + canon(r, c),
               src + (long long)(row0 + (ok ? r : 0)) * ss + c * 8, ok);
  }
}

// kWG consumer warpgroups, each on 64 query rows of one span, share a ring
// of kStages K/V tiles; every thread issues the copies. Per key tile j a
// warpgroup issues S_j = Q K_j^T, then O += P_{j-1} V_{j-1}, and runs the
// softmax of S_j while the tensor cores do the second product; tiles are
// copied two ahead of their use. Slot (j - 1) % kStages is still read by
// that product during step j, so the ring holds 4 tiles for a copy
// distance of 2 (kStages - 2).
template <bool kMasked>
__global__ void __launch_bounds__(kLThreads, 1)
long_span_kernel(SpanParams p) {
  constexpr int kQRows = 64 * kWG;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [kWG]
  bf16* kst = qs + kWG * kLTile;             // [kStages]
  bf16* vst = kst + kStages * kLTile;        // [kStages]
  uint8_t* kval = smem + (kWG + 2 * kStages) * kLTile * 2;  // [kStages][64]
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int tiles_per_span = (p.span + kQRows - 1) / kQRows;
  const int span_idx = blockIdx.x / tiles_per_span;
  const int tis = blockIdx.x - span_idx * tiles_per_span;
  const int h = blockIdx.y;
  const int kbeg = span_idx * p.span;  // the span's first row (and key)
  const int row0 = kbeg + tis * kQRows + 64 * wg;  // this warpgroup's rows
  const int rows = min(64, p.span - tis * kQRows - 64 * wg);  // may be <= 0
  const int nkt = (p.span + kLKeys - 1) / kLKeys;

  auto issue_kv = [&](int j) {
    const int stage = j % kStages;
    const int nk = min(kLKeys, p.span - j * kLKeys);
    const int key0 = kbeg + j * kLKeys;
    stage_canon(kst + stage * kLTile, p.k + h * kHD, p.k_ss, key0, nk);
    stage_canon(vst + stage * kLTile, p.v + h * kHD, p.v_ss, key0, nk);
    if constexpr (kMasked) {
      if (tid < kLKeys) {
        kval[stage * kLKeys + tid] = tid < nk ? p.valid[key0 + tid] : 0;
      }
    }
  };
#pragma unroll
  for (int w = 0; w < kWG; ++w) {
    const int r0 = kbeg + tis * kQRows + 64 * w;
    stage_canon(qs + w * kLTile, p.q + h * kHD, p.q_ss, r0,
                p.span - tis * kQRows - 64 * w);
  }
  // one commit group per tile, empty past the last tile, so that "tile j
  // has landed" is always wait_group<kAhead - 1>
  constexpr int kAhead = kStages - 2;
  static_assert(kAhead >= 1, "the ring needs at least 3 slots");
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (j < nkt) issue_kv(j);
    cp_async_commit();
  }

  float o[40];
#pragma unroll
  for (int i = 0; i < 40; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float s[32] = {};
  uint32_t pa[kLKeys / 16][4];  // P_{j-1}, the A operand of the PV product
  const uint64_t qdesc = gmma_desc(qs + wg * kLTile, 128, 1280);
  // O += P V_stage: keys [16kk, 16kk + 16) are core-matrix row groups 2kk,
  // 2kk + 1
  auto issue_pv = [&](int stage) {
    const bf16* vs = vst + stage * kLTile;
    reg_fence(o);
#pragma unroll
    for (int kk = 0; kk < kLKeys / 16; ++kk) {
      wgmma_m64n80k16_rs(o, pa[kk], gmma_desc(vs + kk * 2 * kChunks * 64,
                                              1280, 128));
    }
    wgmma_commit();
  };

  // the start of step j: tile j landed and visible to every warpgroup,
  // which has waited for its P_{j-2} V_{j-2}, so slot (j + kAhead) %
  // kStages = (j - 2) % kStages is free for the next copy
  auto next_tile = [&](int j) {
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    if (j + kAhead < nkt) issue_kv(j + kAhead);
    cp_async_commit();
  };
  auto issue_s = [&](int j) {  // S = Q K_j^T, 5 k-steps of 16
    const uint64_t kdesc =
        gmma_desc(kst + (j % kStages) * kLTile, 128, 1280);
    reg_fence(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk) {
      // k-step kk: head-dim chunks 2kk, 2kk + 1 (256 bytes on)
      wgmma_m64n64k16_ss(s, qdesc + 16 * kk, kdesc + 16 * kk, kk > 0);
    }
    wgmma_commit();
  };
  // softmax of S_j in place (s becomes P_j, unrounded); returns the
  // rescale of the running sums in alpha. Accumulator element (nt, e): row
  // 16 warp + g + 8 (e / 2), key 8 nt + 2 t4 + e % 2 of the tile. Raw
  // scores: scale_log2 > 0 commutes with the max, and goes into one FFMA
  // per element.
  float alpha[2];
  auto softmax = [&](int j) {
    const int nk = min(kLKeys, p.span - j * kLKeys);
    float mx[2] = {-INFINITY, -INFINITY};
    if (!kMasked && nk == kLKeys) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    } else {
      const uint8_t* kv = kval + (j % kStages) * kLKeys;
#pragma unroll
      for (int nt = 0; nt < kLKeys / 8; ++nt) {
        // the validity bytes of this thread's two adjacent keys, in one load
        const uint32_t kv2 = kMasked ? *reinterpret_cast<const uint16_t*>(
                                           kv + nt * 8 + 2 * t4)
                                     : 0x0101u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = nt * 8 + 2 * t4 + (e & 1);
          const bool ok = key < nk && ((kv2 >> (8 * (e & 1))) & 0xFF);
          if (!ok) s[nt * 4 + e] = -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt * 4 + e]);
        }
      }
    }
    float m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new =
          fmaxf(m_run[i], qv::warp_max4(mx[i]) * p.scale_log2);
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = ex2(m_run[i] - m_use[i]);
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float pe = ex2(fmaf(s[i], p.scale_log2, -m_use[(i >> 1) & 1]));
      s[i] = pe;
      l_run[(i >> 1) & 1] += pe;
    }
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kLKeys / 16; ++kk) {
      pa[kk][0] = qv::pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = qv::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = qv::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = qv::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  // Every warpgroup runs every product, also one past the span's last row
  // (its Q tile is zeros, its rows are not stored): a wgmma on a divergent
  // path would make ptxas serialize the pipeline.
  next_tile(0);
  issue_s(0);
  wgmma_wait<0>();
  reg_fence(s);
  softmax(0);
  pack_p();
  for (int j = 1; j < nkt; ++j) {
    next_tile(j);
    issue_s(j);
    issue_pv((j - 1) % kStages);
    wgmma_wait<1>();  // S_j done; P_{j-1} V_{j-1} may still run
    reg_fence(s);
    softmax(j);
    wgmma_wait<0>();  // P_{j-1} V_{j-1} is in O; pa is free
    reg_fence(o);
#pragma unroll
    for (int i = 0; i < 40; ++i) o[i] *= alpha[(i >> 1) & 1];
    pack_p();
  }
  wgmma_fence();
  issue_pv((nkt - 1) % kStages);  // the last tile's product
  wgmma_wait<0>();
  reg_fence(o);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = qv::warp_sum4(l_run[i]);
    const int r = warp * 16 + g + 8 * i;
    if (r >= rows) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    bf16* orow = p.o + (long long)(row0 + r) * p.o_ss + h * kHD;
#pragma unroll
    for (int dt = 0; dt < kHD / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t4) = qv::pack_bf16(
          o[dt * 4 + 2 * i] * inv, o[dt * 4 + 2 * i + 1] * inv);
    }
  }
}

// dynamic shared memory above 48 KB is opted into once per kernel
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

template <bool kRotary, bool kMasked>
int launch_short(const SpanParams& p, cudaStream_t st) {
  static bool done = false;
  const int bytes = short_smem_bytes(kRotary);
  auto kernel = short_span_kernel<kRotary, kMasked>;
  cudaError_t err = allow_smem(kernel, bytes, done);
  if (err != cudaSuccess) return (int)err;
  const int tile_rows = (kSRows / p.span) * p.span;  // whole spans
  dim3 grid((p.s + tile_rows - 1) / tile_rows,
            (p.nh + kHeadsPerCta - 1) / kHeadsPerCta);
  kernel<<<grid, kSThreads, bytes, st>>>(p, tile_rows);
  return (int)cudaGetLastError();
}

template <bool kMasked>
int launch_long(const SpanParams& p, cudaStream_t st) {
  static bool done = false;
  auto kernel = long_span_kernel<kMasked>;
  cudaError_t err = allow_smem(kernel, kLongSmem, done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.s / p.span) * ((p.span + 64 * kWG - 1) / (64 * kWG)), p.nh);
  kernel<<<grid, kLThreads, kLongSmem, st>>>(p);
  return (int)cudaGetLastError();
}

SpanParams span_params(const void* q, const void* k, const void* v, void* o,
                       long long q_ss, long long k_ss, long long v_ss,
                       long long o_ss, int s, int nh, int span, float scale) {
  SpanParams p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.q_ss = q_ss; p.k_ss = k_ss; p.v_ss = v_ss; p.o_ss = o_ss;
  p.s = s; p.nh = nh; p.span = span;
  p.scale_log2 = scale * 1.4426950408889634f;
  return p;
}

}  // namespace

// The rotary pass: qo/ko = rotary(q/k) with (S, 80) activation-dtype tables.
extern "C" int qv_vision_rotary(
    const void* q, const void* k, const void* cos, const void* sin, void* qo,
    void* ko, long long q_ss, long long k_ss, long long cs_ss,
    long long qo_ss, long long ko_ss, int s, int nh, void* stream) {
  RotaryParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.cos = static_cast<const bf16*>(cos);
  p.sin = static_cast<const bf16*>(sin);
  p.qo = static_cast<bf16*>(qo);
  p.ko = static_cast<bf16*>(ko);
  p.q_ss = q_ss; p.k_ss = k_ss; p.cs_ss = cs_ss; p.qo_ss = qo_ss;
  p.ko_ss = ko_ss;
  p.s = s; p.nh = nh;
  const long long n = (long long)s * nh * kHalfChunks;
  vision_rotary_kernel<<<(unsigned)((n + kRotThreads - 1) / kRotThreads),
                         kRotThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// B2 on spans of at most 64 rows: rotary inside the short-span kernel.
// (Longer spans: the wrapper runs qv_vision_rotary, then
// qv_block_diag_attention on the rotated rows.)
extern "C" int qv_vision_attention(
    const void* q, const void* k, const void* v, void* o, const void* cos,
    const void* sin, long long q_ss, long long k_ss, long long v_ss,
    long long o_ss, long long cs_ss, int s, int nh, int span, float scale,
    void* stream) {
  if (span < 1 || span > kSRows) return (int)cudaErrorInvalidValue;
  SpanParams p = span_params(q, k, v, o, q_ss, k_ss, v_ss, o_ss, s, nh, span,
                             scale);
  p.cos = static_cast<const bf16*>(cos);
  p.sin = static_cast<const bf16*>(sin);
  p.cs_ss = cs_ss;
  return launch_short<true, false>(p, static_cast<cudaStream_t>(stream));
}

// B5: q/k/v/o as for B2 (already rotated); `valid` is null (unmasked) or an
// (S,) byte vector, 1 for a valid key. Short or long kernel by span.
extern "C" int qv_block_diag_attention(
    const void* q, const void* k, const void* v, void* o, const void* valid,
    long long q_ss, long long k_ss, long long v_ss, long long o_ss, int s,
    int nh, int span, float scale, void* stream) {
  if (span < 1 || s % span) return (int)cudaErrorInvalidValue;
  SpanParams p = span_params(q, k, v, o, q_ss, k_ss, v_ss, o_ss, s, nh, span,
                             scale);
  p.valid = static_cast<const uint8_t*>(valid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (span <= kSRows) {
    return valid ? launch_short<false, true>(p, st)
                 : launch_short<false, false>(p, st);
  }
  return valid ? launch_long<true>(p, st) : launch_long<false>(p, st);
}

// Registers, local (spill) bytes, static and dynamic shared memory of the
// vision kernels, by index: 0 the rotary pass, 1 B2 short-span, 2 short-span,
// 3 short-span masked, 4 long-span, 5 long-span masked. Returns a CUDA error.
extern "C" int qv_vision_kernel_info(int which, int* regs, int* local_bytes,
                                     int* static_smem, int* dynamic_smem) {
  cudaFuncAttributes a;
  cudaError_t err;
  int dyn = 0;
  switch (which) {
    case 0: err = cudaFuncGetAttributes(&a, vision_rotary_kernel); break;
    case 1:
      err = cudaFuncGetAttributes(&a, short_span_kernel<true, false>);
      dyn = short_smem_bytes(true);
      break;
    case 2:
      err = cudaFuncGetAttributes(&a, short_span_kernel<false, false>);
      dyn = short_smem_bytes(false);
      break;
    case 3:
      err = cudaFuncGetAttributes(&a, short_span_kernel<false, true>);
      dyn = short_smem_bytes(false);
      break;
    case 4:
      err = cudaFuncGetAttributes(&a, long_span_kernel<false>);
      dyn = kLongSmem;
      break;
    case 5:
      err = cudaFuncGetAttributes(&a, long_span_kernel<true>);
      dyn = kLongSmem;
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *static_smem = (int)a.sharedSizeBytes;
  *dynamic_smem = dyn;
  return 0;
}
