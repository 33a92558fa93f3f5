"""Kernels B3, B4 and B6: the int8 vision tower's fused projections.

Counterpart of quickvideo_tpu/ops/fused_vision_mlp.py. Per row of the
block input, with the JAX kernels' rounding points:

  prologue (B3, B4): rmsnorm in f32, rounded to bf16; times ln_w, rounded
      to bf16; per-row int8 quantize (quantize_act's scale rule)
  GEMM: int8 x int8 -> int32 against a quantized weight
  B3 epilogue: bf16((acc * xs) * sc) + b          -> (S, N) bf16
  B4/B6 epilogue: the same against [wg | wu], then silu(g) * u in f32 and a
      per-row int8 requantize -> (S, Np) int8 + (S, 1) f32 scales

B6 is B4 fed a pre-quantized input (xq, xs) instead of the raw rows.

Each entry runs its plain PyTorch version (`*_plain`) on a CPU tensor, and
on a CUDA tensor launches the hand-written Hopper kernels
(csrc/fused_vision_mlp.cu: the row prologue for B3 and B4, then one s8
wgmma GEMM on a TMA ring with each entry's epilogue), counts the launch in
`<entry>.launches`, and raises on an input the kernel does not take: there
is no fallback. The kernels' tiling is planned here (`b3_grid`,
`mlp_plan`), so its rules are CPU-tested.

The bf16 rounding points are fixed whatever the model dtype, as in the JAX
kernels: B3 returns bf16, and the bias is rounded to bf16 first.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quickvideo_tpu_torch import _build
from quickvideo_tpu_torch.ops.quantization import (
    int_mm,
    is_quantized,
    quantize_act,
)

# The weight prep pads the intermediate width to a multiple of PAD; B4/B6
# process it in chunks (CHUNKS) of gate columns with the up columns that
# pair with them
PAD = 64

# The CUDA kernels' tiling (csrc/fused_vision_mlp.cu). K streams through a
# ring of stages of KB bytes, so the width C has no upper bound.
KB = 128
B3_ROWS, B3_COLS = 128, 256  # B3's output tile (per CTA)
MLP_ROWS = 128  # B4/B6: rows per band (two consumer warpgroups)
CHUNKS = (72, 64)  # B4/B6: gate columns per chunk, widest first
SMEM_MAX = 232_448  # shared memory one block can opt into on sm_90
CLUSTERS = (1, 2, 4, 8, 16)  # CTAs per cluster; above 8 non-portable
MIN_STAGES, MAX_STAGES = 3, 6


# -- launch plans ----------------------------------------------------------------


def b3_grid(s_len: int, n: int, sms: int) -> int:
    """B3's persistent grid: one CTA per SM, or one per tile of B3_ROWS x
    B3_COLS outputs when there are fewer."""
    tiles = -(-s_len // B3_ROWS) * -(-n // B3_COLS)
    return max(1, min(tiles, sms))


def mlp_smem(chunk: int, stages: int, nch: int) -> int:
    """Shared memory of B4/B6's kernel (csrc/fused_vision_mlp.cu::mlp_smem):
    alignment slack, `stages` ring stages (the A box of MLP_ROWS rows and
    the gate and up boxes of `chunk` rows, KB bytes of K each), `nch` f32
    slices of MLP_ROWS rows x `chunk` columns, the row maxima and scales,
    the barriers."""
    return (1024 + stages * (MLP_ROWS + 2 * chunk) * KB
            + nch * MLP_ROWS * chunk * 4 + 2 * MLP_ROWS * 4 + 2 * stages * 8)


class MlpPlan(NamedTuple):
    chunk: int    # gate columns per chunk (with as many up columns)
    cluster: int  # CTAs per cluster, sharing a row band
    nch: int      # chunks per CTA, at most
    stages: int   # ring stages
    smem: int     # bytes of shared memory per CTA


def _fit(n_pad: int, chunk: int):
    """The smallest cluster whose CTAs hold their chunks' f32 slices beside
    MIN_STAGES ring stages; then as many stages as fit. None if none
    fits."""
    m = n_pad // chunk
    for cluster in CLUSTERS:
        nch = -(-m // cluster)
        if mlp_smem(chunk, MIN_STAGES, nch) > SMEM_MAX:
            continue
        stages = max(s for s in range(MIN_STAGES, MAX_STAGES + 1)
                     if mlp_smem(chunk, s, nch) <= SMEM_MAX)
        return MlpPlan(chunk, cluster, nch, stages,
                       mlp_smem(chunk, stages, nch))
    return None


def mlp_plan(n_pad: int) -> MlpPlan:
    """B4/B6's launch for an intermediate width Np (a multiple of PAD): for
    each chunk width of CHUNKS that divides Np, the smallest cluster that
    holds a row band's slices (`_fit`); of those, the one with the fewest
    columns of chunk slots per band (cluster x nch x chunk: the busiest
    CTA sets the band's time), the wider chunk on a tie. Raises when no
    cluster holds a row band's slices."""
    if n_pad <= 0 or n_pad % PAD:
        raise ValueError(f"no B4/B6 plan for Np={n_pad}")
    plans = [f for c in CHUNKS if n_pad % c == 0
             if (f := _fit(n_pad, c)) is not None]
    if not plans:
        raise ValueError(
            f"Np={n_pad} is wider than a cluster of {CLUSTERS[-1]} CTAs "
            f"holds in shared memory"
        )
    return min(plans, key=lambda f: f.cluster * f.nch * f.chunk)


def cta_chunks(rank: int, plan: MlpPlan, n_pad: int) -> list:
    """The chunks (of plan.chunk gate columns) that the CTA of cluster rank
    `rank` computes and quantizes: rank, rank + cluster, ... below
    Np / chunk (gemm_silu_quant_kernel's round-robin)."""
    return list(range(rank, n_pad // plan.chunk, plan.cluster))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# -- weight prep ----------------------------------------------------------------


def _fuse_block(bp: dict, ii: int, np_: int) -> dict:
    wg, wu, wd = bp["wg"], bp["wu"], bp["wd"]
    c = wg["q8"].shape[0]
    dev = wg["q8"].device
    q = torch.zeros(2 * np_, c, dtype=torch.int8, device=dev)  # (out, in)
    q[:ii] = wg["q8"].t()
    q[np_ : np_ + ii] = wu["q8"].t()
    sc = torch.ones(2 * np_, dtype=torch.float32, device=dev)
    sc[:ii] = wg["sc"]
    sc[np_ : np_ + ii] = wu["sc"]
    b = torch.zeros(2 * np_, dtype=torch.bfloat16, device=dev)
    b[:ii] = bp["bg"]
    b[np_ : np_ + ii] = bp["bu"]
    qd = torch.zeros(wd["q8"].shape[1], np_, dtype=torch.int8, device=dev)
    qd[:, :ii] = wd["q8"].t()  # (C, Np) row-major = (Np, C) column-major
    out = {k: v for k, v in bp.items() if k not in ("wg", "wu", "bg", "bu", "wd")}
    out["wgu_p"] = {"q8": q.t(), "sc": sc}
    out["bgu_p"] = b
    out["wd_p"] = {"q8": qd.t(), "sc": wd["sc"]}
    return out


def fuse_vision_mlp_weights(vision_params: dict, cfg) -> dict:
    """One-time prep of an int8 tower for B4: per block, gate and up
    concatenated on the output axis into `wgu_p` (C, 2*Np), each half
    padded from I to Np = I rounded up to PAD columns (zero q8, scale 1.0,
    zero bias: pad columns compute silu(0) * 0 = 0 and leave every row's
    max alone), `bgu_p` (2*Np,) bf16, and `wd_p`, the down projection with
    Np - I zero input rows. The unpadded wg/wu/bg/bu/wd leave the block: B4
    is the tower's one MLP route. Returns a new tree sharing every other
    leaf; a float tower or one already prepped comes back as it is."""
    blocks = vision_params.get("blocks")
    if not blocks or "wgu_p" in blocks[0] or not is_quantized(
        blocks[0].get("wg")
    ):
        return vision_params
    ii = cfg.intermediate_size
    np_ = _round_up(ii, PAD)
    out = dict(vision_params)
    out["blocks"] = [_fuse_block(bp, ii, np_) for bp in blocks]
    return out


# -- plain versions ---------------------------------------------------------------


def ln_quantize_plain(x: torch.Tensor, ln_w: torch.Tensor, eps: float):
    """rmsnorm(x) * ln_w with the JAX kernel's two bf16 roundings, then
    per-row int8 quantize: (xq (S, C) int8, xs (S, 1) f32)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    t = (xf * torch.rsqrt(var + eps)).to(torch.bfloat16).float()
    h = (t * ln_w.float()).to(torch.bfloat16).float()
    return quantize_act(h)


def _gemm_bias_plain(xq, xs, w: dict, b) -> torch.Tensor:
    acc = int_mm(xq, w["q8"])
    y = ((acc.float() * xs) * w["sc"].reshape(1, -1)).to(torch.bfloat16)
    return y + b.reshape(1, -1).to(torch.bfloat16)


def _silu_quant_plain(y: torch.Tensor):
    n_pad = y.shape[1] // 2
    g = y[:, :n_pad].float()
    u = y[:, n_pad:].float()
    m = g * torch.sigmoid(g) * u
    return quantize_act(m)


def ln_gemm_bias_plain(x, ln_w, w: dict, b, eps: float) -> torch.Tensor:
    return _gemm_bias_plain(*ln_quantize_plain(x, ln_w, eps), w, b)


def ln_dual_gemm_silu_quant_plain(x, ln_w, wgu: dict, bgu, eps: float):
    return _silu_quant_plain(
        _gemm_bias_plain(*ln_quantize_plain(x, ln_w, eps), wgu, bgu)
    )


def dual_gemm_silu_quant_plain(xq, xs, wgu: dict, bgu):
    return _silu_quant_plain(_gemm_bias_plain(xq, xs, wgu, bgu))


# -- kernel launches --------------------------------------------------------------


def _check_weight(w: dict, c: int, dev) -> int:
    q8, sc = w["q8"], w["sc"]
    if q8.dtype != torch.int8 or sc.dtype != torch.float32:
        raise TypeError(f"weight must be int8 with f32 scales, got "
                        f"{q8.dtype}/{sc.dtype}")
    n = q8.shape[1]
    if q8.shape[0] != c or q8.stride() != (1, c):
        raise ValueError(
            f"weight q8 must be the (in={c}, out) view of a row-major "
            f"(out, in) tensor, got shape {tuple(q8.shape)} strides "
            f"{q8.stride()}"
        )
    if sc.numel() != n or not sc.is_contiguous():
        raise ValueError(f"scales must be ({n},) contiguous")
    if q8.data_ptr() % 16 or sc.data_ptr() % 16:
        raise ValueError("weight q8 or its scales not 16-byte aligned")
    for t in (q8, sc):
        if t.device != dev:
            raise ValueError(f"weight on {t.device}, input on {dev}")
    return n


def _check_rows(name: str, t: torch.Tensor, dtype, c: int, dev):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    if t.ndim != 2 or t.shape[1] != c or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (S, {c}), got "
                         f"{tuple(t.shape)} strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def _check_width(c: int):
    # TMA rows must be 16-byte strided; K steps of 32 bytes
    if c % 32 or c <= 0:
        raise ValueError(
            f"the fused kernels take a width C that is a positive multiple "
            f"of 32, got {c}"
        )


def _vec(name: str, t: torch.Tensor, dtype, n: int, dev) -> torch.Tensor:
    if t.dtype != dtype or t.numel() != n or not t.is_contiguous():
        raise ValueError(f"{name} must be ({n},) contiguous {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    # the kernels read scales and ln_w 8 or 16 bytes at a time
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def ln_gemm_bias(x: torch.Tensor, ln_w: torch.Tensor, w: dict,
                 b: torch.Tensor, eps: float) -> torch.Tensor:
    """B3: rmsnorm(x) * ln_w -> per-row int8 -> int8 GEMM -> rescale +
    bias. x (S, C) raw block input; w {"q8": (C, N), "sc": (N,)}; b (N,).
    Returns (S, N) bf16."""
    if x.device.type == "cpu":
        return ln_gemm_bias_plain(x, ln_w, w, b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    s_len, c = x.shape
    dev = x.device
    _check_width(c)
    _check_rows("x", x, torch.bfloat16, c, dev)
    n = _check_weight(w, c, dev)
    if n % 8:
        raise ValueError(f"B3 needs N a multiple of 8, got {n}")
    ln_w = _vec("ln_w", ln_w.float(), torch.float32, c, dev)
    b = _vec("bias", b.to(torch.bfloat16), torch.bfloat16, n, dev)
    out = torch.empty(s_len, n, dtype=torch.bfloat16, device=dev)
    xq, xs = _row_scratch(s_len, c, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if s_len:
        err = _build.library().qv_ln_gemm_bias(
            x.data_ptr(), ln_w.data_ptr(), w["q8"].data_ptr(),
            w["sc"].data_ptr(), b.data_ptr(), xq.data_ptr(), xs.data_ptr(),
            out.data_ptr(), s_len, c, n, float(eps), b3_grid(s_len, n, sms),
            _stream(dev),
        )
        _build.check(err, "qv_ln_gemm_bias")
        ln_gemm_bias.launches += 1
    return out


def _row_scratch(s_len: int, c: int, dev):
    """The prologue's int8 rows and their scales (B3, B4)."""
    return (torch.empty(s_len, c, dtype=torch.int8, device=dev),
            torch.empty(s_len, dtype=torch.float32, device=dev))


def _dual_outputs(s_len: int, n2: int, dev):
    if n2 % (2 * PAD):
        raise ValueError(
            f"[wg | wu] must have 2 * Np columns with Np a multiple of "
            f"{PAD} (fuse_vision_mlp_weights), got {n2}"
        )
    n_pad = n2 // 2
    q = torch.empty(s_len, n_pad, dtype=torch.int8, device=dev)
    s = torch.empty(s_len, 1, dtype=torch.float32, device=dev)
    return n_pad, q, s


def ln_dual_gemm_silu_quant(x: torch.Tensor, ln_w: torch.Tensor, wgu: dict,
                            bgu: torch.Tensor, eps: float):
    """B4: the B3 prologue, then the GEMM against [wg | wu], silu(g) * u in
    f32 and a per-row int8 requantize. Returns (mq8 (S, Np) int8,
    ms (S, 1) f32), ready for qdot_pre against `wd_p`."""
    if x.device.type == "cpu":
        return ln_dual_gemm_silu_quant_plain(x, ln_w, wgu, bgu, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    s_len, c = x.shape
    dev = x.device
    _check_width(c)
    _check_rows("x", x, torch.bfloat16, c, dev)
    n2 = _check_weight(wgu, c, dev)
    ln_w = _vec("ln_w", ln_w.float(), torch.float32, c, dev)
    bgu = _vec("bias", bgu.to(torch.bfloat16), torch.bfloat16, n2, dev)
    n_pad, q, s = _dual_outputs(s_len, n2, dev)
    plan = mlp_plan(n_pad)
    xq, xs = _row_scratch(s_len, c, dev)
    if s_len:
        err = _build.library().qv_ln_dual_gemm_silu_quant(
            x.data_ptr(), ln_w.data_ptr(), wgu["q8"].data_ptr(),
            wgu["sc"].data_ptr(), bgu.data_ptr(), xq.data_ptr(),
            xs.data_ptr(), q.data_ptr(), s.data_ptr(), s_len, c, n_pad,
            float(eps), plan.chunk, plan.cluster, plan.nch, plan.stages,
            _stream(dev),
        )
        _build.check(err, "qv_ln_dual_gemm_silu_quant")
        ln_dual_gemm_silu_quant.launches += 1
    return q, s


def dual_gemm_silu_quant(xq: torch.Tensor, xs: torch.Tensor, wgu: dict,
                         bgu: torch.Tensor):
    """B6: B4 from a pre-quantized input, xq (S, C) int8 and xs (S, 1)
    f32. Returns (mq8 (S, Np) int8, ms (S, 1) f32)."""
    if xq.device.type == "cpu":
        return dual_gemm_silu_quant_plain(xq, xs, wgu, bgu)
    if xq.device.type != "cuda":
        raise ValueError(f"unsupported device {xq.device}")
    s_len, c = xq.shape
    dev = xq.device
    _check_width(c)
    _check_rows("xq", xq, torch.int8, c, dev)
    _vec("xs", xs, torch.float32, s_len, dev)
    n2 = _check_weight(wgu, c, dev)
    bgu = _vec("bias", bgu.to(torch.bfloat16), torch.bfloat16, n2, dev)
    n_pad, q, s = _dual_outputs(s_len, n2, dev)
    plan = mlp_plan(n_pad)
    if s_len:
        err = _build.library().qv_dual_gemm_silu_quant(
            xq.data_ptr(), xs.data_ptr(), wgu["q8"].data_ptr(),
            wgu["sc"].data_ptr(), bgu.data_ptr(), q.data_ptr(), s.data_ptr(),
            s_len, c, n_pad, plan.chunk, plan.cluster, plan.nch, plan.stages,
            _stream(dev),
        )
        _build.check(err, "qv_dual_gemm_silu_quant")
        dual_gemm_silu_quant.launches += 1
    return q, s


ln_gemm_bias.launches = 0
ln_dual_gemm_silu_quant.launches = 0
dual_gemm_silu_quant.launches = 0

