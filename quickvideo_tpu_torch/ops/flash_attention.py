"""Kernel B1: flash attention over one layer of the KV cache.

`flash_past_attention` is the port's language attention entry. On a CUDA
tensor it launches a hand-written Hopper kernel (csrc/flash_attention.cu)
and counts the launch in `flash_past_attention.launches`, per variant in
`flash_past_attention.variant_launches` ("bf16", "int8", "int8k"), per
(variant, mode) in the Counter `flash_past_attention.mode_launches` (mode
"unified", "unified+lse", "past" or "past+lse") and per kernel in the
Counter `flash_past_attention.kernel_launches`; on a CPU tensor it runs
the plain version (ops/attention.py). A CUDA tensor the kernel does not
take (dtype, head dim, strides) raises: there is no fallback.

Kernels, by shape alone (`_plan`), each for every cache: at least one
full row tile of packed rows (G * rep >= PREFILL_ROWS: the group steps, a
long final prefill) runs "bf16_prefill" on a bf16 cache and
"int8_prefill" on an int8 / int8k one (wgmma on a TMA ring of K/V tiles,
192 packed rows per CTA); smaller G (decode, a short final prefill,
query-based group 0) "decode" (rows in one m16 tile per CTA, a deep TMA
ring per SM). Split-K partials are merged by a second launch.

Replaces quickvideo_tpu/ops/flash_attention.py::flash_past_attention in its
two modes: unified causal (`causal=True`; the group's K/V already sit at
[length, length + G) and row i attends [0, length + i]) and pure past
(`causal=False`; every row attends [0, length)), with the optional
log-sum-exp (`with_lse`) and a bf16 or f32 output (`out_dtype`). With a
bf16 cache, and with an int8 cache (`k_scale`, and `v_scale` unless V is
unquantized) on its default int8-QK route, where q is quantized per row
first (ops/attention.py::quantize_q, shared with the plain version).
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Optional, Tuple

import torch

from quickvideo_tpu_torch import _build
from quickvideo_tpu_torch.ops.attention import (
    cache_attention,
    cache_attention_int8,
    quantize_q,
)

HEAD_DIM = 128  # the kernels are compiled for this head dim
KEY_TILE = 64  # keys per tile, every kernel
DECODE_ROWS = 16  # packed rows per CTA: the decode kernel (one m16 tile)
PREFILL_ROWS = 192  # packed rows per CTA: the prefill kernels
# every kernel runs one CTA per SM (the decode kernel's ring is ~200 KB)
MIN_SPLIT_TILES = 4  # key tiles a split keeps at least


class Plan(NamedTuple):
    """One launch: the kernel, its packed rows per CTA, its grid (kv heads,
    row blocks, splits) and the key-range splits per CTA."""

    kernel: str  # "bf16_prefill", "int8_prefill" or "decode"
    rows: int
    grid: Tuple[int, int, int]
    n_split: int


def _plan(g: int, hq: int, hkv: int, length: int, cap: int, causal: bool,
          sms: int, variant: str = "bf16") -> Plan:
    """The kernel for this shape, its grid and its split-K: a kernel splits
    its key range when its CTAs (one per SM) do not fill the SMs; a split
    keeps at least MIN_SPLIT_TILES key tiles."""
    rows = g * (hq // hkv)
    key_tiles = -(-min(length + g if causal else length, cap) // KEY_TILE)
    if rows >= PREFILL_ROWS:
        kernel = "bf16_prefill" if variant == "bf16" else "int8_prefill"
        tile = PREFILL_ROWS
    else:
        kernel, tile = "decode", DECODE_ROWS
    blocks = -(-rows // tile)
    ctas = blocks * hkv
    n_split = 1
    if ctas < sms:
        n_split = max(1, min(-(-sms // ctas), key_tiles // MIN_SPLIT_TILES))
    return Plan(kernel, tile, (hkv, blocks, n_split), n_split)


def cta_key_tiles(plan: Plan, g: int, rep: int, length: int, cap: int,
                  causal: bool, block: int, split: int) -> Tuple[int, int]:
    """Key tiles [kb0, kb1) of the CTA at grid index `block` along the row
    blocks and `split` along the splits, as the kernels compute them: the
    CTA's keys end at min(length + its last position + 1, cap) (pure past:
    min(length, cap)). Row blocks run in reverse, so that in unified mode
    the longest key ranges start first."""
    rows = g * rep
    blocks = -(-rows // plan.rows)
    row0 = (blocks - 1 - block) * plan.rows
    pos_hi = (min(row0 + plan.rows, rows) - 1) // rep
    kend = min(length + pos_hi + 1, cap) if causal else min(length, cap)
    nkb = -(-kend // KEY_TILE)
    chunk = -(-nkb // plan.n_split)
    kb0 = min(nkb, split * chunk)
    return kb0, min(nkb, kb0 + chunk)


def _check_rows(name: str, t: torch.Tensor, dtype, dev) -> None:
    """A (H, cap or G, 128) operand: dtype, device, contiguous head dim,
    16-byte aligned rows (the kernel's vector loads)."""
    if t.dtype != dtype:
        raise TypeError(f"flash kernel takes {dtype} {name}, got {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, q on {dev}")
    if t.shape[-1] != HEAD_DIM or t.stride(-1) != 1:
        raise ValueError(
            f"flash kernel needs head dim {HEAD_DIM} contiguous, got "
            f"{name} shape {tuple(t.shape)} strides {t.stride()}"
        )
    step = 16 // t.element_size()
    if t.stride(0) % step or t.stride(1) % step or t.data_ptr() % 16:
        raise ValueError(f"{name} rows are not 16-byte aligned")


def _check_scales(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    """(Hkv, cap) f32 per-token scales of a layer, stride 1 along cap,
    16-byte aligned rows (the kernels load them by TMA)."""
    if t.dtype != torch.float32:
        raise TypeError(f"flash kernel takes f32 {name}, got {t.dtype}")
    if t.device != like.device:
        raise ValueError(f"{name} on {t.device}, cache on {like.device}")
    if tuple(t.shape) != tuple(like.shape[:2]) or t.stride(1) != 1:
        raise ValueError(
            f"{name} must be (Hkv, cap) = {tuple(like.shape[:2])} with "
            f"stride 1 along cap, got {tuple(t.shape)} strides {t.stride()}"
        )
    if t.stride(0) % 4 or t.data_ptr() % 16:
        raise ValueError(f"{name} rows are not 16-byte aligned (TMA)")


def flash_past_attention(
    q: torch.Tensor,  # (Hq, G, D), last dim contiguous
    k_layer: torch.Tensor,  # (Hkv, cap, D) layer view of the stacked cache
    v_layer: torch.Tensor,
    length: int,  # host int: valid slots before the group
    scale: float,
    k_scale: Optional[torch.Tensor] = None,  # (Hkv, cap) f32, int8 K
    v_scale: Optional[torch.Tensor] = None,  # (Hkv, cap) f32, int8 V
    *,
    causal: bool = True,  # unified causal; False = pure past
    with_lse: bool = False,
    out_dtype: Optional[torch.dtype] = None,  # q's dtype, or float32
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Attention of the group's queries over one cache layer (module
    docstring for the modes). With `k_scale` the cache is int8 (K, and V
    when `v_scale` is given) and q runs the int8-QK route. Returns (out
    (Hq, G, D) in `out_dtype` (on CUDA a (G, Hq, D)-major view, so
    `.transpose(0, 1)` is contiguous for the o-projection), lse (Hq, G) f32
    in natural log, NEG_INF for a row that sees no slot, or None)."""
    hq, g, d = q.shape
    hkv, cap, _ = k_layer.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    reach = length + g if causal else length
    if length < 0 or reach > cap:
        raise ValueError(
            f"length {length} (+ group {g} in causal mode) exceeds cache "
            f"capacity {cap}"
        )
    if v_scale is not None and k_scale is None:
        raise ValueError("v_scale without k_scale: int8 V needs int8 K")
    out_dtype = out_dtype or q.dtype
    quant = k_scale is not None
    mode = dict(causal=causal, with_lse=with_lse, out_dtype=out_dtype)
    if q.device.type == "cpu":
        if quant:
            q8, qs = quantize_q(q, scale)
            return cache_attention_int8(
                q8, qs, k_layer, k_scale, v_layer, v_scale, length, q.dtype,
                **mode,
            )
        return cache_attention(q, k_layer, v_layer, length, scale, **mode)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash kernel takes bf16 q, got {q.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash kernel writes bf16 or f32, not {out_dtype}")
    if q.shape[-1] != HEAD_DIM or q.stride(-1) != 1:
        raise ValueError(
            f"flash kernel needs head dim {HEAD_DIM} contiguous, got q "
            f"shape {tuple(q.shape)} strides {q.stride()}"
        )
    _check_rows("k", k_layer, torch.int8 if quant else torch.bfloat16, q.device)
    v_dtype = torch.int8 if v_scale is not None else torch.bfloat16
    _check_rows("v", v_layer, v_dtype, q.device)
    if quant:
        _check_scales("k_scale", k_scale, k_layer)
        if v_scale is not None:
            _check_scales("v_scale", v_scale, v_layer)
        q8, qs = quantize_q(q, scale)
        qs = qs.contiguous()
        q_in = q8  # 4-byte fragment loads of int8 rows (decode)
        if q8.stride(0) % 4 or q8.stride(1) % 4 or q8.data_ptr() % 4:
            raise ValueError("int8 q rows are not 4-byte aligned")
    else:
        q_in = q
        if q.stride(0) % 2 or q.stride(1) % 2 or q.data_ptr() % 4:
            raise ValueError("q rows are not 4-byte aligned")
    variant = ("int8" if v_scale is not None else "int8k") if quant else "bf16"
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = _plan(g, hq, hkv, length, cap, causal, sms, variant)
    n_split = plan.n_split
    prefill = plan.kernel != "decode"
    step = 16 // q_in.element_size()
    if prefill and (q_in.stride(0) % step or q_in.stride(1) % step
                    or q_in.data_ptr() % 16):
        raise ValueError("q rows are not 16-byte aligned (the prefill "
                         "kernel stages them with 16-byte copies)")
    out = torch.empty(g, hq, d, dtype=out_dtype, device=q.device).transpose(0, 1)
    lse = (torch.empty(hq, g, dtype=torch.float32, device=q.device)
           if with_lse else None)
    part_o = part_ml = None
    if n_split > 1:
        part_o = torch.empty(
            n_split, hq, g, d, dtype=torch.float32, device=q.device
        )
        part_ml = torch.empty(
            n_split, hq, g, 2, dtype=torch.float32, device=q.device
        )
    lib = _build.library()
    args = (
        q_in.data_ptr(), qs.data_ptr() if quant else None,
        k_layer.data_ptr(), k_scale.data_ptr() if quant else None,
        v_layer.data_ptr(),
        v_scale.data_ptr() if v_scale is not None else None,
        out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        part_o.data_ptr() if part_o is not None else None,
        part_ml.data_ptr() if part_ml is not None else None,
        q_in.stride(0), q_in.stride(1), k_layer.stride(0), k_layer.stride(1),
        v_layer.stride(0), v_layer.stride(1), out.stride(0), out.stride(1),
        lse.stride(0) if lse is not None else 0,
        lse.stride(1) if lse is not None else 0,
        k_scale.stride(0) if quant else 0,
        v_scale.stride(0) if v_scale is not None else 0,
        hq, hkv, g, int(length), cap, n_split, int(not causal),
        int(with_lse), int(out_dtype == torch.float32), float(scale),
    )
    stream = torch.cuda.current_stream(q.device).cuda_stream
    entry = lib.qv_flash_prefill if prefill else lib.qv_flash_decode
    err = entry(*args, stream)
    _build.check(err, f"flash_past_attention ({variant}, {plan.kernel})")
    flash_past_attention.launches += 1
    flash_past_attention.kernel_launches[plan.kernel] += 1
    flash_past_attention.variant_launches[variant] += 1
    mode = ("unified" if causal else "past") + ("+lse" if with_lse else "")
    flash_past_attention.mode_launches[variant, mode] += 1
    return out, lse


def reset_launch_counts() -> None:
    flash_past_attention.launches = 0
    for variant in flash_past_attention.variant_launches:
        flash_past_attention.variant_launches[variant] = 0
    flash_past_attention.mode_launches.clear()
    flash_past_attention.kernel_launches.clear()


flash_past_attention.launches = 0
flash_past_attention.variant_launches = {"bf16": 0, "int8": 0, "int8k": 0}
flash_past_attention.mode_launches = collections.Counter()
flash_past_attention.kernel_launches = collections.Counter()
