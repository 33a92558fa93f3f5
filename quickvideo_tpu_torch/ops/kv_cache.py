"""Preallocated, stacked KV cache: bf16 (the compute dtype), int8 K and V,
or int8 K only.

Counterpart of quickvideo_tpu/ops/kv_cache.py. K and V are
(L, Hkv, capacity, D) tensors allocated once per request; appends write in
place into layer `li` at slot `start` (`k_all[li]` is a view, so nothing is
copied). Per-layer valid lengths are host ints: every append size of the
slice is known on the host, so reading a length never waits for the device.
Keys are stored with rotary already applied, as in the JAX package.

Quantized caches (`init_cache(quantized=True | "k")`) hold int8 codes with
one f32 scale per (layer, head, token) row, (L, Hkv, capacity): K and V
("int8" cache dtype), or K only with V in the compute dtype ("int8k").
Appends quantize the rows they write (`quantize_kv`, the JAX rounding
points).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from quickvideo_tpu_torch.ops.quantization import _div127

KV_EPS = 1e-8  # smallest row scale (applied after the division by 127)


def quantize_kv(x: torch.Tensor):
    """Per-(head, token) symmetric int8 of K or V rows: x (H, n, D) ->
    (int8 codes (H, n, D), f32 scales (H, n)). scale = max(absmax / 127,
    1e-8), codes = clip(round(x / scale)) with ties to even."""
    xf = x.float()
    scale = torch.clamp(_div127(xf.abs().amax(dim=-1)), min=KV_EPS)
    q = torch.round(xf / scale.unsqueeze(-1)).clamp_(-127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale.unsqueeze(-1)).to(dtype)


@dataclass
class KVCache:
    k: torch.Tensor  # (L, Hkv, capacity, D): compute dtype, or int8
    v: torch.Tensor
    lengths: List[int]  # valid slots per layer (host ints)
    k_scale: Optional[torch.Tensor] = None  # (L, Hkv, capacity) f32 if int8
    v_scale: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self):
        """False, True (int8 K and V) or "k" (int8 K only), as recorded by
        the scale tensors."""
        if self.k_scale is None:
            return False
        return True if self.v_scale is not None else "k"


def init_cache(
    num_layers: int,
    num_kv_heads: int,
    capacity: int,
    head_dim: int,
    dtype=torch.bfloat16,
    device="cpu",
    quantized=False,  # False | True / "kv" (int8 K and V) | "k" (int8 K)
) -> KVCache:
    if quantized not in (False, True, "kv", "k"):
        raise ValueError(f"unknown KV quant mode {quantized!r}")
    shape = (num_layers, num_kv_heads, capacity, head_dim)
    qk = quantized is not False
    qv = quantized in (True, "kv")

    def scales(on):
        return (torch.zeros(shape[:3], dtype=torch.float32, device=device)
                if on else None)

    return KVCache(
        k=torch.zeros(shape, dtype=torch.int8 if qk else dtype, device=device),
        v=torch.zeros(shape, dtype=torch.int8 if qv else dtype, device=device),
        lengths=[0] * num_layers,
        k_scale=scales(qk),
        v_scale=scales(qv),
    )


def stacked_append(
    cache: KVCache, li: int, start: int, k_new: torch.Tensor,
    v_new: torch.Tensor,
) -> None:
    """Write k_new/v_new (Hkv, n, D) into layer `li` at slots
    [start, start + n), in place, quantized where the cache is. The caller
    advances `cache.lengths`."""
    n = k_new.shape[1]
    if start < 0 or start + n > cache.capacity:
        raise ValueError(
            f"append of {n} rows at {start} overflows capacity "
            f"{cache.capacity}"
        )
    rows = slice(start, start + n)
    for new, buf, scale in ((k_new, cache.k, cache.k_scale),
                            (v_new, cache.v, cache.v_scale)):
        if scale is None:
            buf[li, :, rows].copy_(new)
        else:
            q, s = quantize_kv(new)
            buf[li, :, rows].copy_(q)
            scale[li, :, rows].copy_(s)
