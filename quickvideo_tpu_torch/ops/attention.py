"""Plain PyTorch attention functions (f32 math).

Counterpart of quickvideo_tpu/ops/attention.py for the port's one attention
path. `unified_causal_attention` (bf16 or f32 cache) and
`unified_causal_attention_int8` (int8 K, with int8 or compute-dtype V) are
the plain versions of kernel B1 (ops/flash_attention.py): the CPU path runs
them, and the tests and chip_smoke.py hold the CUDA kernel against them.
"""

from __future__ import annotations

from typing import Optional

import torch

from quickvideo_tpu_torch.ops.quantization import _div127

LOG2E = 1.4426950408889634
Q_EPS = 1e-20  # smallest |q| row max (applied before the division by 127)


def unified_causal_attention(
    q: torch.Tensor,  # (Hq, G, D) rotary-applied group queries
    k_layer: torch.Tensor,  # (Hkv, cap, D) one layer of the stacked cache
    v_layer: torch.Tensor,
    length: int,  # valid slots before the group; the group sits at
    # [length, length + G) of the layer already
    scale: float,
) -> torch.Tensor:
    """Row i of the group attends slots [0, length + i], with GQA (query
    head h reads kv head h // rep). Scores, softmax and the weighted sum run
    in f32; returns (Hq, G, D) in q's dtype."""
    hq, g, d = q.shape
    hkv = k_layer.shape[0]
    rep = hq // hkv
    n = length + g
    k = k_layer[:, :n].float()
    v = v_layer[:, :n].float()
    qf = q.float().reshape(hkv, rep, g, d)
    s = torch.einsum("hrgd,hnd->hrgn", qf, k) * scale
    s = s.masked_fill(_future(g, n, length, q.device), float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("hrgn,hnd->hrgd", p, v)
    return out.reshape(hq, g, d).to(q.dtype)


def _future(g: int, n: int, length: int, device) -> torch.Tensor:
    """(G, n) True where slot col lies after row i's last slot length + i."""
    rows = torch.arange(g, device=device)
    cols = torch.arange(n, device=device)
    return cols[None, :] > rows[:, None] + length


def quantize_q(q: torch.Tensor, scale: float):
    """B1's int8-QK query quantization (the JAX wrapper's, at
    quickvideo_tpu/ops/flash_attention.py:304-312): q is pre-scaled in f32
    by scale * log2(e), then quantized per (head, row) with
    qs = max(max|q|, 1e-20) / 127. Returns (q8 int8 (Hq, G, D), qs f32
    (Hq, G)); qs * ks puts the scores in log2 units."""
    qf = q.float()
    qf = qf * qf.new_full((), scale * LOG2E)
    qs = _div127(torch.clamp(qf.abs().amax(dim=-1), min=Q_EPS))
    q8 = torch.round(qf / qs.unsqueeze(-1)).clamp_(-127, 127)
    return q8.to(torch.int8), qs


def unified_causal_attention_int8(
    q8: torch.Tensor,  # (Hq, G, D) int8 from quantize_q
    qs: torch.Tensor,  # (Hq, G) f32
    k_layer: torch.Tensor,  # (Hkv, cap, D) int8
    k_scale: torch.Tensor,  # (Hkv, cap) f32
    v_layer: torch.Tensor,  # (Hkv, cap, D) int8, or the compute dtype
    v_scale: Optional[torch.Tensor],  # (Hkv, cap) f32 with int8 V, or None
    length: int,
    out_dtype: torch.dtype,  # the activation dtype; PV runs in it
) -> torch.Tensor:
    """B1's int8-QK modes, at the JAX kernel's rounding points: scores are
    the exact int32 products times qs[row] times ks[col] (log2 units),
    p = exp2(s - m) in f32 and its f32 sum is the denominator; the PV
    operand is p * vs[col] (int8 V) or p, rounded to `out_dtype`, against V
    in `out_dtype` (int8 codes convert exactly), accumulated in f32; the
    output is acc / max(sum, 1e-30). Returns (Hq, G, D) in `out_dtype`.

    One kv head at a time, in place where it can: the (rep, G, n) f32
    score tile of the 7B's group step over 57k slots is 5.8 GB."""
    hq, g, d = q8.shape
    hkv = k_layer.shape[0]
    rep = hq // hkv
    n = length + g
    future = _future(g, n, length, q8.device)
    q8 = q8.reshape(hkv, rep, g, d)
    qs = qs.reshape(hkv, rep, g, 1)
    out = torch.empty(hkv, rep, g, d, dtype=out_dtype, device=q8.device)
    for h in range(hkv):
        # |q8 . k8| <= 127 * 127 * D < 2^24: the f32 product is the exact
        # int32 one
        s = q8[h].float() @ k_layer[h, :n].float().t()
        s.mul_(qs[h]).mul_(k_scale[h, :n])
        s.masked_fill_(future, float("-inf"))
        p = torch.exp2(s.sub_(s.amax(dim=-1, keepdim=True)), out=s)
        denom = p.sum(dim=-1, keepdim=True)
        if v_scale is not None:
            p.mul_(v_scale[h, :n])
        pv = p.to(out_dtype).float()
        del s, p
        acc = pv @ v_layer[h, :n].to(out_dtype).float()
        out[h] = acc.div_(torch.clamp(denom, min=1e-30)).to(out_dtype)
    return out.reshape(hq, g, d)
