"""Plain PyTorch attention functions (f32 math).

Counterpart of quickvideo_tpu/ops/attention.py.

`cache_attention` (bf16 or f32 cache) and `cache_attention_int8` (int8 K,
with int8 or compute-dtype V) are the plain versions of kernel B1
(ops/flash_attention.py) in each of its modes: unified causal (row i of the
group attends slots [0, length + i]) or pure past (every row attends
[0, length)), with or without the log-sum-exp. The CPU path runs them, and
the tests and chip_smoke.py hold the CUDA kernel against them.

The rest are the JAX package's XLA-side functions that the pruning modes
need: `_partial_attention` (masked attention returning out and lse),
`merge_partials`, `past_partial_attention` (the cache side of the
query-based mode: B1 pure past with lse and f32 output),
`grouped_attention` over the group alone (adaptive_local_attention=False)
and `group_probs_from_lse`, the head-averaged in-group probabilities the
attention-statistics predictors read. Each loops over kv heads: one f32
score tile of all 28 heads of the 7B's group step is 1.45 GB.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from quickvideo_tpu_torch.ops.quantization import _div127

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INF = -1e30  # lse of a row that sees no key
Q_EPS = 1e-20  # smallest |q| row max (applied before the division by 127)


def causal_mask(g: int, device=None) -> torch.Tensor:
    """(G, G) True where column <= row."""
    idx = torch.arange(g, device=device)
    return idx[None, :] <= idx[:, None]


class PartialAttn(NamedTuple):
    """A normalized softmax partial: `out` (Hq, Q, D) f32 over this
    partial's keys and the log-sum-exp `lse` (Hq, Q) f32 of its scores. A
    row with no attendable key has out 0 and lse NEG_INF."""

    out: torch.Tensor
    lse: torch.Tensor


def _future(g: int, n: int, length: int, device) -> torch.Tensor:
    """(G, n) True where slot col lies after row i's last slot length + i."""
    rows = torch.arange(g, device=device)
    cols = torch.arange(n, device=device)
    return cols[None, :] > rows[:, None] + length


def _finish(acc, denom, m_nat, with_lse):
    """acc / max(denom, 1e-30), and lse = m + log(denom) (NEG_INF where
    denom == 0) from the natural-log row max m."""
    out = acc / torch.clamp(denom, min=1e-30)
    if not with_lse:
        return out, None
    lse = torch.where(
        denom > 0, m_nat + torch.log(torch.clamp(denom, min=1e-30)),
        torch.full_like(denom, NEG_INF),
    )
    return out, lse[..., 0]


def cache_attention(
    q: torch.Tensor,  # (Hq, G, D) rotary-applied queries
    k_layer: torch.Tensor,  # (Hkv, cap, D) one layer of the stacked cache
    v_layer: torch.Tensor,
    length: int,  # valid slots before the group
    scale: float,
    *,
    causal: bool = True,  # unified causal; False = pure past
    with_lse: bool = False,
    out_dtype: Optional[torch.dtype] = None,  # default q's dtype
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """B1's plain version on a bf16 / f32 cache. Unified causal: the group
    sits at [length, length + G) of the layer already and row i attends
    [0, length + i]. Pure past: every row attends [0, length). GQA: query
    head h reads kv head h // rep. Scores, softmax and the weighted sum run
    in f32. Returns (out (Hq, G, D) in `out_dtype`, lse (Hq, G) f32 in
    natural log or None)."""
    hq, g, d = q.shape
    hkv = k_layer.shape[0]
    rep = hq // hkv
    n = length + g if causal else length
    dev = q.device
    out = torch.zeros(hkv, rep, g, d, dtype=out_dtype or q.dtype, device=dev)
    lse = (torch.full((hkv, rep, g), NEG_INF, device=dev) if with_lse
           else None)
    if n == 0:  # pure past over an empty cache
        return out.reshape(hq, g, d), _flat(lse, hq, g)
    future = _future(g, n, length, dev) if causal else None
    qf = q.float().reshape(hkv, rep, g, d)
    for h in range(hkv):
        s = (qf[h] @ k_layer[h, :n].float().t()) * scale
        if future is not None:
            s.masked_fill_(future, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s.sub_(m), out=s)
        denom = p.sum(dim=-1, keepdim=True)
        o, l = _finish(p @ v_layer[h, :n].float(), denom, m, with_lse)
        out[h] = o.to(out.dtype)
        if with_lse:
            lse[h] = l
    return out.reshape(hq, g, d), _flat(lse, hq, g)


def _flat(lse, hq, g):
    return None if lse is None else lse.reshape(hq, g)


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


def cache_attention_int8(
    q8: torch.Tensor,  # (Hq, G, D) int8 from quantize_q
    qs: torch.Tensor,  # (Hq, G) f32
    k_layer: torch.Tensor,  # (Hkv, cap, D) int8
    k_scale: torch.Tensor,  # (Hkv, cap) f32
    v_layer: torch.Tensor,  # (Hkv, cap, D) int8, or the compute dtype
    v_scale: Optional[torch.Tensor],  # (Hkv, cap) f32 with int8 V, or None
    length: int,
    pv_dtype: torch.dtype,  # the activation dtype; PV runs in it
    *,
    causal: bool = True,
    with_lse: bool = False,
    out_dtype: Optional[torch.dtype] = None,  # default pv_dtype
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """B1's int8-QK modes, at the JAX kernel's rounding points: scores are
    the exact int32 products times qs[row] times ks[col] (log2 units),
    p = exp2(s - m) in f32 and its f32 sum is the denominator; the PV
    operand is p * vs[col] (int8 V) or p, rounded to `pv_dtype`, against V
    in `pv_dtype` (int8 codes convert exactly), accumulated in f32; the
    output is acc / max(sum, 1e-30), and lse = m ln 2 + ln(sum). Rows as
    in `cache_attention`. Returns (out (Hq, G, D), lse (Hq, G) or None).

    One kv head at a time, in place where it can: the (rep, G, n) f32
    score tile of the 7B's group step over 57k slots is 5.8 GB."""
    hq, g, d = q8.shape
    hkv = k_layer.shape[0]
    rep = hq // hkv
    n = length + g if causal else length
    dev = q8.device
    out = torch.zeros(hkv, rep, g, d, dtype=out_dtype or pv_dtype, device=dev)
    lse = (torch.full((hkv, rep, g), NEG_INF, device=dev) if with_lse
           else None)
    if n == 0:
        return out.reshape(hq, g, d), _flat(lse, hq, g)
    future = _future(g, n, length, dev) if causal else None
    q8 = q8.reshape(hkv, rep, g, d)
    qs = qs.reshape(hkv, rep, g, 1)
    for h in range(hkv):
        # |q8 . k8| <= 127 * 127 * D < 2^24: the f32 product is the exact
        # int32 one
        s = q8[h].float() @ k_layer[h, :n].float().t()
        s.mul_(qs[h]).mul_(k_scale[h, :n])
        if future is not None:
            s.masked_fill_(future, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s.sub_(m), out=s)
        denom = p.sum(dim=-1, keepdim=True)
        if v_scale is not None:
            p.mul_(v_scale[h, :n])
        pv = p.to(pv_dtype).float()
        del s, p
        acc = pv @ v_layer[h, :n].to(pv_dtype).float()
        o, l = _finish(acc, denom, m * LN2, with_lse)
        out[h] = o.to(out.dtype)
        if with_lse:
            lse[h] = l
    return out.reshape(hq, g, d), _flat(lse, hq, g)


# -- the JAX package's XLA-side functions ------------------------------------


def _partial_attention(
    q: torch.Tensor,  # (Hq, Q, D)
    k: torch.Tensor,  # (Hkv, L, D)
    v: torch.Tensor,
    mask: Optional[torch.Tensor],  # (Q, L) bool, True = attend
    scale: float,
) -> PartialAttn:
    """Masked attention of q over k/v in f32: out and lse (rows that see
    nothing: out 0, lse NEG_INF), quickvideo_tpu/ops/attention.py:53-74."""
    hkv = k.shape[0]
    hq, ql, d = q.shape
    rep = hq // hkv
    qf = q.float().reshape(hkv, rep, ql, d)
    out = torch.empty(hkv, rep, ql, d, device=q.device)
    lse = torch.empty(hkv, rep, ql, device=q.device)
    for h in range(hkv):
        s = (qf[h] @ k[h].float().t()) * scale
        if mask is not None:
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m = torch.clamp(s.amax(dim=-1, keepdim=True), min=-1e29)
        p = torch.exp(s - m)
        if mask is not None:
            p = torch.where(mask, p, torch.zeros_like(p))
        denom = p.sum(dim=-1, keepdim=True)
        out[h], lse[h] = _finish(p @ v[h].float(), denom, m, True)
    return PartialAttn(out.reshape(hq, ql, d), lse.reshape(hq, ql))


def merge_partials(a: PartialAttn, b: PartialAttn):
    """Exact combine of two normalized softmax partials. Returns (out
    (Hq, Q, D) f32, total lse (Hq, Q))."""
    m = torch.clamp(torch.maximum(a.lse, b.lse), min=-1e29)
    wa = torch.exp(a.lse - m)
    wb = torch.exp(b.lse - m)
    denom = torch.clamp(wa + wb, min=1e-30)
    out = (a.out * wa[..., None] + b.out * wb[..., None]) / denom[..., None]
    return out, m + torch.log(denom)


def past_partial_attention(
    q: torch.Tensor,  # (Hq, Q, D)
    k_layer: torch.Tensor,  # (Hkv, cap, D) one layer of the stacked cache
    v_layer: torch.Tensor,
    length: int,
    scale: float,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> PartialAttn:
    """Every row of q over the cache's valid slots [0, length): kernel B1 in
    pure-past mode with lse and f32 output (the JAX package's 'pallas'
    route, quickvideo_tpu/ops/attention.py:191-203), int8 caches included
    (q then runs the int8-QK route)."""
    from quickvideo_tpu_torch.ops.flash_attention import flash_past_attention

    out, lse = flash_past_attention(
        q, k_layer, v_layer, length, scale, k_scale=k_scale, v_scale=v_scale,
        causal=False, with_lse=True, out_dtype=torch.float32,
    )
    return PartialAttn(out, lse)


def group_probs_from_lse(
    q: torch.Tensor,  # (Hq, G, D) rotary-applied group queries
    k_grp: torch.Tensor,  # (Hkv, G, D) raw group keys
    lse: torch.Tensor,  # (Hq, G) log-sum-exp over everything the rows saw
    scale: float,
) -> torch.Tensor:
    """In-group probabilities under the full softmax denominator, recovered
    from the attention's lse: prob[q, j] = exp(q . k_j * scale - lse[q]),
    averaged over query heads, zero above the diagonal -> (G, G) f32
    (quickvideo_tpu/models/qwen25_vl/language.py:215-241)."""
    hq, g, d = q.shape
    hkv = k_grp.shape[0]
    rep = hq // hkv
    qf = q.float().reshape(hkv, rep, g, d)
    lf = lse.float().reshape(hkv, rep, g, 1)
    total = torch.zeros(g, g, device=q.device)
    for h in range(hkv):
        s = (qf[h] @ k_grp[h].float().t()) * scale
        total += torch.exp(s.sub_(lf[h]), out=s).sum(dim=0)
    total.masked_fill_(~causal_mask(g, q.device), 0.0)
    return total / hq


def grouped_attention(
    q: torch.Tensor,  # (Hq, G, D)
    k_group: torch.Tensor,  # (Hkv, G, D)
    v_group: torch.Tensor,
    *,
    scale: float,
    return_group_probs: bool = False,
):
    """The group over itself only, causally (no past:
    adaptive_local_attention=False). Returns (out (Hq, G, D) f32, (G, G)
    head-averaged probs or None)."""
    pg = _partial_attention(q, k_group, v_group,
                            causal_mask(q.shape[1], q.device), scale)
    if not return_group_probs:
        return pg.out, None
    return pg.out, group_probs_from_lse(q, k_group, pg.lse, scale)
