"""Operations and bytes of one request, from its shapes alone.

The benchmark's own count of the work a request needs (two operations a
multiply-add), whatever kernel the program runs it on:

  vision     per group of S patches: the patch embedding, per block the
             QKV, output and gated-MLP products and the attention over each
             window (or, in the full-attention blocks, each frame), and
             the merger's two products
  groups     per group step of G rows over a past of P retained slots, in
             every layer: the QKV, output and MLP products of G rows, and
             attention over the P slots and the group's causal triangle
  final      the question's rows over the retained past, and the logits of
             its last row
  decode     each further token: one row through every layer over the
             cache, and its logits

Products of weights that the configuration states in int8 count at the
int8 peak, the rest (attention, and every product of a bf16
configuration) at the bf16 peak.
"""

from __future__ import annotations

from typing import Dict, List

from qvbench.roofline import bound, flash_bound, int8_gemm_bound


def _add(acc: Dict[str, float], kind: str, n: float) -> None:
    acc[kind] = acc.get(kind, 0.0) + float(n)


def window_sizes(spec, t: int, gh: int, gw: int) -> List[int]:
    """Patches of each attention window of a (t, gh, gw) patch grid: windows
    of `window / patch / merge` merge units a side, the last row and
    column of windows cut by the grid's edge."""
    v = spec.vision
    lh, lw = gh // v.merge, gw // v.merge
    edge = v.window // v.merge // v.patch
    unit = v.merge ** 2
    rows = [min(edge, lh - a) for a in range(0, lh, edge)]
    cols = [min(edge, lw - b) for b in range(0, lw, edge)]
    return [r * c * unit for r in rows for c in cols] * t


def vision_ops(spec, t: int, gh: int, gw: int, acc: Dict[str, float]):
    v = spec.vision
    w8 = "int8" if spec.int8_weights else "bf16"
    s = t * gh * gw
    c, i = v.hidden, v.intermediate
    _add(acc, w8, 2 * s * v.patch_dim * c)
    for bi in range(v.depth):
        _add(acc, w8, 2 * s * c * (3 * c + c + 3 * i))
        spans = ([gh * gw] * t if bi in v.fullatt
                 else window_sizes(spec, t, gh, gw))
        _add(acc, "bf16", 4 * c * sum(n * n for n in spans))
    md = c * v.merge ** 2
    _add(acc, w8, 2 * (s // v.merge ** 2) * md * (md + v.out_hidden))


def layer_ops(spec, rows: int, past: int, causal_rows: int,
              acc: Dict[str, float]):
    """One layer over `rows` new rows attending `past` slots and, causally,
    the last `causal_rows` of themselves."""
    t = spec.text
    w8 = "int8" if spec.int8_weights else "bf16"
    c, d = t.hidden, t.head_dim
    qkv = (t.heads + 2 * t.kv_heads) * d
    _add(acc, w8, 2 * rows * c * (qkv + t.heads * d + 3 * t.intermediate))
    pairs = rows * past + causal_rows * (causal_rows + 1) // 2
    _add(acc, "bf16", 4 * t.heads * d * pairs)


def request_ops(spec, mix, question: str, n_tokens: int) -> Dict[str, float]:
    """Operations by type of one request that served `n_tokens` tokens."""
    t = spec.text
    w8 = "int8" if spec.int8_weights else "bf16"
    acc: Dict[str, float] = {}
    h, w = int(mix.video["height"]), int(mix.video["width"])
    gh, gw = h // spec.vision.patch, w // spec.vision.patch
    for cnt in mix.group_frames(spec):
        vision_ops(spec, -(-cnt // spec.vision.temporal_patch), gh, gw, acc)
    past = 0
    for rows in mix.group_rows(spec, question):
        for _ in range(t.layers):
            layer_ops(spec, rows, past, rows, acc)
        past += mix.keep(rows)
    q = mix.suffix_len(spec, question)
    for _ in range(t.layers):
        layer_ops(spec, q, past, q, acc)
    _add(acc, w8, 2 * t.hidden * t.vocab)
    past += q
    for j in range(max(0, n_tokens - 1)):
        for _ in range(t.layers):
            layer_ops(spec, 1, past + j, 1, acc)
        _add(acc, w8, 2 * t.hidden * t.vocab)
    return acc


def b1_group_bound_s(spec, mix, question: str, variant: str) -> float:
    """B1's bound over a request's group steps: per group and layer, G
    rows over the retained past, unified causal (flash_bound)."""
    t = spec.text
    total, past = 0.0, 0
    for rows in mix.group_rows(spec, question):
        ms, _ = flash_bound(rows, past, variant, hq=t.heads, hkv=t.kv_heads,
                            d=t.head_dim)
        total += ms * t.layers
        past += mix.keep(rows)
    return total / 1e3


def vision_mlp_bounds_s(spec, rows: int):
    """(B3's, B4's) bound for one launch over `rows` patches: the int8 QKV
    product (bf16 in and out), and the gate and up products (bf16 in, int8
    codes and a row scale out)."""
    v = spec.vision
    b3, _ = int8_gemm_bound(rows, v.hidden, 3 * v.hidden)
    moved = (rows * v.hidden * 2 + v.hidden * 2 * v.intermediate
             + 4 * 2 * v.intermediate + rows * v.intermediate + 4 * rows)
    b4, _ = bound(moved, {"int8": 2 * rows * v.hidden * 2 * v.intermediate})
    return b3 / 1e3, b4 / 1e3
