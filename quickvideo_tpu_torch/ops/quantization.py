"""int8 weights and activations: per-channel symmetric weights, per-row
dynamic activations.

Counterpart of quickvideo_tpu/ops/quantization.py, following its code at
its default switches. A quantized weight is a dict {"q8": int8 (in, out),
"sc": f32 (out,)}: one scale per OUTPUT channel, so x @ W == (x @ Q) * sc.
The embedding table is quantized per row ({"q8": (V, C), "sc": (V,)}).
Norms and biases stay in the model dtype.

Layout: a matmul weight's q8 is the (in, out) view of an (out, in)
row-major tensor (`q8.t()` is contiguous). That is the layout int8 tensor
cores read B in (column-major, K contiguous): `torch._int_mm` takes it as
its second operand, and so do kernels B3/B4/B6 (ops/fused_vision_mlp.py).

Activation quantization runs on every `qdot` / `qdot_multi` whose input has
at least ACT_MIN_DIM columns and ACT_MIN_ROWS rows; smaller products are
weight-only (`x @ q8 * sc` with f32 accumulation), and so is a product
called with `act_quant=False` (the vision tower's, but its MLP: the JAX
package's `qdot_vision` default). Both gates are module
constants read at call time, so a test can lower them. A caller that
stands for the JAX package's padded bucket (the final prefill, whose
bucket always has at least 32 rows) passes `min_rows=0`.

The int8 products go to `torch._int_mm` (s8 x s8 -> s32, exact): the JAX
package left them to XLA, not to a Pallas kernel. On CUDA it needs more
than 16 rows, so `int_mm` pads fewer rows with zeros.

Under tensor parallelism a row-split product (wo, wd) sees only its tp
rank's slice of each activation row. `group` (the tp process group) makes
`quantize_act` take each row's max over the whole row (an all-reduce max),
so every rank quantizes with the scale one device would use, and the gates
count the whole row's width.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from quickvideo_tpu_torch.parallel.comm import all_reduce_max, group_size

EPS = 1e-8
ACT_MIN_DIM = 256
ACT_MIN_ROWS = 16

LANG_LAYER_KEYS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")
VIS_BLOCK_KEYS = ("wqkv", "wo", "wg", "wu", "wd")


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q8" in w


def col_major(t: torch.Tensor) -> torch.Tensor:
    """The same (in, out) values stored as a row-major (out, in) tensor."""
    return t.t().contiguous().t()


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 rounded once, as the JAX package divides. (On CUDA, torch
    turns a division by a Python scalar into a multiply by its reciprocal,
    which can land one ulp off and flip int8 codes; a 0-dim tensor on the
    same device divides.)"""
    return t / t.new_full((), 127.0)


def quantize_weight(w: torch.Tensor, contract_axis: int = -2) -> dict:
    """Symmetric int8 with one f32 scale per output channel. w: (in, out)
    for matmul weights (contract_axis=-2), or (V, C) for the embedding
    table with per-row scales (contract_axis=-1)."""
    wf = w.float()
    amax = wf.abs().amax(dim=contract_axis)
    sc = _div127(torch.clamp(amax, min=EPS))
    q = torch.round(wf / sc.unsqueeze(contract_axis))
    del wf
    q8 = q.clamp_(-127, 127).to(torch.int8)
    if contract_axis in (-2, q8.ndim - 2):
        q8 = col_major(q8)
    return {"q8": q8, "sc": sc}


def dequantize_weight(w: dict, contract_axis: int = -2,
                      dtype=torch.float32) -> torch.Tensor:
    return (w["q8"].float() * w["sc"].unsqueeze(contract_axis)).to(dtype)


def quantize_act(x: torch.Tensor, group=None):
    """Per-row symmetric int8: (xq int8 (..., K), xs f32 (..., 1)). With a
    process group, x holds one rank's slice of each row and the row max is
    reduced over the group first."""
    xf = x.float()
    amax = all_reduce_max(xf.abs().amax(dim=-1, keepdim=True), group)
    xs = _div127(torch.clamp(amax, min=EPS))
    xq = torch.round(xf / xs).clamp_(-127, 127).to(torch.int8)
    return xq, xs


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact. On CUDA,
    `torch._int_mm` takes only M > 16 and K, N multiples of 8: fewer rows,
    and K or N off the multiple (the vision MLP's 3420), are padded with
    zeros, which add nothing to the sums."""
    if not a.is_cuda:
        return torch._int_mm(a, b)
    (m, k), n = a.shape, b.shape[1]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        # keep b column-major, (N, K) row-major storage
        b = torch.nn.functional.pad(b.t(), (0, kp - k, 0, np_ - n)).t()
    y = torch._int_mm(a, b)
    return y if (mp, np_) == (m, n) else y[:m, :n]


def qdot_pre(xq: torch.Tensor, xs: torch.Tensor, w: dict) -> torch.Tensor:
    """int8 x int8 product of a pre-quantized activation against a
    quantized weight; (acc * xs) * sc in f32."""
    y = int_mm(xq.reshape(-1, xq.shape[-1]), w["q8"])
    y = y.reshape(*xq.shape[:-1], y.shape[-1])
    return y.float() * xs * w["sc"]


def mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 accumulation and an f32 result (JAX's
    preferred_element_type=f32): the product is not rounded to x's dtype."""
    if x.dtype == torch.float32:
        return x @ w.to(torch.float32)
    if x.is_cuda:
        x2 = x.reshape(-1, x.shape[-1])
        y = torch.mm(x2, w.to(x.dtype), out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    return x.float() @ w.float()


def _act_gate(x: torch.Tensor, min_rows: Optional[int], group=None) -> bool:
    rows = ACT_MIN_ROWS if min_rows is None else min_rows
    return (x.ndim >= 2 and x.shape[-1] * group_size(group) >= ACT_MIN_DIM
            and x.shape[-2] >= rows)


def qdot(x: torch.Tensor, w, *, min_rows: Optional[int] = None,
         act_quant: bool = True, group=None) -> torch.Tensor:
    """x @ w with f32 accumulation, returned in f32; `w` may be quantized.
    Quantized: per-row act-quant when `act_quant` and the gates pass, else
    weight-only. `group`: x is a tp rank's slice of the contraction (module
    docstring); the result is this rank's partial product."""
    if not is_quantized(w):
        return mm_f32(x, w)
    if act_quant and _act_gate(x, min_rows, group):
        return qdot_pre(*quantize_act(x, group), w)
    return mm_f32(x, w["q8"]) * w["sc"]


def qdot_multi(x: torch.Tensor, ws: Sequence, *,
               min_rows: Optional[int] = None) -> List[torch.Tensor]:
    """Several products of one activation (q/k/v, gate/up): x is quantized
    once for all of them."""
    if _act_gate(x, min_rows) and all(is_quantized(w) for w in ws):
        xq, xs = quantize_act(x)
        return [qdot_pre(xq, xs, w) for w in ws]
    return [qdot(x, w, min_rows=min_rows) for w in ws]


def linear(x: torch.Tensor, w, dtype=None, *,
           min_rows: Optional[int] = None,
           act_quant: bool = True) -> torch.Tensor:
    """`qdot(x, w)` cast to `dtype` (default x's), the JAX package's
    `qdot(x, w).astype(dtype)`. With a float weight of that dtype this is
    one `x @ w`: the same f32 accumulation, rounded once."""
    dtype = dtype or x.dtype
    if not is_quantized(w) and x.dtype == w.dtype == dtype:
        return x @ w
    return qdot(x, w, min_rows=min_rows, act_quant=act_quant).to(dtype)


def linear_multi(x: torch.Tensor, ws: Sequence, dtype=None, *,
                 min_rows: Optional[int] = None) -> List[torch.Tensor]:
    dtype = dtype or x.dtype
    if not any(is_quantized(w) for w in ws):
        return [linear(x, w, dtype) for w in ws]
    return [y.to(dtype) for y in qdot_multi(x, ws, min_rows=min_rows)]


def qtake(w, token_ids: torch.Tensor, dtype) -> torch.Tensor:
    """Embedding lookup; `w` may be quantized per row."""
    if not is_quantized(w):
        return w.index_select(0, token_ids)
    rows = w["q8"].index_select(0, token_ids).float()
    sc = w["sc"].index_select(0, token_ids)
    return (rows * sc[:, None]).to(dtype)


# -- whole-model quantization ------------------------------------------------


def _quantize_keys(d: dict, keys, contract_axis: int = -2) -> None:
    for k in keys:
        if k in d and not is_quantized(d[k]):
            d[k] = quantize_weight(d.pop(k), contract_axis)


def quantize_language_params(p: dict) -> dict:
    """Quantizes `embed` (per row), `lm_head` and every layer's matrices IN
    PLACE, leaf by leaf: each float leaf is dropped as its int8 copy is
    made, so a caller that holds no other reference never has two copies
    of the tree. Leaves already quantized are kept. Returns `p`."""
    _quantize_keys(p, ("embed",), contract_axis=-1)
    _quantize_keys(p, ("lm_head",))
    for lp in p["layers"]:
        _quantize_keys(lp, LANG_LAYER_KEYS)
    return p


def quantize_vision_params(p: dict) -> dict:
    """`patch_embed`, every block's matrices and the merger's two, IN
    PLACE (see quantize_language_params). Returns `p`."""
    _quantize_keys(p, ("patch_embed",))
    for bp in p["blocks"]:
        _quantize_keys(bp, VIS_BLOCK_KEYS)
    _quantize_keys(p["merger"], ("w1", "w2"))
    return p


def quantize_model_params(params: dict) -> dict:
    """{"language", "vision"} -> the same tree with its large matrices
    quantized, in place. Callers must not reuse float leaves of `params`."""
    if "language" in params:
        quantize_language_params(params["language"])
    if "vision" in params:
        quantize_vision_params(params["vision"])
    return params
