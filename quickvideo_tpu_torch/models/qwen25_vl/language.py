"""Qwen2.5-VL language decoder in PyTorch: the grouped-prefill hot path.

Counterpart of quickvideo_tpu/models/qwen25_vl/language.py. Parameters are a
plain dict (see convert.py): weights keep the JAX layout (in, out) and are
applied as `x @ w`. Layers run as a Python loop; the stacked KV cache is
updated in place (ops/kv_cache.py).

The port has ONE attention path, the JAX package's unified "hot" path
(language.py:427-509 then :533-563): append the raw group's K/V to the cache,
run one unified-causal attention over [past | group] (kernel B1 on CUDA, its
plain version on CPU), o-project, select-and-compact the group's keys, and
overwrite the raw span with the compact one. With an int8 or int8k cache the
appends quantize and B1 runs its int8-QK variant (language.py:436-450,
486-502, 552-563). The query-based mode, cascade,
decay schedules, attention-statistics predictors, context parallelism and
tensor parallelism are not ported in this slice.

Every matrix product goes through ops/quantization.py, so a layer runs bf16
or int8 weights alike (the JAX package's qdot / qdot_multi / qtake call
sites). `min_rows` is the act-quant row gate: None is the default gate
(decode steps of one row stay weight-only), 0 acts for the final prefill,
which the JAX package runs as a padded bucket of at least 32 rows.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from quickvideo_tpu.models.qwen25_vl.config import TextConfig
from quickvideo_tpu_torch.models.qwen25_vl.rope import apply_rotary
from quickvideo_tpu_torch.ops import kv_cache as kv
from quickvideo_tpu_torch.ops import prune as prune_ops
from quickvideo_tpu_torch.ops.flash_attention import flash_past_attention
from quickvideo_tpu_torch.ops.quantization import (
    linear,
    linear_multi,
    qdot,
    qtake,
)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def swiglu_mlp(x: torch.Tensor, lp: dict,
               min_rows: Optional[int] = None) -> torch.Tensor:
    g, u = linear_multi(x, (lp["wg"], lp["wu"]), min_rows=min_rows)
    return linear(F.silu(g) * u, lp["wd"], min_rows=min_rows)


def _project_qkv(lp: dict, h: torch.Tensor, cfg: TextConfig,
                 min_rows: Optional[int] = None):
    """(L, C) -> q (Hq, L, D), k/v (Hkv, L, D), as strided views."""
    l = h.shape[0]
    hd = cfg.head_dim
    q, k, v = linear_multi(
        h, (lp["wq"], lp["wk"], lp["wv"]), min_rows=min_rows
    )
    q = (q + lp["bq"]).view(l, cfg.num_attention_heads, hd)
    k = (k + lp["bk"]).view(l, cfg.num_key_value_heads, hd)
    v = (v + lp["bv"]).view(l, cfg.num_key_value_heads, hd)
    return q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1)


def embed_tokens(params: dict, token_ids: torch.Tensor) -> torch.Tensor:
    return qtake(params["embed"], token_ids, params["norm"].dtype)


def compute_logits(
    params: dict, hidden: torch.Tensor, cfg: TextConfig
) -> torch.Tensor:
    """(C,) or (L, C) -> logits in f32 (the product is not rounded to the
    model dtype first, as in the JAX package)."""
    h = rms_norm(hidden, params["norm"], cfg.rms_norm_eps)
    return qdot(h, params["lm_head"])


def _layer(scales: Optional[torch.Tensor], li: int):
    return None if scales is None else scales[li]


def layer_step(
    lp: dict,
    x: torch.Tensor,  # (G, C)
    cos: torch.Tensor,  # (G, head_dim) f32
    sin: torch.Tensor,
    cache: kv.KVCache,
    li: int,
    cfg: TextConfig,
    keep_k: int = 0,  # retained tokens of this group (0 = keep all)
    predict_type: str = "key_norms_small",
    min_rows: Optional[int] = None,  # act-quant row gate (module docstring)
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One decoder layer over the current group. Writes the group's K/V (or
    its compact) into layer `li` of the cache at `cache.lengths[li]`; the
    caller advances the length. Returns (x_out, retained indices | None)."""
    length = cache.lengths[li]
    h = rms_norm(x, lp["ln1"], cfg.rms_norm_eps)
    q, k, v = _project_qkv(lp, h, cfg, min_rows)
    q, k = apply_rotary(q, k, cos, sin)
    # raw group at [length, length + G) (quantized where the cache is, so
    # the group attends its own K/V with the int8 rounding); attention over
    # [0, length + i]
    kv.stacked_append(cache, li, length, k, v)
    out = flash_past_attention(
        q, cache.k[li], cache.v[li], length, scale=cfg.head_dim ** -0.5,
        k_scale=_layer(cache.k_scale, li), v_scale=_layer(cache.v_scale, li),
    )
    g = x.shape[0]
    attn = out.transpose(0, 1).reshape(g, cfg.num_attention_heads * cfg.head_dim)
    x = x + linear(attn, lp["wo"], min_rows=min_rows)
    indices = None
    if keep_k > 0:
        # the raw rotary keys are scored; the kept raw rows are (re)quantized
        # into the compact, which overwrites the first keep_k raw slots; the
        # raw tail stays past the valid length, never attended
        res = prune_ops.select_and_compact(predict_type, keep_k, k, v)
        kv.stacked_append(cache, li, length, res.k_keep, res.v_keep)
        indices = res.indices
    x = x + swiglu_mlp(rms_norm(x, lp["ln2"], cfg.rms_norm_eps), lp, min_rows)
    return x, indices


def prefill_step(
    params: dict,
    cache: kv.KVCache,
    x: torch.Tensor,  # (G, C) input embeddings
    cos: torch.Tensor,  # (G, head_dim) merged mRoPE rows of these positions
    sin: torch.Tensor,
    cfg: TextConfig,
    keep_k: int = 0,
    predict_type: str = "key_norms_small",
    min_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]]]:
    """One group through all layers. Advances every layer's cache length by
    keep_k (or G when keep_k == 0). Returns (final hidden states (G, C),
    per-layer retained indices)."""
    append_n = keep_k if keep_k > 0 else x.shape[0]
    indices = []
    for li, lp in enumerate(params["layers"]):
        x, idx = layer_step(
            lp, x, cos, sin, cache, li, cfg, keep_k, predict_type, min_rows
        )
        cache.lengths[li] += append_n
        indices.append(idx)
    return x, indices


def decode_step(
    params: dict,
    cache: kv.KVCache,
    token_id: torch.Tensor,  # (1,) int64 on the device
    cos: torch.Tensor,  # (1, head_dim)
    sin: torch.Tensor,
    cfg: TextConfig,
) -> torch.Tensor:
    """Autoregressive single-token step through every layer (q = 1: kernel
    B1 at G = 1). Returns logits (V,) f32."""
    x = embed_tokens(params, token_id)
    x, _ = prefill_step(params, cache, x, cos, sin, cfg)
    return compute_logits(params, x[0], cfg)
