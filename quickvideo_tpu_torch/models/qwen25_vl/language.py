"""Qwen2.5-VL language decoder in PyTorch: the grouped-prefill step.

Counterpart of quickvideo_tpu/models/qwen25_vl/language.py on one device.
Parameters are a plain dict (see convert.py): weights keep the JAX layout
(in, out) and are applied as `x @ w`. Layers run as a Python loop; the
stacked KV cache is updated in place (ops/kv_cache.py).

A `StepSpec` says what one step does at one layer; `layer_step` has the JAX
package's attention branches:

  hot path      (no prompt rows, attend_past) append the raw group's K/V,
                run one unified-causal attention over [past | group] (kernel
                B1 on CUDA, its plain version on the CPU), with the lse when
                an attention-statistics predictor needs the group's
                probabilities (`_group_probs_from_lse`); the JAX package's
                `pallas_unified` route, language.py:427-509
  query-based   (prompt_len > 0) the prompt rows ride with the group: the
                prompt -> video scores accumulate (`_prompt_accum_scores`),
                the in-group partial runs under the video/prompt mask (or
                the reference-compatible one), the past partial is B1 in
                pure-past mode with lse and f32 output, and the two merge
                (language.py:324-392, on the 'pallas' route)
  local only    (attend_past=False) the group attends itself alone
                (language.py:395-403, 348-353)

then the o-projection, the pruning hook (`ops/prune.py` on the group's raw
K/V, the hidden states of its video rows, its probabilities or accumulated
scores), the append of the kept rows over the group's slots, and the MLP.
With an int8 or int8k cache the appends quantize and B1 runs its int8-QK
variant. `prefill_step_unrolled` takes one spec per layer (decay schedules;
the cascade shrinks the rows for the next layer).

Under a mesh (parallel/mesh.py) every rank runs the same steps; `mesh`
None is one device. Pipeline parallelism (pp) runs a stage's slab of
layers and of the cache through the same functions (`layer0`, the slab's
first global layer, seeds the random predictors; parallel/pipeline.py).
Tensor parallelism (tp): a rank holds its heads' and MLP columns' slices
of the weights (parallel/sharding.py), q/k/v carry its local heads, the
o-projection's and the down-projection's partial products sum over tp in
f32 (`_row_parallel`; int8 weights quantize each activation row with its
whole-row scale), the predictors' scores reduce over tp (the
query-based accumulation, the group probabilities, the norms), and the
logits gather their vocab slices (`compute_logits`): the JAX package's
manual-tp route (language.py:138-143, 158-172, 332-335, 528-530, 614-616).
Context parallelism (sp): the cache holds the rank's capacity window, and
every step's attention over the past is B1 pure past + lse on the window,
merged over sp, then merged with the in-group partial (parallel/
context_parallel.py; the JAX `cp_mesh` routes, language.py:324-392,
405-426); appends write the window's part.

Every matrix product goes through ops/quantization.py, so a layer runs bf16
or int8 weights alike (the JAX package's qdot / qdot_multi / qtake call
sites). `min_rows` is the act-quant row gate: None is the default gate
(decode steps of one row stay weight-only), 0 acts for the final prefill,
which the JAX package runs as a padded bucket of at least 32 rows.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from quickvideo_tpu_torch.models.qwen25_vl.config import TextConfig
from quickvideo_tpu_torch.models.qwen25_vl.rope import apply_rotary
from quickvideo_tpu_torch.ops import kv_cache as kv
from quickvideo_tpu_torch.ops import prune as prune_ops
from quickvideo_tpu_torch.ops.attention import (
    _partial_attention,
    grouped_attention,
    group_probs_from_lse,
    merge_partials,
    past_partial_attention,
)
from quickvideo_tpu_torch.ops.flash_attention import flash_past_attention
from quickvideo_tpu_torch.ops.predictors import RANDOM_PREDICTORS
from quickvideo_tpu_torch.ops.quantization import (
    linear,
    linear_multi,
    qdot,
    qtake,
)
from quickvideo_tpu_torch.parallel.comm import (
    all_gather,
    all_reduce_sum,
    group_size,
)
from quickvideo_tpu_torch.parallel.context_parallel import (
    cp_stacked_grouped_attention,
    cp_stacked_past_attention,
)
from quickvideo_tpu_torch.utils import timing


@dataclasses.dataclass(frozen=True)
class StepSpec:
    """What one prefill / decode step does at one layer (the JAX package's
    StepSpec, language.py:96-151; the mesh is the step functions' `mesh`
    argument). `keep_k == 0` appends every video row."""

    q_len: int  # rows entering the step (with the prompt tail if query-based)
    keep_k: int = 0  # retained video rows (0 = keep all)
    predict_type: str = "key_norms_small"
    needs_probs: bool = False  # the predictor reads the group's probs
    prompt_len: int = 0  # query-based: trailing prompt rows (never cached)
    attend_past: bool = True  # False: adaptive_local_attention off
    cascade: bool = False  # the kept rows alone go on to the next layer
    ref_query_mask: bool = False  # query-based: the reference's bottom-
    # right-aligned mask (video row i sees video keys <= i - prompt_len and
    # a past truncated to [0, length + i - prompt_len])

    @property
    def video_len(self) -> int:
        return self.q_len - self.prompt_len

    @property
    def append_n(self) -> int:
        return self.keep_k if self.keep_k > 0 else self.video_len


def layer_generator(seed_key: Optional[Sequence[int]], li: int,
                    spec: StepSpec) -> Optional[torch.Generator]:
    """The random predictors' generator of layer `li`: seeded from
    (*seed_key, li), where the engine's seed_key is (seed + 1, group) as the
    JAX engine folds its rng (prefill/engine.py:273, 329; language.py:647).
    None where the spec draws nothing."""
    if seed_key is None or spec.keep_k <= 0:
        return None
    if spec.predict_type not in RANDOM_PREDICTORS:
        return None
    words = [int(w) for w in seed_key] + [li]
    seed = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _groups(mesh):
    """(tp group, sp group) of the mesh; None for an axis of one rank."""
    if mesh is None:
        return None, None
    return mesh.group("tp"), mesh.group("sp")


def _row_parallel(x: torch.Tensor, w, tp,
                  min_rows: Optional[int] = None) -> torch.Tensor:
    """x @ w rounded to x's dtype, where under tp x is the rank's slice of
    the contraction and w its rows: the partial products sum over tp in
    f32 and round once."""
    if tp is None:
        return linear(x, w, min_rows=min_rows)
    y = qdot(x, w, min_rows=min_rows, group=tp)
    return all_reduce_sum(y, tp).to(x.dtype)


def swiglu_mlp(x: torch.Tensor, lp: dict,
               min_rows: Optional[int] = None, tp=None) -> torch.Tensor:
    g, u = linear_multi(x, (lp["wg"], lp["wu"]), min_rows=min_rows)
    return _row_parallel(F.silu(g) * u, lp["wd"], tp, min_rows)


def _project_qkv(lp: dict, h: torch.Tensor, cfg: TextConfig,
                 min_rows: Optional[int] = None):
    """(L, C) -> q (Hq, L, D), k/v (Hkv, L, D), as strided views; under tp
    the weights hold the rank's heads, and so do q, k and v."""
    l = h.shape[0]
    hd = cfg.head_dim
    q, k, v = linear_multi(
        h, (lp["wq"], lp["wk"], lp["wv"]), min_rows=min_rows
    )
    q = (q + lp["bq"]).view(l, -1, hd)
    k = (k + lp["bk"]).view(l, -1, hd)
    v = (v + lp["bv"]).view(l, -1, hd)
    return q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1)


def embed_tokens(params: dict, token_ids: torch.Tensor,
                 dtype=None) -> torch.Tensor:
    """Token embeddings in `dtype` (default the final norm's: a pipeline
    stage without the norm passes its compute dtype)."""
    return qtake(params["embed"], token_ids,
                 dtype if dtype is not None else params["norm"].dtype)


def compute_logits(
    params: dict, hidden: torch.Tensor, cfg: TextConfig, mesh=None,
) -> torch.Tensor:
    """(C,) or (L, C) -> logits in f32 (the product is not rounded to the
    model dtype first, as in the JAX package); under tp each rank computes
    its vocab slice and the slices are gathered."""
    h = rms_norm(hidden, params["norm"], cfg.rms_norm_eps)
    return all_gather(qdot(h, params["lm_head"]), _groups(mesh)[0], dim=-1)


def _layer(scales: Optional[torch.Tensor], li: int):
    return None if scales is None else scales[li]


def _prompt_accum_scores(q_prompt: torch.Tensor, k_video: torch.Tensor,
                         cfg: TextConfig, tp=None) -> torch.Tensor:
    """Prompt -> video-key attention accumulated as the reference does:
    softmax over the video keys only (no past, no causal mask), summed over
    the prompt queries, averaged over query heads (under tp the rank's
    head mean, averaged over the ranks) -> (video_len,) f32
    (quickvideo_tpu/models/qwen25_vl/language.py:175-190, 332-335)."""
    hkv = k_video.shape[0]
    hq, p, d = q_prompt.shape
    qf = q_prompt.float().reshape(hkv, hq // hkv, p, d)
    scores = torch.einsum("hrqd,hkd->hrqk", qf, k_video.float()) / (
        cfg.head_dim ** 0.5
    )
    accum = torch.softmax(scores, dim=-1).sum(dim=2).mean(dim=(0, 1))
    return all_reduce_sum(accum, tp) / group_size(tp)


def _query_based_attention(q, k_grp, v_grp, cache, li, length, spec, scale,
                           sp=None):
    """The query-based step's attention (module docstring): in-group
    partial merged with the past partial (over the sp ranks' windows under
    context parallelism, which takes precedence over the reference-
    compatible mask, as in the JAX package). Returns (Hq, q_len, D) f32."""
    gv, ql = spec.video_len, spec.q_len
    row = torch.arange(ql, device=q.device)[:, None]
    col = torch.arange(gv, device=q.device)[None, :]
    if spec.ref_query_mask:
        cmask = col <= row - spec.prompt_len
    else:  # video rows causal, prompt rows see the whole group
        cmask = (col <= row) | (row >= gv)
    pg = _partial_attention(q, k_grp, v_grp, cmask, scale)
    if not spec.attend_past:
        return pg.out
    ks, vs = _layer(cache.k_scale, li), _layer(cache.v_scale, li)
    if sp is not None:
        pp = cp_stacked_past_attention(q, cache, li, length, scale, sp)
    elif spec.ref_query_mask:
        # row i sees past slot j iff j <= i + length - prompt_len: the
        # plain masked partial over the (dequantized) valid slots
        n = max(length, 1)
        colp = torch.arange(n, device=q.device)[None, :]
        pmask = colp < torch.clamp(row + length - spec.prompt_len + 1,
                                   max=length)
        kb, vb = cache.k[li, :, :n], cache.v[li, :, :n]
        if ks is not None:
            kb = kv.dequantize_kv(kb, ks[:, :n])
        if vs is not None:
            vb = kv.dequantize_kv(vb, vs[:, :n])
        pp = _partial_attention(q, kb, vb, pmask, scale)
    else:
        pp = past_partial_attention(q, cache.k[li], cache.v[li], length,
                                    scale, ks, vs)
    return merge_partials(pp, pg)[0]


def layer_step(
    lp: dict,
    x: torch.Tensor,  # (q_len, C)
    cos: torch.Tensor,  # (q_len, head_dim) f32
    sin: torch.Tensor,
    cache: kv.KVCache,
    li: int,
    cfg: TextConfig,
    spec: StepSpec,
    min_rows: Optional[int] = None,  # act-quant row gate (module docstring)
    generator: Optional[torch.Generator] = None,  # random predictors
    mesh=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One decoder layer over the current group. Writes the group's K/V (or
    its compact) into layer `li` of the cache at `cache.lengths[li]`; the
    caller advances the length. Returns (x_out, retained indices | None)."""
    tp, sp = _groups(mesh)
    length = cache.lengths[li]
    scale = cfg.head_dim ** -0.5
    h = rms_norm(x, lp["ln1"], cfg.rms_norm_eps)
    q, k, v = _project_qkv(lp, h, cfg, min_rows)
    q, k = apply_rotary(q, k, cos, sin)
    gv = spec.video_len
    k_grp, v_grp = k[:, :gv], v[:, :gv]
    accum = group_probs = None
    appended = False
    if spec.prompt_len > 0:
        accum = _prompt_accum_scores(q[:, gv:], k_grp, cfg, tp)
        out = _query_based_attention(q, k_grp, v_grp, cache, li, length,
                                     spec, scale, sp)
    elif not spec.attend_past:
        out, group_probs = grouped_attention(
            q, k_grp, v_grp, scale=scale, return_group_probs=spec.needs_probs,
            group=tp,
        )
    elif sp is not None:
        # context parallelism: the past over the sp windows, merged with
        # the in-group partial; the rows are appended below
        out, lse = cp_stacked_grouped_attention(
            q, k_grp, v_grp, cache, li, length, scale, sp
        )
        if spec.needs_probs:
            group_probs = group_probs_from_lse(q, k_grp, lse, scale, tp)
    else:
        # raw group at [length, length + G) (quantized where the cache is,
        # so the group attends its own K/V with the int8 rounding);
        # attention over [0, length + i]
        kv.stacked_append(cache, li, length, k_grp, v_grp)
        appended = True
        out, lse = flash_past_attention(
            q, cache.k[li], cache.v[li], length, scale,
            k_scale=_layer(cache.k_scale, li),
            v_scale=_layer(cache.v_scale, li), with_lse=spec.needs_probs,
        )
        if spec.needs_probs:
            group_probs = group_probs_from_lse(q, k_grp, lse, scale, tp)
    ql = x.shape[0]
    attn = out.to(x.dtype).transpose(0, 1).reshape(ql, -1)
    x = x + _row_parallel(attn, lp["wo"], tp, min_rows)
    indices = None
    if spec.keep_k > 0:
        # the raw rotary keys are scored; the kept raw rows are (re)quantized
        # into the compact, which overwrites the first keep_k slots of the
        # group; a raw tail stays past the valid length, never attended
        with timing.span("prune"):
            res = prune_ops.select_and_compact(
                spec.predict_type, spec.keep_k, k_grp, v_grp, hidden=x[:gv],
                group_probs=group_probs, accum_attn=accum,
                generator=generator, group=tp,
            )
            kv.stacked_append(cache, li, length, res.k_keep, res.v_keep)
        indices = res.indices
    elif not appended:
        kv.stacked_append(cache, li, length, k_grp, v_grp)
    x = x + swiglu_mlp(rms_norm(x, lp["ln2"], cfg.rms_norm_eps), lp, min_rows,
                       tp)
    return x, indices


def prefill_step_unrolled(
    params: dict,
    cache: kv.KVCache,
    x: torch.Tensor,  # (q_len, C) input embeddings
    cos: torch.Tensor,  # (q_len, head_dim) merged mRoPE rows of these rows
    sin: torch.Tensor,
    cfg: TextConfig,
    specs: Sequence[StepSpec],  # one per layer
    min_rows: Optional[int] = None,
    seed_key: Optional[Sequence[int]] = None,  # random predictors' seed
    mesh=None,
    layer0: int = 0,  # the global index of params["layers"][0]
) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]]]:
    """One group through all layers, each with its own spec (keep_k may
    change with depth). Advances layer li's length by specs[li].append_n.
    With `cascade`, a pruning layer passes only its kept rows (and the
    prompt rows, in query-based mode) to the next layer, with their rotary
    rows (quickvideo_tpu/models/qwen25_vl/language.py:669-719). Returns
    (final hidden states, per-layer retained indices).

    A pipeline stage passes its slab of layers and of the cache: the cache
    index stays local to the slab (li), while the random predictors'
    generator takes the global layer (layer0 + li), so a stage draws what
    one device draws at those layers (quickvideo_tpu/parallel/
    pipeline.py:94-97 splits the two the same way)."""
    n = len(params["layers"])
    indices = []
    for li, lp in enumerate(params["layers"]):
        spec = specs[li]
        x, idx = layer_step(
            lp, x, cos, sin, cache, li, cfg, spec, min_rows,
            layer_generator(seed_key, layer0 + li, spec), mesh,
        )
        cache.lengths[li] += spec.append_n
        indices.append(idx)
        if idx is not None and spec.cascade and li < n - 1:
            # the prompt rows ride along after the kept video rows
            keep = torch.cat([
                idx, torch.arange(spec.video_len, spec.q_len,
                                  device=idx.device),
            ])
            x, cos, sin = x[keep], cos[keep], sin[keep]
    return x, indices


def prefill_step(
    params: dict,
    cache: kv.KVCache,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    cfg: TextConfig,
    spec: Optional[StepSpec] = None,  # default: append all rows
    min_rows: Optional[int] = None,
    seed_key: Optional[Sequence[int]] = None,
    mesh=None,
    layer0: int = 0,
) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]]]:
    """`prefill_step_unrolled` with one spec for every layer."""
    spec = spec or StepSpec(q_len=x.shape[0])
    return prefill_step_unrolled(
        params, cache, x, cos, sin, cfg, [spec] * len(params["layers"]),
        min_rows, seed_key, mesh, layer0,
    )


def decode_step(
    params: dict,
    cache: kv.KVCache,
    token_id: torch.Tensor,  # (1,) int64 on the device
    cos: torch.Tensor,  # (1, head_dim)
    sin: torch.Tensor,
    cfg: TextConfig,
    mesh=None,
) -> torch.Tensor:
    """Autoregressive single-token step through every layer (q = 1: kernel
    B1 at G = 1). Returns logits (V,) f32. Its three parts, the embedding,
    the stack and the logits, are what a pipeline runs on its first, every
    and its last stage (parallel/pipeline.py::PipelinedStack.decode_step)."""
    x = embed_tokens(params, token_id)
    x, _ = prefill_step(params, cache, x, cos, sin, cfg, mesh=mesh)
    return compute_logits(params, x[0], cfg, mesh)


def full_forward_logits(
    params: dict,
    x: torch.Tensor,  # (L, C) embeddings
    cos: torch.Tensor,  # (L, head_dim) f32
    sin: torch.Tensor,
    cfg: TextConfig,
) -> torch.Tensor:
    """Ungrouped, uncached causal forward over a whole sequence -> logits
    (L, V) f32 (quickvideo_tpu/models/qwen25_vl/language.py:770); the
    baseline and a parity target. Each layer's attention is kernel B1 in
    unified causal mode over an empty past, with the sequence's own K/V as
    the cache (the in-group partial's route, parallel/context_parallel.py).
    One device."""
    n = x.shape[0]
    scale = cfg.head_dim ** -0.5
    for lp in params["layers"]:
        h = rms_norm(x, lp["ln1"], cfg.rms_norm_eps)
        q, k, v = _project_qkv(lp, h, cfg)
        q, k = apply_rotary(q, k, cos, sin)
        out, _ = flash_past_attention(q, k, v, 0, scale)
        x = x + linear(out.to(x.dtype).transpose(0, 1).reshape(n, -1),
                       lp["wo"])
        x = x + swiglu_mlp(rms_norm(x, lp["ln2"], cfg.rms_norm_eps), lp)
    return compute_logits(params, x, cfg)
