"""Context-parallel attention: the KV cache's capacity split over the `sp`
ranks, attention over the past as per-window partials merged exactly.

Counterpart of quickvideo_tpu/parallel/context_parallel.py. An hour of
video outgrows one card's memory next to the weights; rank i of sp holds
slots [i * C / sp, (i + 1) * C / sp) of every layer (ops/kv_cache.py's
window). Per query row, each rank computes the normalized partial of its
window, out_i = softmax(q . K_i) V_i, and its log-sum-exp lse_i, with
kernel B1 in pure-past mode with lse over the window's valid slots
clip(length - i * C / sp, 0, C / sp); then

    m   = max_i lse_i                     (all_reduce_max)
    w_i = exp(lse_i - m)
    out = sum_i out_i w_i / sum_i w_i     (one all_reduce_sum of both)
    lse = m + log(sum_i w_i)

A window with no valid slot (past the valid length, or the second window
before the first group fills the first) gives out 0 and lse NEG_INF, and
weighs 0 in the merge. No K/V crosses ranks: per layer and step, one
(Hq, G) max and one (Hq, G, D + 1) sum.

The group's own keys are replicated on every sp rank: the in-group partial
runs kernel B1 too, in unified causal mode with lse over the group alone
(an empty past: the group's raw K/V are the call's whole cache), where the
JAX package materializes the dense (Hq, G, G) f32 scores (1.45 GB per layer
at G = 3600); the two compute the same partial. The past and in-group
partials then merge as on one device (ops/attention.py::merge_partials).
Appends write the part of the rows in the rank's window
(ops/kv_cache.py::stacked_append).
"""

from __future__ import annotations

import torch

from quickvideo_tpu_torch.ops.attention import NEG_INF, PartialAttn, merge_partials
from quickvideo_tpu_torch.ops.flash_attention import flash_past_attention
from quickvideo_tpu_torch.ops.kv_cache import KVCache
from quickvideo_tpu_torch.parallel.comm import all_reduce_max, all_reduce_sum


def merge_shard_partials(pa: PartialAttn, group) -> PartialAttn:
    """The exact merge over the group's ranks of their partials over
    disjoint key sets (module docstring). Identical on every rank."""
    m = torch.clamp(all_reduce_max(pa.lse.float().clone(), group), min=-1e29)
    w = torch.exp(pa.lse.float() - m)
    both = torch.cat([pa.out.float() * w[..., None], w[..., None]], dim=-1)
    both = all_reduce_sum(both, group)
    num, den = both[..., :-1], both[..., -1]
    out = num / torch.clamp(den, min=1e-30)[..., None]
    lse = torch.where(den > 0, m + torch.log(torch.clamp(den, min=1e-30)),
                      torch.full_like(den, NEG_INF))
    return PartialAttn(out, lse)


def _layer(scales, li):
    return None if scales is None else scales[li]


def cp_stacked_past_attention(
    q: torch.Tensor,  # (Hq, Q, D), the same on every sp rank
    cache: KVCache,  # this rank's window of the stacked cache
    li: int,
    length: int,  # valid slots of layer li over the whole cache
    scale: float,
    group,  # the sp process group
) -> PartialAttn:
    """Every row of q over the cache's valid slots [0, length), with the
    capacity split over the sp ranks: B1 pure past + lse (f32 out) on this
    rank's window at its local length, merged over the group. The same
    contract as ops/attention.py::past_partial_attention."""
    pa = flash_past_attention(
        q, cache.k[li], cache.v[li], cache.local_length(length), scale,
        k_scale=_layer(cache.k_scale, li), v_scale=_layer(cache.v_scale, li),
        causal=False, with_lse=True, out_dtype=torch.float32,
    )
    return merge_shard_partials(PartialAttn(*pa), group)


def in_group_partial(q: torch.Tensor, k_grp: torch.Tensor,
                     v_grp: torch.Tensor, scale: float) -> PartialAttn:
    """The group over itself, causally, with lse (f32 out): B1 in unified
    causal mode over an empty past, the group's raw K/V as the cache."""
    return PartialAttn(*flash_past_attention(
        q, k_grp, v_grp, 0, scale, causal=True, with_lse=True,
        out_dtype=torch.float32,
    ))


def cp_stacked_grouped_attention(
    q: torch.Tensor,  # (Hq, G, D)
    k_grp: torch.Tensor,  # (Hkv, G, D) the group's raw rotary keys
    v_grp: torch.Tensor,
    cache: KVCache,
    li: int,
    length: int,
    scale: float,
    group,
):
    """The group step's attention with a context-parallel past: the merged
    past partial and the in-group causal partial, merged. Returns (out
    (Hq, G, D) f32, lse (Hq, G)): the lse is the full softmax denominator
    over past and group, which the attention-statistics predictors read
    (quickvideo_tpu/parallel/context_parallel.py:340-376)."""
    past = cp_stacked_past_attention(q, cache, li, length, scale, group)
    return merge_partials(past, in_group_partial(q, k_grp, v_grp, scale))


def shard_cache_cp(cache: KVCache, sp_index: int, sp_size: int) -> KVCache:
    """This rank's window of a whole cache (values and int8 scales alike),
    as new tensors; the capacity must divide by sp_size (a resumed chat
    session rounds it to the engine's quantum first)."""
    if cache.capacity % sp_size:
        raise ValueError(
            f"cache capacity {cache.capacity} not divisible by mesh axis "
            f"'sp'={sp_size}"
        )
    w = cache.capacity // sp_size
    rows = slice(sp_index * w, (sp_index + 1) * w)

    def part(t):
        return None if t is None else t[:, :, rows].contiguous()

    return KVCache(k=part(cache.k), v=part(cache.v),
                   lengths=list(cache.lengths), k_scale=part(cache.k_scale),
                   v_scale=part(cache.v_scale), sp_index=sp_index,
                   sp_size=sp_size)
