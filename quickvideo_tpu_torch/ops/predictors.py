"""Token-importance predictors for KV pruning: the 19 policies.

Counterpart of quickvideo_tpu/ops/predictors.py. Shapes, as there:

  keys, values: (Hkv, L, D) the group's keys (rotary applied) and values
  hidden:       (L, C) the hidden states after the attention residual
  attn:         (L, L) head-averaged probabilities of group queries onto
                group keys under the full (past + group) softmax denominator,
                zero above the diagonal where the group is causal
  accum_attn:   (L,) prompt -> key attention accumulated over the prompt

Under tensor parallelism keys and values hold one tp rank's kv heads, and
`group` (the tp process group) reduces what the heads feed: the squared
norms (quickvideo_tpu/ops/predictors.py:48-61) and the dedup policies'
feature norms and cosines (:165-172) sum over the group. `attn` and
`accum_attn` arrive already averaged over every head. Every rank then
scores the same numbers and keeps the same indices.

Every policy returns k distinct indices, ascending. Ties break toward the
lowest index, as jax.lax.top_k and the JAX package's stable argsort do: the
port sorts stably (torch.topk's tie order on CUDA is not guaranteed).

The three random policies (`random`, `key_norms_small_random`,
`attention_weights_sum_with_random`) draw from an explicit
`torch.Generator`; jax.random and torch give different streams from one
seed, so they select other (equally valid) indices than the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from quickvideo_tpu_torch.parallel.comm import all_reduce_sum
from quickvideo_tpu_torch.utils import timing

RANDOM_PREDICTORS = frozenset(
    {"random", "key_norms_small_random", "attention_weights_sum_with_random"}
)


# -- score primitives --------------------------------------------------------


def _flat_norms(x: torch.Tensor, group=None) -> torch.Tensor:
    """(H, L, D) -> (L,) f32 L2 norm over the heads-flattened feature dim
    (every head's: the squared sums add up over the tp group)."""
    h, l, d = x.shape
    flat = x.transpose(0, 1).reshape(l, h * d).float()
    return torch.sqrt(all_reduce_sum(torch.sum(flat * flat, dim=-1), group))


def key_norms(keys: torch.Tensor, group=None) -> torch.Tensor:
    return _flat_norms(keys, group)


def value_norms(values: torch.Tensor, group=None) -> torch.Tensor:
    return _flat_norms(values, group)


def output_norms(hidden: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(hidden.float(), dim=-1)


def attn_column_stats(attn: torch.Tensor):
    """(colsum, colmean, unbiased colstd) of column i over rows i..L-1
    (rows above the diagonal are zero, so full-column sums are the same);
    the last column's std is 0, not NaN."""
    l = attn.shape[0]
    a = attn.float()
    colsum = a.sum(dim=0)
    colsumsq = (a * a).sum(dim=0)
    count = (l - torch.arange(l, device=a.device)).float()
    colmean = colsum / count
    var_num = colsumsq - count * colmean * colmean
    colvar = var_num / torch.clamp(count - 1.0, min=1.0)
    return colsum, colmean, torch.sqrt(torch.clamp(colvar, min=0.0))


def attn_windowed_colsum(attn: torch.Tensor, window: int = 258) -> torch.Tensor:
    """sum of attn[i : i + window, i] per column i (258 tokens per image)."""
    l = attn.shape[0]
    a = attn.float()
    csum = torch.cat([a.new_zeros(1, l), torch.cumsum(a, dim=0)], dim=0)
    idx = torch.arange(l, device=a.device)
    hi = torch.clamp(idx + window, max=l)
    return csum[hi, idx] - csum[idx, idx]


# -- selection helpers -------------------------------------------------------


def _top_k_indices(scores: torch.Tensor, k: int, largest: bool) -> torch.Tensor:
    """Indices of the k largest (or smallest) scores, ascending."""
    s = scores if largest else -scores
    order = torch.sort(s, descending=True, stable=True).indices
    return torch.sort(order[:k]).values


def _sorted_indices(scores: torch.Tensor, largest: bool) -> torch.Tensor:
    """Full stable argsort, best first."""
    return torch.sort(-scores if largest else scores, stable=True).indices


def _dedup_select(pivot_scores: torch.Tensor, feat: torch.Tensor, k: int,
                  num_pivots: int, largest: bool, group=None) -> torch.Tensor:
    """`num_pivots` tokens by score, then the k - num_pivots remaining
    tokens least cosine-similar (mean over the pivots) to the pivot set, on
    the feature rows `feat` (L, C); under tp each rank holds a slice of C,
    and the norms and dot products sum over the group."""
    order = _sorted_indices(pivot_scores, largest)
    pivots, others = order[:num_pivots], order[num_pivots:]
    f = feat.float()
    sq = all_reduce_sum((f * f).sum(dim=-1, keepdim=True), group)
    f = f / torch.clamp(torch.sqrt(sq), min=1e-12)
    cos = all_reduce_sum(f[pivots] @ f[others].t(), group)
    mean_cos = cos.mean(dim=0)
    fill = others[_top_k_indices(-mean_cos, k - num_pivots, largest=True)]
    return torch.sort(torch.cat([pivots, fill])).values


def _random_indices(generator: torch.Generator, l: int, k: int,
                    force_first: bool, device) -> torch.Tensor:
    """k distinct random indices; with `force_first` index 0 is among them
    (it replaces the last draw when absent)."""
    sel = torch.randperm(l, generator=generator,
                         device=generator.device)[:k].to(device)
    if force_first and k > 0:
        with timing.host_wait():
            absent = not bool((sel == 0).any())
        if absent:
            sel[k - 1] = 0
    return torch.sort(sel).values


def _half_and_random(order: torch.Tensor, k: int,
                     generator: torch.Generator) -> torch.Tensor:
    """The first k // 2 of `order` and k - k // 2 random others."""
    head, rest = order[: k // 2], order[k // 2 :]
    perm = torch.randperm(rest.shape[0], generator=generator,
                          device=generator.device).to(order.device)
    return torch.sort(torch.cat([head, rest[perm[: k - k // 2]]])).values


def _need(t: Optional[torch.Tensor], what: str, predict_type: str):
    if t is None:
        raise ValueError(f"{predict_type} needs {what}")
    return t


# -- dispatch ------------------------------------------------------------------


def select_top_k_indices(
    predict_type: str,
    k: int,
    *,
    keys: Optional[torch.Tensor] = None,
    values: Optional[torch.Tensor] = None,
    hidden: Optional[torch.Tensor] = None,
    attn: Optional[torch.Tensor] = None,
    accum_attn: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    group=None,  # the tp process group (module docstring)
) -> torch.Tensor:
    """The k retained positions within the group (int64, ascending)."""
    if k <= 0:
        raise ValueError("k must be positive (the engine skips k <= 0)")
    l = None
    for a in (keys, values, hidden):
        if a is not None:
            l = a.shape[-2] if a.dim() == 3 else a.shape[0]
            break
    if attn is not None:
        l = attn.shape[-1]
    if predict_type in RANDOM_PREDICTORS:
        _need(generator, "a torch.Generator", predict_type)
    pt = predict_type

    if pt == "salient_tokens":
        _, colmean, colstd = attn_column_stats(_need(attn, "attn", pt))
        return _top_k_indices(colstd + colmean, k, largest=True)
    if pt == "attention_weights":
        _, colmean, _ = attn_column_stats(_need(attn, "attn", pt))
        return _top_k_indices(colmean, k, largest=True)
    if pt in ("query_attention_weights",
              "query_attention_weights_by_value_norm"):
        # without prompt queries (the final prefill with do_top_k_for_query)
        # the group is its own query: within-group column sums
        if accum_attn is None:
            accum_attn, _, _ = attn_column_stats(
                _need(attn, "prompt accum scores or group probs", pt)
            )
        w = accum_attn.float()
        if pt == "query_attention_weights_by_value_norm":
            w = w * value_norms(values, group)
        return _top_k_indices(w, k, largest=True)
    if pt == "attention_weights_sum":
        colsum, _, _ = attn_column_stats(_need(attn, "attn", pt))
        return _top_k_indices(colsum, k, largest=True)
    if pt == "attention_weights_sum_head_tail":
        colsum, _, _ = attn_column_stats(_need(attn, "attn", pt))
        order = _sorted_indices(colsum, largest=True)
        head = order[: k // 2]
        tail = order[l - k // 2 :] if k // 2 > 0 else order[:0]
        sel = torch.cat([head, tail])
        if sel.shape[0] < k:  # odd k: the next-best head token
            sel = torch.cat([sel, order[k // 2 : k // 2 + k - sel.shape[0]]])
        return torch.sort(sel[:k]).values
    if pt == "attention_weights_sum_per_image":
        return _top_k_indices(
            attn_windowed_colsum(_need(attn, "attn", pt)), k, largest=True
        )
    if pt == "attention_weights_sum_with_random":
        colsum, _, _ = attn_column_stats(_need(attn, "attn", pt))
        return _half_and_random(_sorted_indices(colsum, largest=True), k,
                                generator)
    if pt == "attention_weights_deduplication":
        colsum, _, _ = attn_column_stats(_need(attn, "attn", pt))
        feat = values.transpose(0, 1).reshape(l, -1)
        return _dedup_select(colsum, feat, k, (k - 1) // 2 + 1, largest=True,
                             group=group)
    if pt == "vector_norms":
        return _top_k_indices(value_norms(values, group), k, largest=True)
    if pt == "vector_norms_small":
        return _top_k_indices(value_norms(values, group), k, largest=False)
    if pt == "key_norms":
        return _top_k_indices(key_norms(keys, group), k, largest=True)
    if pt == "key_norms_small":
        return _top_k_indices(key_norms(keys, group), k, largest=False)
    if pt == "key_norms_small_random":
        return _half_and_random(_sorted_indices(key_norms(keys, group),
                                                largest=False),
                                k, generator)
    if pt == "random":
        like = next(a for a in (keys, values, hidden, attn) if a is not None)
        return _random_indices(generator, l, k, force_first=True,
                               device=like.device)
    if pt == "key_norms_small_deduplication":
        feat = keys.transpose(0, 1).reshape(l, -1)
        return _dedup_select(key_norms(keys, group), feat, k,
                             (k - 1) // 16 + 1, largest=False, group=group)
    if pt == "key_weighted_vector_norms":
        w = (torch.softmax(key_norms(keys, group), dim=-1)
             * value_norms(values, group))
        return _top_k_indices(w, k, largest=True)
    if pt == "output_norms":
        return _top_k_indices(output_norms(_need(hidden, "hidden", pt)), k,
                              largest=True)
    if pt == "weighted_norms":
        # mean over queries of ||attn[q, i] v_i|| = ||v_i|| mean_q attn[q, i]
        w = _need(attn, "attn", pt).float().abs().mean(dim=0)
        return _top_k_indices(w * value_norms(values, group), k, largest=True)
    raise ValueError(f"Unknown predict type: {predict_type}")


def indices_to_mask(indices: torch.Tensor, l: int) -> torch.Tensor:
    """Boolean keep-mask (L,) from selected indices."""
    mask = torch.zeros(l, dtype=torch.bool, device=indices.device)
    mask[indices] = True
    return mask
