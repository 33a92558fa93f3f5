"""Select-and-compact: score a group's tokens and gather the retained K/V.

Counterpart of quickvideo_tpu/ops/prune.py::select_and_compact. Positions
are not renumbered: retained keys keep their rotary phases.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from quickvideo_tpu_torch.ops import predictors


class PruneResult(NamedTuple):
    k_keep: torch.Tensor  # (Hkv, k, D)
    v_keep: torch.Tensor  # (Hkv, k, D)
    indices: torch.Tensor  # (k,) positions within the group, ascending
    accum_keep: Optional[torch.Tensor]  # (k,) kept accum scores, or None


def select_and_compact(
    predict_type: str,
    keep_k: int,
    k_group: torch.Tensor,  # (Hkv, G, D) rotary-applied group keys
    v_group: torch.Tensor,  # (Hkv, G, D)
    *,
    hidden: Optional[torch.Tensor] = None,  # (G, C) after the attention
    group_probs: Optional[torch.Tensor] = None,  # (G, G) head-averaged
    accum_attn: Optional[torch.Tensor] = None,  # (G,) prompt -> key scores
    generator: Optional[torch.Generator] = None,  # random predictors
) -> PruneResult:
    """Score the group's tokens by `predict_type` (ops/predictors.py), keep
    `keep_k`, gather their K/V (and accumulated scores)."""
    idx = predictors.select_top_k_indices(
        predict_type, keep_k, keys=k_group, values=v_group, hidden=hidden,
        attn=group_probs, accum_attn=accum_attn, generator=generator,
    )
    return PruneResult(
        k_keep=k_group.index_select(1, idx),
        v_keep=v_group.index_select(1, idx),
        indices=idx,
        accum_keep=None if accum_attn is None else accum_attn[idx],
    )
