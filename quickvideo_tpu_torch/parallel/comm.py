"""The collectives of the port's mesh: the stand-ins for the JAX package's
`psum` / `pmax` / `pmean` and for the gathers GSPMD inserts.

There is no Pallas counterpart: these are thin wrappers over
torch.distributed on one axis's process group. Each returns its input
unchanged when the group is None (an axis of one rank), so a single-rank
run issues no collective. Both backends take them on CUDA tensors (gloo
copies through the host): all_reduce, and all_gather, which moves each
rank's bytes, so it is exact for every dtype (int8 codes, bf16).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    """Ranks in the group (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group's ranks, on every rank (in place on a
    contiguous x; returns the result)."""
    if group_size(group) == 1:
        return x
    x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of x over the group's ranks, on every rank."""
    if group_size(group) == 1:
        return x
    x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ranks' x concatenated along `dim` in group-rank order, on every
    rank (every rank's x has the same shape and dtype)."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather([p.view(torch.uint8) for p in parts],
                    x.view(torch.uint8), group=group)
    return torch.cat(parts, dim=dim)
