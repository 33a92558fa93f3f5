"""The collectives of the port's mesh: the stand-ins for the JAX package's
`psum` / `pmax` / `pmean` and for the gathers GSPMD inserts, and the
point-to-point links of pipeline parallelism (its `ppermute`s and masked
`psum`s, quickvideo_tpu/parallel/pipeline.py).

There is no Pallas counterpart: these are thin wrappers over
torch.distributed on one axis's process group. Each collective returns its
input unchanged when the group is None (an axis of one rank), so a
single-rank run issues no collective. Both backends take them on CUDA
tensors (gloo copies through the host): all_reduce, broadcast, and
all_gather, which moves each rank's bytes, so it is exact for every dtype
(int8 codes, bf16).

Point to point (`isend` / `recv`): an activation of a shape and dtype
both ends know moves as its bytes, so any dtype crosses exactly. The
backend is the one the group was made with and is never switched. NCCL
sends and receives card tensors in place. gloo's `send` / `recv` take
host tensors only: given a card tensor, its TCP transport reads the
device address from the host and the process aborts ("writev ... Bad
address", found on the H100), while its broadcast, all_reduce and
all_gather copy card tensors through the host themselves. So over gloo a
card tensor is staged through host memory here: the sender copies it to
the host before it posts the send, the receiver receives into a host
buffer and copies it onto its device. That is gloo's transport for a
card tensor, as its broadcast does inside, not a fallback: the bytes that
arrive are the bytes that were sent.
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


def _host_staged(group, device: torch.device) -> bool:
    """Whether a tensor on `device` crosses `group` through host memory
    (gloo with a card tensor; module docstring)."""
    return (device.type != "cpu"
            and dist.get_backend(group) == dist.Backend.GLOO)


class PendingSend:
    """An asynchronous send and the tensor it reads, kept alive until
    `wait` returns."""

    def __init__(self, work, tensor: torch.Tensor):
        self._work, self._tensor = work, tensor

    def wait(self) -> None:
        if self._work is not None:
            self._work.wait()
        self._work = self._tensor = None


def isend(x: torch.Tensor, dst: int, group) -> PendingSend:
    """Post an asynchronous send of x's bytes to global rank `dst` of
    `group`; the caller waits on the returned handle before it drops or
    reuses x (over gloo, x is first copied to the host, and the copy is
    what the send reads)."""
    x = x.contiguous()
    if _host_staged(group, x.device):
        x = x.cpu()
    raw = x.view(torch.uint8)
    return PendingSend(dist.isend(raw, dst, group=group), raw)


def recv(shape, dtype, src: int, group, device) -> torch.Tensor:
    """A tensor of `shape` and `dtype` on `device`, received from global
    rank `src` of `group` (the bytes its `isend` posted)."""
    device = torch.device(device)
    stage = _host_staged(group, device)
    out = torch.empty(shape, dtype=dtype,
                      device="cpu" if stage else device)
    dist.recv(out.view(torch.uint8), src, group=group)
    return out.to(device) if stage else out


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """x of global rank `src`, on every rank of `group` (in place on a
    contiguous x; every rank passes a tensor of x's shape and dtype)."""
    if group_size(group) == 1:
        return x
    x = x.contiguous()
    dist.broadcast(x, src, group=group)
    return x
