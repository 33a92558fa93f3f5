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

Leaving a collective (the served mesh's faults, serving/server.py): when
another rank has failed its job, `abandon()` makes every collective of
this rank raise `Abandoned`, the ones it is blocked in and the ones it
would enter, until `reset()`. NCCL needs no more than that: the blocked
work is ended by aborting its communicator (parallel/mesh.py
`Mesh.abort`), and a host call returns at once anyway. gloo's abort ends
no work in flight, so over gloo each operation is posted and waited on in
slices of WAIT_SLICE_S, between which an abandoned wait raises: a
collective's work takes a wait with a time limit and can be waited on
again; a send's or receive's fails at its time limit, so a thread of its
own waits on it without one. The work a rank leaves stays posted
(`unfinished`) until a peer's process group closes its connections; only
then may its group be dropped, since dropping a gloo group joins its
threads.
"""

from __future__ import annotations

import datetime
import threading
from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist

# how long a gloo wait runs between two looks at `abandon`, in seconds
WAIT_SLICE_S = 0.05
_abandoned = threading.Event()
# the gloo works this rank posted and has not seen end: id -> (group,
# whether it has ended)
_posted: Dict[int, Tuple[object, Callable[[], bool]]] = {}


class Abandoned(RuntimeError):
    """A collective this rank left, or did not enter, because another rank
    of the mesh failed its job."""


def abandon() -> None:
    """Make every collective of this rank raise Abandoned, in flight or to
    come, until reset() (any thread)."""
    _abandoned.set()


def reset() -> None:
    """Collectives run again (the groups they take have been rebuilt)."""
    _abandoned.clear()


def _check() -> None:
    if _abandoned.is_set():
        raise Abandoned("another rank of the mesh failed this job")


def unfinished(group) -> bool:
    """Whether a gloo work this rank posted on `group` has not ended (one
    it left, or a send never waited on)."""
    for key, (g, ended) in list(_posted.items()):
        if ended():
            _posted.pop(key, None)
        elif g is group:
            return True
    return False


def _gloo(group) -> bool:
    return dist.get_backend(group) == dist.Backend.GLOO


def _wait(work, group) -> None:
    """Wait for a posted gloo work in slices; raise Abandoned between two
    once abandon() is called, leaving the work posted."""
    _posted[id(work)] = (group, work.is_completed)
    slice_ = datetime.timedelta(seconds=WAIT_SLICE_S)
    while True:
        try:
            work.wait(slice_)
            break
        except RuntimeError:
            if work.is_completed():
                break  # since the slice ran out, or with its own error
            _check()
    _posted.pop(id(work), None)
    work.wait()  # at once: its own error, if any


class _PointToPoint:
    """A posted gloo send or receive, waited on by a thread of its own;
    `wait` waits for that thread in slices."""

    def __init__(self, work, group):
        self._ended = threading.Event()
        self._error = None
        _posted[id(self)] = (group, self._ended.is_set)
        threading.Thread(target=self._run, args=(work,), daemon=True,
                         name="qv-p2p-wait").start()

    def _run(self, work) -> None:
        try:
            work.wait()
        except Exception as e:  # noqa: BLE001 - raised by `wait`
            # without the traceback, whose frame holds `self` and the work:
            # the work holds its group's connections open
            self._error = e.with_traceback(None)
        _posted.pop(id(self), None)
        self._ended.set()

    def wait(self) -> None:
        while not self._ended.wait(WAIT_SLICE_S):
            _check()
        if self._error is not None:
            raise self._error


def _run(collective, *args, group, **kw) -> None:
    """`collective` on `group`: called at once over NCCL, posted and
    waited on in slices over gloo."""
    _check()
    if not _gloo(group):
        collective(*args, group=group, **kw)
        return
    _wait(collective(*args, group=group, async_op=True, **kw), group)


def group_size(group) -> int:
    """Ranks in the group (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group's ranks, on every rank (in place on a
    contiguous x; returns the result)."""
    if group_size(group) == 1:
        return x
    x = x.contiguous()
    _run(dist.all_reduce, x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of x over the group's ranks, on every rank."""
    if group_size(group) == 1:
        return x
    x = x.contiguous()
    _run(dist.all_reduce, x, op=dist.ReduceOp.MAX, group=group)
    return x


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ranks' x concatenated along `dim` in group-rank order, on every
    rank (every rank's x has the same shape and dtype)."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    _run(dist.all_gather, [p.view(torch.uint8) for p in parts],
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

    def __init__(self, work, tensor: torch.Tensor, group):
        if work is not None and _gloo(group):
            work = _PointToPoint(work, group)
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
    _check()
    x = x.contiguous()
    if _host_staged(group, x.device):
        x = x.cpu()
    raw = x.view(torch.uint8)
    return PendingSend(dist.isend(raw, dst, group=group), raw, group)


def recv(shape, dtype, src: int, group, device) -> torch.Tensor:
    """A tensor of `shape` and `dtype` on `device`, received from global
    rank `src` of `group` (the bytes its `isend` posted)."""
    device = torch.device(device)
    stage = _host_staged(group, device)
    out = torch.empty(shape, dtype=dtype,
                      device="cpu" if stage else device)
    _check()
    raw = out.view(torch.uint8)
    if _gloo(group):
        _PointToPoint(dist.irecv(raw, src, group=group), group).wait()
    else:
        dist.recv(raw, src, group=group)
    return out.to(device) if stage else out


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """x of global rank `src`, on every rank of `group` (in place on a
    contiguous x; every rank passes a tensor of x's shape and dtype)."""
    if group_size(group) == 1:
        return x
    x = x.contiguous()
    _run(dist.broadcast, x, src, group=group)
    return x


def barrier(group) -> None:
    """Every rank of `group` has reached this point."""
    if group_size(group) > 1:
        _run(dist.barrier, group=group)
