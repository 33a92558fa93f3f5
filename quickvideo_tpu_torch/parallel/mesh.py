"""The device mesh over torch.distributed: one process per rank.

Counterpart of quickvideo_tpu/parallel/mesh.py. The JAX package lays its
devices out as a (dp, pp, tp, sp) array and lets GSPMD insert the
collectives; the port runs SPMD instead: every rank runs the same request
loop on the same inputs, and the collectives sit at explicit points
(parallel/comm.py). Ranks are laid out in the same (dp, pp, tp, sp)
row-major order, so the inner axes (tp, then sp) are neighbours:

    rank = ((dp_i * pp + pp_i) * tp + tp_i) * sp + sp_i

Axes (config.MeshConfig):
  dp  data parallel: independent requests (evaluation/qa.py::shard_samples)
  pp  pipeline parallel: layer slabs over stages, activations passed
      from stage to stage (parallel/pipeline.py)
  tp  tensor parallel: attention heads and MLP columns (parallel/sharding.py)
  sp  context parallel: the KV cache's capacity axis
      (parallel/context_parallel.py)

`Mesh` holds this rank's coordinates, one process group per axis of more
than one rank (`torch.distributed.new_group`; None for an axis of one), the
group of the ranks that serve one request together (pp x tp x sp), and the
device. Under pp it also names this rank's stage and the global ranks of
the previous and next stage at the same dp, tp and sp coordinates (the
ends of its point-to-point links) and of the last stage (the source of
each broadcast token), and the control group: every rank, over gloo, with
its own long timeout (CONTROL_TIMEOUT_S), which carries the HTTP server's
job descriptions from rank 0 to the others (serving/server.py) and never
the model's tensors. `Mesh.abort` and `Mesh.rebuild` end a job that one
rank failed and make the model's groups anew (serving/server.py); the
control group is never aborted. `init_multihost` starts the process
group from the environment: QV_COORDINATOR / QV_NUM_PROCESSES /
QV_PROCESS_ID (the JAX package's contract), else torchrun's RANK /
WORLD_SIZE / MASTER_ADDR / MASTER_PORT.
The backend is the caller's choice: "nccl" by default on a CUDA device,
"gloo" on the CPU; nothing switches it, and a failed init raises.
"""

from __future__ import annotations

import datetime
import itertools
import os
import threading
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.distributed import distributed_c10d

from quickvideo_tpu_torch.config import MeshConfig
from quickvideo_tpu_torch.parallel import comm

AXES = ("dp", "pp", "tp", "sp")
# how long a rank may wait in one collective of the control group: a
# follower of the HTTP server waits there for as long as the server is
# idle, and the leader sends a heartbeat (serving/server.py HEARTBEAT_S)
# well within it
CONTROL_TIMEOUT_S = 3600.0


def default_backend(device) -> str:
    """"nccl" for a CUDA device, "gloo" for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_rank() -> int:
    """torchrun's LOCAL_RANK, else the global rank (one host)."""
    env = os.environ.get("LOCAL_RANK")
    if env is not None:
        return int(env)
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device=None) -> torch.device:
    """This rank's device: `device` as given (two ranks may name the same
    card), else cuda:{local rank}. Raises where that card does not exist
    rather than picking another."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", local_rank())
    else:
        dev = torch.device("cuda", local_rank())
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"rank device {dev}: no CUDA device is available; pass "
                "device='cpu' for the kernels' plain versions"
            )
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank device {dev}: this host has "
                f"{torch.cuda.device_count()} CUDA device(s); pass a device "
                "to place several ranks on one card"
            )
    return dev


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> bool:
    """Start torch.distributed for this process, once. Arguments left None
    come from QV_COORDINATOR ("host:port", or an init-method URL such as
    "file:///path"), QV_NUM_PROCESSES and QV_PROCESS_ID, else from
    torchrun's WORLD_SIZE / RANK (address from MASTER_ADDR / MASTER_PORT).
    `backend` defaults to default_backend(device or "cuda"). Returns False
    in a single-process run (nothing started), True once the group is up;
    a second call is a no-op. Any failure of the init raises."""
    env = os.environ
    if num_processes is None:
        n = env.get("QV_NUM_PROCESSES") or env.get("WORLD_SIZE")
        num_processes = int(n) if n else None
    if not num_processes or num_processes == 1:
        return False
    if dist.is_initialized():
        if dist.get_world_size() != num_processes:
            raise RuntimeError(
                f"torch.distributed already runs {dist.get_world_size()} "
                f"ranks, not {num_processes}"
            )
        return True
    if process_id is None:
        p = env.get("QV_PROCESS_ID") or env.get("RANK")
        if p is None:
            raise ValueError(
                "a multi-process run needs this process's rank: pass "
                "process_id or set QV_PROCESS_ID (or torchrun's RANK)"
            )
        process_id = int(p)
    if coordinator_address is None:
        coordinator_address = env.get("QV_COORDINATOR")
    if coordinator_address is None:
        init_method = "env://"  # torchrun: MASTER_ADDR / MASTER_PORT
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend=backend or default_backend(device or "cuda"),
        init_method=init_method,
        world_size=num_processes,
        rank=process_id,
    )
    return True


class Mesh:
    """This rank's place on a (dp, pp, tp, sp) mesh of processes. Build it
    with `make_mesh` on every rank in the same order (the process groups
    are made collectively)."""

    def __init__(self, config: MeshConfig, rank: int,
                 groups: Dict[str, Optional[object]],
                 model_group, model_ranks, device: torch.device,
                 control_group=None):
        self.config = config
        self.rank = rank
        self.coords = dict(zip(AXES, _coords(config, rank)))
        self.groups = groups
        self.model_group = model_group  # the pp x tp x sp ranks of one
        # request
        self.model_ranks = model_ranks  # their global ranks, ascending
        self.device = device
        self.control_group = control_group  # every rank, gloo
        # aborted groups, held until no work this rank posted on them is
        # left (comm.unfinished): dropping a gloo group joins its threads
        self._retired: List[object] = []

    def size(self, axis: str) -> int:
        return getattr(self.config, axis)

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        """The process group of `axis`, None when the axis has one rank."""
        return self.groups[axis]

    @property
    def pp(self) -> int:
        return self.config.pp

    @property
    def tp(self) -> int:
        return self.config.tp

    @property
    def sp(self) -> int:
        return self.config.sp

    @property
    def stage(self) -> int:
        """This rank's pipeline stage (0 without pp)."""
        return self.coords["pp"]

    @property
    def is_first_stage(self) -> bool:
        return self.stage == 0

    @property
    def is_last_stage(self) -> bool:
        return self.stage == self.config.pp - 1

    def stage_rank(self, stage: int) -> int:
        """The global rank of `stage` at this rank's dp, tp and sp
        coordinates."""
        coords = dict(self.coords, pp=stage)
        return _rank_of(self.config, [coords[a] for a in AXES])

    @property
    def prev_stage_rank(self) -> Optional[int]:
        """The rank this one receives activations from (None on the first
        stage)."""
        return None if self.is_first_stage else self.stage_rank(self.stage - 1)

    @property
    def next_stage_rank(self) -> Optional[int]:
        """The rank this one sends activations to (None on the last
        stage)."""
        return None if self.is_last_stage else self.stage_rank(self.stage + 1)

    @property
    def is_first(self) -> bool:
        """Rank 0 of its request's ranks: the one that prints and writes."""
        return self.rank == self.model_ranks[0]

    def __repr__(self):
        return (f"Mesh({self.config}, rank={self.rank}, coords="
                f"{self.coords}, device={self.device})")

    def _model_groups(self) -> list:
        """This rank's axis groups and model group (not the control
        group), each once."""
        out = []
        for g in (*self.groups.values(), self.model_group):
            if g is not None and all(g is not h for h in out):
                out.append(g)
        return out

    def abort(self) -> None:
        """End this rank's part in a job that another rank failed (any
        thread; the job's own may be blocked in a collective): every
        collective raises from now on (comm.abandon), and the model's
        groups are aborted through torch.distributed, which ends the NCCL
        work in flight. The groups stay unusable until `rebuild`."""
        comm.abandon()
        _abort_all(self._model_groups())

    def rebuild(self) -> None:
        """Make the model's groups anew after a job in which a rank called
        `abort` (collective: every rank calls it once the job has ended on
        every rank) and swap them into this Mesh in place, where the model
        reads them per call. The old groups are aborted here where they
        were not, the device's work is waited for, and the new groups are
        made in make_mesh's order."""
        old = self._model_groups()
        _abort_all(old)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._retired.extend(old)
        groups, self.model_group, self.model_ranks = _make_model_groups(
            self.config, self.rank)
        self.groups.update(groups)
        comm.reset()
        self.drop_retired()

    def drop_retired(self) -> None:
        """Drop the aborted groups on which no work of this rank is left
        (a peer's dropping its side ends the work this rank left)."""
        self._retired[:] = [g for g in self._retired if comm.unfinished(g)]


def _abort(group) -> None:
    try:
        distributed_c10d._abort_process_group(group)
    except ValueError:
        pass  # aborted already


def _abort_all(groups) -> None:
    """Abort `groups` at once, each from a thread of its own. An NCCL
    communicator's abort waits for the card's work to end, and a kernel
    blocked in another communicator ends only at that one's abort: a rank
    blocked in two groups at once (under pp x tp, a tp collective and a
    send to the next stage) would wait forever on the first abort of a
    sequence."""
    threads = [threading.Thread(target=_abort, args=(g,), daemon=True,
                                name="qv-abort") for g in groups]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def _coords(cfg: MeshConfig, rank: int):
    out = []
    for a in reversed(AXES):
        n = getattr(cfg, a)
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def _rank_of(cfg: MeshConfig, coords) -> int:
    r = 0
    for a, c in zip(AXES, coords):
        r = r * getattr(cfg, a) + c
    return r


def _ranks_along(cfg: MeshConfig, axes, fixed) -> list:
    """Global ranks whose coordinates equal `fixed` off `axes`."""
    ranges = [range(getattr(cfg, a)) if a in axes else [fixed[i]]
              for i, a in enumerate(AXES)]
    return sorted(_rank_of(cfg, c) for c in itertools.product(*ranges))


def _new_groups(cfg: MeshConfig, axes, rank: int):
    """Every group of ranks spanning `axes` (collective: each rank makes
    all of them in the same order); returns (this rank's group, its
    ranks)."""
    mine = None
    ranks_mine = None
    others = [range(getattr(cfg, a)) if a not in axes else [0] for a in AXES]
    for fixed in itertools.product(*others):
        ranks = _ranks_along(cfg, axes, fixed)
        g = dist.new_group(ranks)
        if rank in ranks:
            mine, ranks_mine = g, ranks
    return mine, ranks_mine


def _make_model_groups(cfg: MeshConfig, rank: int):
    """(axis -> this rank's group or None, its model group, the model
    group's ranks), made collectively in one order on every rank."""
    groups = {a: _new_groups(cfg, (a,), rank)[0] if getattr(cfg, a) > 1
              else None for a in AXES}
    model_group, model_ranks = None, [rank]
    if cfg.pp * cfg.tp * cfg.sp > 1:
        model_group, model_ranks = _new_groups(cfg, ("pp", "tp", "sp"), rank)
    return groups, model_group, model_ranks


def make_mesh(cfg: MeshConfig, device=None) -> Mesh:
    """The Mesh of this process. A mesh of one device needs no process
    group; a larger one needs torch.distributed started (init_multihost)
    with exactly cfg.num_devices ranks, and every rank must call this."""
    need = cfg.num_devices
    if need == 1:
        groups = dict.fromkeys(AXES)
        return Mesh(cfg, 0, groups, None, [0], rank_device(device))
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {cfg} needs {need} processes: launch one per rank "
            "(torchrun --nproc-per-node, or torch.multiprocessing) and call "
            "parallel.mesh.init_multihost first"
        )
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"mesh {cfg} needs {need} ranks, the process group "
                         f"has {world}")
    rank = dist.get_rank()
    groups, model_group, model_ranks = _make_model_groups(cfg, rank)
    control = dist.new_group(
        list(range(world)), backend="gloo",
        timeout=datetime.timedelta(seconds=CONTROL_TIMEOUT_S))
    return Mesh(cfg, rank, groups, model_group, model_ranks,
                rank_device(device), control)
