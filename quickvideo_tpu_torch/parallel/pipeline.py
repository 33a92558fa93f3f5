"""Pipeline parallelism over the language stack: layer slabs per stage,
activations passed from stage to stage over torch.distributed.

Counterpart of quickvideo_tpu/parallel/pipeline.py. Stage s of S (the
mesh's pp axis) owns layers [s * L / S, (s + 1) * L / S) and that slab of
the KV cache, so weights and cache both shrink to 1/S per rank
(parallel/sharding.py::stage_params). The JAX package runs one SPMD
program per tick with `ppermute`s and masked `psum`s; here each stage is
its own process and runs the engine's ordinary request loop over its own
layers (prefill/engine.py):

  - per video group, the first stage runs the vision tower, the embedding
    and the scatter; every other stage receives the group's (q_len, C)
    hidden states from the previous one; each runs its layers on its slab
    (pruning and appends stay local to the slab), and every stage but
    the last sends its output on (`push_group`);
  - the send is asynchronous (comm.isend), and its handle is waited on
    before the stage's next send (`_send`) or at `end_stream`. So stage 0
    starts group g + 1 while stage 1 works on group g: the groups ride a
    skewed pipeline as in the JAX `_make_tick`, with no fill or drain
    ticks of junk groups;
  - the rotary rows, the group lengths and the specs are host-side facts
    every rank derives from the same PrefillInputs, and are not sent;
  - sequential passes (the final prefill, scoring, each decode step) run
    the same chain (`chunk`, `decode_step`) and wait on the send: only the
    last stage computes logits, and what they decide (the token, the
    final-prefill logits, a score's two scalars) is broadcast from it to
    every stage over the pp group (`share`), so EOS and stop decisions
    follow from the same value on every rank.

pp changes no arithmetic: each layer runs the same kernels at the same
shapes on the same cache layout as on one rank, and the activation crosses
as its bytes. A pipelined request gives one rank's tokens and final-
prefill logits bit for bit. Under tp each stage's layers hold their tp
slices (tp inside a stage, quickvideo_tpu/parallel/pipeline.py:32-40),
each tp rank sends to the tp rank of its coordinates on the next stage,
and the broadcasts run within each pp group (one per dp, tp, sp place).

The random predictors draw from the generator of the global layer
(language.py::prefill_step_unrolled's `layer0`), so a stage draws what one
rank draws at its layers (ROADMAP C24: the JAX pp path folds one rng for
every group instead).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from quickvideo_tpu_torch.models.qwen25_vl.language import (
    StepSpec,
    compute_logits,
    embed_tokens,
    prefill_step_unrolled,
)
from quickvideo_tpu_torch.ops.kv_cache import KVCache
from quickvideo_tpu_torch.parallel import comm


class PipelinedStack:
    """One request's stage of the language stack: the stage's layers, its
    slab of the KV cache (`cache`: L/S layers, the rank's tp heads), and
    the links to the previous and next stage."""

    def __init__(self, mesh, cfg, params: dict, cache: KVCache,
                 dtype: torch.dtype):
        self.mesh = mesh
        self.cfg = cfg  # the TextConfig
        self.params = params  # the stage's "language" tree
        self.cache = cache
        self.dtype = dtype  # of the activations that cross stages
        self.stages = mesh.pp
        self.stage = mesh.stage
        self.layer0 = self.stage * len(params["layers"])
        self.group = mesh.group("pp")
        self._pending: Optional[comm.PendingSend] = None

    @property
    def is_first(self) -> bool:
        return self.mesh.is_first_stage

    @property
    def is_last(self) -> bool:
        return self.mesh.is_last_stage

    @property
    def layers(self) -> range:
        """The global layers of this stage."""
        return range(self.layer0, self.layer0 + len(self.params["layers"]))

    # -- the chain -----------------------------------------------------------

    def _send(self, x: torch.Tensor) -> None:
        if self._pending is not None:
            self._pending.wait()
        self._pending = comm.isend(x, self.mesh.next_stage_rank, self.group)

    def end_stream(self) -> None:
        """Wait on the last send: every group pushed so far has left this
        stage."""
        if self._pending is not None:
            self._pending.wait()
            self._pending = None

    def push_group(self, x: Optional[torch.Tensor], q_len: int,
                   cos: torch.Tensor, sin: torch.Tensor,
                   specs: Sequence[StepSpec], seed_key=None,
                   min_rows: Optional[int] = None):
        """One block of q_len rows through this stage's layers: `x` (the
        first stage's embeddings; None elsewhere, where it is received),
        cos / sin its rotary rows, `specs` one per global layer. Sends the
        output on without waiting for it to arrive. Returns (the output
        on the last stage, else None; this stage's retained indices, one
        per layer)."""
        if not self.is_first:
            x = comm.recv((q_len, self.cfg.hidden_size), self.dtype,
                          self.mesh.prev_stage_rank, self.group,
                          self.mesh.device)
        x, indices = prefill_step_unrolled(
            self.params, self.cache, x, cos, sin, self.cfg,
            [specs[li] for li in self.layers], min_rows, seed_key,
            self.mesh, self.layer0,
        )
        if self.is_last:
            return x, indices
        self._send(x)
        return None, indices

    def chunk(self, x, q_len, cos, sin, specs, seed_key=None,
              min_rows=None):
        """One sequential pass (push_group, then end_stream): the final
        prefill, a scoring pass or a decode step."""
        out = self.push_group(x, q_len, cos, sin, specs, seed_key, min_rows)
        self.end_stream()
        return out

    def share(self, x: Optional[torch.Tensor], shape, dtype) -> torch.Tensor:
        """The last stage's `x` on every stage (the others pass None)."""
        if not self.is_last:
            x = torch.empty(shape, dtype=dtype, device=self.mesh.device)
        return comm.broadcast(x, self.mesh.stage_rank(self.stages - 1),
                              self.group)

    def share_token(self, token: Optional[int]) -> int:
        """The last stage's token on every stage."""
        t = None
        if self.is_last:
            t = torch.tensor([token], dtype=torch.int64,
                             device=self.mesh.device)
        return int(self.share(t, (1,), torch.int64))

    def decode_step(self, head: dict, token: torch.Tensor, cos, sin,
                    pick) -> int:
        """One decode step over every stage: the first embeds `token` ((1,)
        int64 on the device), each runs its layers at q = 1, the last
        computes the logits and `pick(logits) -> int` chooses the next
        token, which every stage returns. `head` is the stage's language
        tree (embed on the first stage; norm and lm_head on the last)."""
        x = embed_tokens(head, token, self.dtype) if self.is_first else None
        n = self.cfg.num_hidden_layers
        h, _ = self.chunk(x, 1, cos, sin, [StepSpec(q_len=1)] * n)
        nxt = None
        if self.is_last:
            nxt = pick(compute_logits(head, h[0], self.cfg, self.mesh))
        return self.share_token(nxt)

    # -- the whole stack ---------------------------------------------------------

    def gather_lengths(self) -> List[int]:
        """Every layer's valid length, gathered over the stages (the same
        list on every stage)."""
        mine = torch.tensor(self.cache.lengths, dtype=torch.int64,
                            device=self.mesh.device)
        return comm.all_gather(mine, self.group, dim=0).tolist()

    def gather_cache(self) -> KVCache:
        """Every stage's slab as one (L, ...) cache (this rank's tp heads),
        on every stage: for tests and lengths."""
        def whole(t):
            return None if t is None else comm.all_gather(t, self.group,
                                                          dim=0)

        c = self.cache
        return KVCache(k=whole(c.k), v=whole(c.v),
                       lengths=self.gather_lengths(),
                       k_scale=whole(c.k_scale), v_scale=whole(c.v_scale))
