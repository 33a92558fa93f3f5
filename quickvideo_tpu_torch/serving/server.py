"""HTTP serving front end over one LVU engine.

Counterpart of quickvideo_tpu/serving/server.py, with the same routes,
bodies, status codes and statistics:

* **One worker thread owns the device.** The engine mutates a resident KV
  cache, so device work is serialized: HTTP handler threads only enqueue
  jobs and wait. The worker selects the LVU's CUDA device for itself
  (torch keeps the current device and stream per thread), and the frame
  upload's side stream is waited on by the worker's current stream.
* **Same-video micro-batching.** When the worker picks up a `generate`
  job it drains every queued request with the same (video, decode
  settings, generation settings) into one `BatchedQAEngine.generate_batch`
  call: the video decodes and prefills once and each extra question costs
  its own suffix prefill and decode (prefill/batch.py). Frames come
  through `engines.qwen25._fetch_frames`, so the disk frame cache
  (`save_video_cache`) sits behind this path too.
* **Resident chat sessions with disk spill.** `POST /v1/sessions` keeps a
  ChatSession's pruned video KV on the device, so a follow-up pays for
  its own tokens only (chat.py). Beyond `max_resident_sessions` the least
  recently used session spills to disk through ChatSession.save and
  resumes on its next ask.
* **A mesh: rank 0 answers, every rank follows its jobs.** Under a mesh
  (`lvu.mesh`, one process per rank, parallel/mesh.py) every rank must run
  every request, since each request's collectives span the ranks. The
  same script runs on every rank: `make_http_server(lvu, cfg)` binds the
  HTTP port on rank 0 (the leader) only; on the other ranks (followers) it
  returns an object whose `serve_forever()` runs the follow loop. The
  leader's worker thread, and only it, broadcasts each dispatch before any
  device work over the mesh's gloo control group (the job kind, the
  micro-batch's payloads without their stream queues, whether each
  streams), in the order it chose; each follower runs the same
  `_dispatch` with its own sessions, so spills and resumes come at the
  same job everywhere (a spill is itself a collective, chat.py). Where
  the leader streams, a follower passes an `on_tokens` that does nothing,
  so the decode chunks alike. Every rank ends every job alike
  (`_run_job`): the ranks first agree over the control group on what only
  a host can see (the video, a spilled session's file), and a check that
  fails anywhere fails the job on every rank before any device work, as
  the route's 400. A rank whose job fails posts the fault in the store
  behind the process group; a rank still inside the job aborts the
  model's groups (parallel/mesh.py `Mesh.abort`), so that the collective
  it waits in raises. Then every rank joins one agreement on the outcome:
  the leader answers success only where every rank succeeded, else the
  first failing rank's error with the status this server gives it alone
  (the body names the rank where not every rank failed alike); the
  groups are rebuilt where any rank aborted them, and sessions that a
  spill or resume left unlike are closed on every rank. A rank that exits
  fails every later job; one that dies without posting its fault leaves
  the others to the model groups' timeout; one whose job has not ended
  ABORT_BOUND_S after its abort exits. An idle leader sends a
  heartbeat every HEARTBEAT_S, well within the control group's timeout
  (parallel/mesh.py CONTROL_TIMEOUT_S); `shutdown()` on the leader sends a
  stop, and every follower's `serve_forever()` returns. Sessions spill
  into `spill_dir`, which every rank must see (one directory on one host;
  a shared filesystem across hosts).
* **OpenAI-compatible adapter.** `POST /v1/chat/completions` accepts
  `video_url` content parts and returns a `chat.completion` object.
* **Streaming (SSE).** `"stream": true` on /v1/generate,
  /v1/sessions/<id>/ask and /v1/chat/completions switches the response to
  `text/event-stream`: each decoded chunk's new text arrives as a `data:`
  frame ({"delta"}/{"answer"} frames, or OpenAI chat.completion.chunk
  objects on the chat route), ending with `data: [DONE]`. Streaming jobs
  never micro-batch.

Standard library only (http.server + json).

Endpoints:
    GET  /healthz                 liveness
    GET  /v1/models               model card
    GET  /v1/stats                queue depth, batch histogram, timings
    POST /v1/generate             {video, question, ...} -> {answer}
    POST /v1/sessions             {video, ...} -> {session_id}
    POST /v1/sessions/<id>/ask    {question, ...} -> {answer}
    DELETE /v1/sessions/<id>
    POST /v1/chat/completions     OpenAI chat shape with video_url parts
                                  (+ "stream": true -> SSE chunks)

Run: `python -m quickvideo_tpu_torch.serving --device cuda` (the default;
`--device cpu` runs the kernels' plain versions); on a mesh, one process
per rank: `torchrun --nproc-per-node 2 -m quickvideo_tpu_torch.serving
--mesh 1,1,2,1` (dp,pp,tp,sp; rank 0 prints and binds --host / --port).
"""

from __future__ import annotations

import faulthandler
import json
import logging
import os
import queue
import threading
import time
import uuid
from collections import OrderedDict
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import urlparse

# an idle leader's heartbeat to its followers, in seconds: each follower
# waits for its next job inside a collective of the mesh's control group,
# which times out after parallel/mesh.py CONTROL_TIMEOUT_S
HEARTBEAT_S = 60.0
# the payload keys that stay on the leader (a stream's queue and nonce)
_LEADER_ONLY = ("_stream", "_stream_nonce")
# a rank's watch for another rank's fault during a job: how often it looks
# at the store, and how long it lets the job end by itself before it
# aborts the model's groups (an error that every rank meets at the same
# point ends every rank's job at once and costs no abort)
FAULT_POLL_S = 0.05
FAULT_GRACE_S = 0.5
# how long a rank that aborted the model's groups waits for its job to end,
# and then for the groups' rebuild, before it exits: a rank whose card or
# communicators cannot be released ends as a rank that exits does (the
# others find it gone), not in a hang
ABORT_BOUND_S = 30.0


@dataclass
class ServerConfig:
    host: str = "127.0.0.1"
    port: int = 8000
    max_batch: int = 8
    max_resident_sessions: int = 1
    spill_dir: Optional[str] = None  # default: <tmp>/qv_sessions
    request_timeout_s: float = 600.0
    default_max_new_tokens: int = 128
    # overload guards: oversized request bodies are rejected before they
    # are read (HTTP 413), and requests beyond the queue bound are shed at
    # once (HTTP 503) instead of piling up behind a long video prefill
    # until they all time out at 504
    max_body_bytes: int = 8 << 20
    max_queue_depth: int = 64


class RequestError(ValueError):
    """Client-side error -> HTTP 400."""


class BodyTooLargeError(RequestError):
    """Request body over ServerConfig.max_body_bytes -> HTTP 413."""


class OverloadedError(RuntimeError):
    """Work queue at max_queue_depth -> HTTP 503 (load shedding)."""


class RankFault(RuntimeError):
    """A job that failed on a mesh, as every rank agreed it: the first
    failing rank (None: every rank met the same error) and its error's
    type name and message. The leader answers it with the status and body
    the one-process server gives that error (400 for a RequestError, else
    500); the body names the rank where not every rank failed alike."""

    def __init__(self, rank: Optional[int], type_name: str, message: str,
                 request_error: bool):
        where = "every rank" if rank is None else f"rank {rank}"
        super().__init__(f"{where}: {type_name}: {message}")
        self.rank, self.type_name = rank, type_name
        self.message, self.request_error = message, request_error

    @property
    def status(self) -> int:
        return 400 if self.request_error else 500

    def body(self) -> dict:
        body = {"error": self.message if self.request_error
                else f"{self.type_name}: {self.message}"}
        if self.rank is not None:
            body["rank"] = self.rank
        return body


@dataclass
class _Job:
    kind: str                      # generate | session_new | ask | close | chat
    payload: dict
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[dict] = None
    error: Optional[BaseException] = None


def _gen_key(p: dict):
    """Jobs batch together only when every knob that generate_batch applies
    batch-wide is identical (same sampling, same token budget) and the video
    geometry is shared (same path + decode settings). Streaming jobs carry a
    unique nonce so they never micro-batch (the batched engine has no
    per-sample token callback)."""
    return (
        p["video"],
        tuple(sorted(p.get("video_kwargs", {}).items())),
        p["max_new_tokens"],
        p["greedy"],
        p["temperature"],
        p["top_p"],
        p["top_k"],
        p.get("_stream_nonce"),
    )


class LVUServer:
    """Request scheduler + session manager over one LVU instance."""

    def __init__(self, lvu, cfg: Optional[ServerConfig] = None):
        self.lvu = lvu
        self.cfg = cfg or ServerConfig()
        mesh = getattr(lvu, "mesh", None)
        # the gloo group that carries jobs to the followers (None: one
        # device); rank 0 leads
        self._control = None if mesh is None else mesh.control_group
        self.is_leader = mesh is None or mesh.rank == 0
        self._broken: Optional[BaseException] = None
        # where a rank posts its fault during a job: the store behind the
        # process group, reachable from every rank without a collective
        self._store = None
        if mesh is not None:
            from torch.distributed import distributed_c10d

            self._store = distributed_c10d._get_default_store()
        # the sessions this job spilled and resumed (uncounted where a
        # failed job's reconciliation closes them)
        self._job_spilled: List[str] = []
        self._job_resumed: List[str] = []
        self.spill_dir = self.cfg.spill_dir or os.path.join(
            os.environ.get("TMPDIR", "/tmp"), "qv_sessions"
        )
        self._q: "queue.Queue[_Job]" = queue.Queue()
        self._sessions: "OrderedDict[str, object]" = OrderedDict()  # resident
        self._spilled: Dict[str, str] = {}  # sid -> npz path
        self._batched = None
        try:
            from quickvideo_tpu_torch.prefill.batch import BatchedQAEngine

            self._batched = BatchedQAEngine(lvu.engine)
        except ValueError:
            # config rejects batched mode (query-based predictors):
            # generate jobs fall back to sequential single-sample calls
            pass
        self.stats = {
            "requests": 0,
            "errors": 0,
            "batches": {},        # batch size -> count
            "spills": 0,
            "resumes": 0,
            "last_e2e_s": None,
        }
        self._paused = threading.Event()
        self._paused.set()  # set == running
        self._admitted = 0  # submitted-and-unfinished request count
        self._admit_lock = threading.Lock()
        self._stop = False
        self._worker = None
        if self.is_leader:
            self._worker = threading.Thread(
                target=self._work_loop, name="lvu-worker", daemon=True
            )
            self._worker.start()

    # ---- client-facing (any thread) -------------------------------------

    def submit(self, kind: str, payload: dict) -> dict:
        # shed at admission: a bounded in-flight count keeps tail latency
        # honest (the client retries against another replica instead of
        # waiting out a 504 behind max_queue_depth video prefills). Counts
        # admitted-and-unfinished jobs, not queue size — the worker moves
        # jobs off the queue into its pending batch before running them.
        with self._admit_lock:
            if self._admitted >= self.cfg.max_queue_depth:
                self.stats["shed"] = self.stats.get("shed", 0) + 1
                raise OverloadedError(
                    f"queue at max_queue_depth={self.cfg.max_queue_depth}; "
                    "retry later"
                )
            self._admitted += 1
        try:
            job = _Job(kind, payload)
            self._q.put(job)
            if not job.done.wait(self.cfg.request_timeout_s):
                raise TimeoutError(f"request timed out after "
                                   f"{self.cfg.request_timeout_s:.0f}s")
        finally:
            with self._admit_lock:
                self._admitted -= 1
        if job.error is not None:
            raise job.error
        return job.result

    def submit_stream(self, kind: str, payload: dict) -> _Job:
        """Streaming admission: enqueue a job whose worker-side handler
        pushes incremental text deltas into a per-job queue. Returns the
        job immediately; iterate `stream_events(job)` to consume (the
        generator owns the admission slot and releases it when the stream
        ends)."""
        with self._admit_lock:
            if self._admitted >= self.cfg.max_queue_depth:
                self.stats["shed"] = self.stats.get("shed", 0) + 1
                raise OverloadedError(
                    f"queue at max_queue_depth={self.cfg.max_queue_depth}; "
                    "retry later"
                )
            self._admitted += 1
        payload["_stream"] = queue.Queue()
        payload["_stream_nonce"] = uuid.uuid4().hex
        job = _Job(kind, payload)
        self._q.put(job)
        return job

    def stream_events(self, job: _Job):
        """Yield {"delta": str} events as tokens materialize, then the
        final {"answer": str}. Raises the job's error (after draining) the
        way submit() would."""
        q = job.payload["_stream"]
        deadline = time.monotonic() + self.cfg.request_timeout_s
        try:
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"stream timed out after "
                        f"{self.cfg.request_timeout_s:.0f}s"
                    )
                try:
                    ev = q.get(timeout=left)
                except queue.Empty:
                    raise TimeoutError(
                        f"stream timed out after "
                        f"{self.cfg.request_timeout_s:.0f}s"
                    ) from None
                if ev is None:
                    break
                yield ev
            if job.error is not None:
                raise job.error
        finally:
            with self._admit_lock:
                self._admitted -= 1

    def _stream_cb(self, p: dict):
        """The on_tokens of a streaming payload (None when the request is
        not streaming); the final answer frame comes with the job's
        release. Text deltas re-decode the full token prefix each push —
        per-token decode corrupts multi-byte/BPE-merge boundaries."""
        sq = p.get("_stream")
        if sq is None:
            if p.get("_streamed"):
                # a follower's copy of a streamed job: the decode chunks as
                # on the leader, whose stream alone is read
                return lambda new: None
            return None
        tok = self.lvu.tokenizer
        eos = {tok.eos_token_id}
        acc: List[int] = []
        state = {"text": ""}

        def on_tokens(new):
            acc.extend(int(t) for t in new)
            text = tok.decode([t for t in acc if t not in eos])
            delta = text[len(state["text"]):]
            state["text"] = text
            if delta:
                sq.put({"delta": delta})

        return on_tokens

    def _complete(self, job: _Job, result: dict) -> None:
        """Record a job's result. Alone the server answers it at once;
        under a mesh the worker does once every rank has agreed that the
        job succeeded."""
        job.result = result
        if self._control is None:
            self._release(job)

    @staticmethod
    def _release(job: _Job) -> None:
        """Answer a job: its stream's final frame, then its waiter."""
        sq = job.payload.get("_stream")
        if sq is not None:
            sq.put({"answer": job.result["answer"]})
            sq.put(None)
        job.done.set()

    def pause(self):
        """Hold the worker before its next job (drain point; also lets
        tests queue a burst deterministically)."""
        self._paused.clear()

    def resume(self):
        self._paused.set()

    def shutdown(self):
        """Stop the worker after its job in flight; under a mesh it then
        stops the followers. A follower's shutdown does nothing: its loop
        ends at the leader's stop."""
        self._stop = True
        self._paused.set()
        if self._worker is None:
            return
        self._q.put(_Job("noop", {}))
        # under a mesh the followers wait for the stop the worker sends
        # once its job in flight ends
        self._worker.join(
            timeout=10 if self._control is None
            else self.cfg.request_timeout_s)

    # ---- the mesh's control channel (leader: worker thread only) ---------

    def _send(self, kind: str, batch: List[_Job],
              job_id: Optional[str] = None) -> None:
        """Broadcast a dispatch to the followers before any device work:
        the kind, each payload without what stays on the leader, and the
        job's id (the key of its faults). A failure (a follower has
        exited) fails this and every later job: the leader does not serve
        on alone."""
        if self._control is None:
            return
        if self._broken is not None:
            raise RuntimeError(
                "a follower rank left the mesh; the server cannot serve "
                f"without it: {self._broken}") from self._broken
        payloads = []
        for j in batch:
            p = {k: v for k, v in j.payload.items() if k not in _LEADER_ONLY}
            if "_stream" in j.payload:
                p["_streamed"] = True
            payloads.append(p)
        import torch.distributed as dist

        try:
            dist.broadcast_object_list([(kind, payloads, job_id)], src=0,
                                       group=self._control)
        except BaseException as e:  # noqa: BLE001 - fails the jobs
            self._broken = e
            raise RuntimeError(
                "a follower rank did not take the job; the server cannot "
                f"serve without it: {e}") from e

    def _next_job(self) -> _Job:
        """The next queued job; under a mesh an idle wait sends a
        heartbeat every HEARTBEAT_S."""
        if self._control is None:
            return self._q.get()
        while True:
            try:
                return self._q.get(timeout=HEARTBEAT_S)
            except queue.Empty:
                self._heartbeat()

    def _heartbeat(self) -> None:
        if self._broken is None:
            try:
                self._send("noop", [])
            except RuntimeError:
                pass  # recorded in _broken: every later job fails

    def _wait_running(self) -> None:
        """Hold while paused; under a mesh with heartbeats."""
        if self._control is None:
            self._paused.wait()
            return
        while not self._paused.wait(HEARTBEAT_S):
            self._heartbeat()

    def follow(self) -> None:
        """A follower's loop: run each job the leader broadcasts, through
        the same `_run_job`, until the leader's stop. A job that failed on
        any rank ends here as on the leader, which answers it; the
        follower goes on to the next job."""
        import torch.distributed as dist

        self._bind_device()
        while True:
            msg = [None]
            dist.broadcast_object_list(msg, src=0, group=self._control)
            kind, payloads, job_id = msg[0]
            if kind == "stop":
                return
            if kind == "noop":
                continue
            batch = [_Job(kind, p) for p in payloads]
            try:
                self._run_job(batch, job_id)
            except RankFault as e:  # the leader answers it
                self.stats["errors"] += len(batch)
                logging.getLogger(__name__).warning(
                    "rank %d: %s job failed on %s", self.lvu.mesh.rank,
                    kind, e)

    # ---- one job on every rank of a mesh (leader: worker thread) ---------

    def _run_job(self, batch: List[_Job], job_id: str) -> None:
        """Run a job on this rank of a mesh; every rank runs each job in
        the same order. First the ranks agree on what only a host can see
        (`_host_problem`); then the job runs under a watch for another
        rank's fault: a rank that fails posts it under the job's key, and
        a rank still inside the job aborts the model's groups, so that a
        collective it is blocked in raises; then every rank joins the
        agreement on the outcome, the groups are rebuilt where any rank
        aborted them, and a failed job's sessions are made alike. Raises
        the agreed RankFault on every rank where any rank failed."""
        mesh = self.lvu.mesh
        problem = self._host_problem(batch)
        if self._any(problem is not None):
            problems = self._gather(problem)
            bad = next(r for r, p in enumerate(problems) if p is not None)
            raise RankFault(_named(problems, bad), "RequestError",
                            problems[bad], True)
        self._job_spilled, self._job_resumed = [], []
        key = f"qv_fault/{job_id}"
        watch = _FaultWatch(self._store, key, mesh)
        error = None
        try:
            self._dispatch(batch)
        except Exception as e:  # noqa: BLE001 - agreed below
            error = (type(e).__name__, str(e), isinstance(e, RequestError))
        finally:
            aborted = watch.end()
        if error is not None and not aborted:
            # failed by itself: the other ranks may wait for it in a
            # collective
            self._store.set(key, json.dumps([mesh.rank, *error[:2]]))
            logging.getLogger(__name__).warning(
                "rank %d: %s job failed: %s: %s", mesh.rank, batch[0].kind,
                *error[:2])
            self._check_device()
        if not self._any(error is not None or aborted):
            mesh.drop_retired()
            return
        outcomes = self._gather((error, aborted))
        if any(a for _, a in outcomes):
            bound = _Bound(mesh.rank, "the rebuild of the model's groups")
            mesh.rebuild()
            bound.cancel()
        failed = [r for r, (e, _) in enumerate(outcomes) if e is not None]
        if failed:
            self._reconcile_sessions()
        mesh.drop_retired()
        if failed:
            # the rank whose own error ended the job, not one that left
            # it because of that error
            first = next((r for r in failed if not outcomes[r][1]),
                         failed[0])
            raise RankFault(_named([e for e, _ in outcomes], first),
                            *outcomes[first][0])

    def _any(self, flag: bool) -> bool:
        """Whether `flag` holds on any rank: one all-reduce of one number
        over the control group (a job that every rank ends well costs no
        more)."""
        import torch
        import torch.distributed as dist

        x = torch.tensor([int(flag)])
        self._control_op(dist.all_reduce, x, op=dist.ReduceOp.MAX)
        return bool(x.item())

    def _gather(self, obj) -> list:
        """Every rank's `obj`, by rank, over the control group."""
        import torch.distributed as dist

        out = [None] * dist.get_world_size(self._control)
        self._control_op(dist.all_gather_object, out, obj)
        return out

    def _control_op(self, collective, *args, **kw) -> None:
        """`collective` over the control group during a job. A failure (a
        rank has exited) fails this job and, on the leader, every later
        one, as in `_send`."""
        try:
            collective(*args, group=self._control, **kw)
        except Exception as e:  # noqa: BLE001 - fails the job
            if self.is_leader:
                self._broken = e
            raise RuntimeError(
                "a follower rank left the mesh during a job; the server "
                f"cannot serve without it: {e}") from e

    def _host_problem(self, batch: List[_Job]) -> Optional[str]:
        """What this rank's host lacks for the job, as the RequestError's
        message (None: nothing): a video that is not there (the route
        checks it on the leader's host alone), a spilled session's file
        for its resume."""
        for j in batch:
            p = j.payload
            where = None
            if j.kind in ("generate", "session_new"):
                where = p["video"]
            elif j.kind == "ask":
                where = self._spilled.get(p["session_id"])
            if where is None:
                continue
            if where.startswith("unmaterialized:"):
                where = where.split(":", 1)[1]
            elif j.kind == "ask":
                if not os.path.exists(where):
                    return f"spilled session file not found: {where}"
                continue
            if not os.path.exists(where):
                return f"video not found: {where}"
        return None

    def _check_device(self) -> None:
        """Raise where this rank's card has a sticky error (the job's own
        ended it): the rank then exits, and the others find it gone."""
        device = getattr(self.lvu, "device", None)
        if device is not None and device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)

    def _reconcile_sessions(self) -> None:
        """After a failed job, close on every rank each session that the
        ranks no longer hold alike (a spill or a resume failed on some of
        them), so that a later ask finds it unknown everywhere, as the
        one-process server finds a session whose spill failed. A spill or
        resume of such a session in this job is not counted."""
        table = {sid: "resident" for sid in self._sessions}
        table.update((sid, "spilled") for sid in self._spilled)
        tables = self._gather(table)
        differ = {sid for t in tables for sid in t
                  if any(u.get(sid) != t[sid] for u in tables)}
        for sid in sorted(differ):
            self._forget(sid)
            self.stats["spills"] -= self._job_spilled.count(sid)
            self.stats["resumes"] -= self._job_resumed.count(sid)

    # ---- worker (single thread owns ALL device work) ---------------------

    def _bind_device(self):
        """Make the LVU's card this thread's current device (torch keeps
        it per thread); a device given without an index means the card
        that is current where the LVU was built, as torch reads it."""
        device = getattr(self.lvu, "device", None)
        if device is not None and device.type == "cuda":
            import torch

            index = device.index
            torch.cuda.set_device(
                torch.cuda.current_device() if index is None else index)

    def _work_loop(self):
        try:
            self._bind_device()
            setup_error = None
        except BaseException as e:  # noqa: BLE001 - reported per-job
            setup_error = e
        pending: List[_Job] = []
        while True:
            job = pending.pop(0) if pending else self._next_job()
            self._wait_running()
            if self._stop:
                for j in pending:
                    j.error = RuntimeError("server shut down")
                    j.done.set()
                job.error = RuntimeError("server shut down")
                job.done.set()
                if self._control is not None and self._broken is None:
                    try:
                        self._send("stop", [])
                    except RuntimeError:
                        pass  # a follower has gone already
                return
            if job.kind == "noop":
                job.done.set()
                continue
            batch = [job]
            if job.kind == "generate":
                # opportunistic drain: batch every queued compatible
                # generate request with this one; anything else keeps its
                # arrival order via the local pending list
                key = _gen_key(job.payload)
                while len(batch) < self.cfg.max_batch:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if (nxt.kind == "generate"
                            and _gen_key(nxt.payload) == key):
                        batch.append(nxt)
                    else:
                        pending.append(nxt)
            t0 = time.monotonic()
            try:
                if setup_error is not None:
                    raise RuntimeError(
                        "the server's worker could not select its device: "
                        f"{setup_error}") from setup_error
                if job.kind == "session_new":
                    # drawn here, so that every rank keeps the same id
                    job.payload.setdefault("session_id", uuid.uuid4().hex[:16])
                if self._control is None:
                    self._dispatch(batch)
                else:
                    job_id = uuid.uuid4().hex
                    self._send(job.kind, batch, job_id)
                    self._run_job(batch, job_id)
                    for j in batch:
                        self._release(j)
                self.stats["last_e2e_s"] = round(time.monotonic() - t0, 3)
            except BaseException as e:  # noqa: BLE001 - reported per-job
                self.stats["errors"] += len(batch)
                for j in batch:
                    j.error = e
                    j.done.set()
                    sq = j.payload.get("_stream")
                    if sq is not None:
                        sq.put(None)  # unblock the stream consumer; it
                        # re-raises j.error after draining

    def _dispatch(self, batch: List[_Job]):
        kind = batch[0].kind
        self.stats["requests"] += len(batch)
        if kind == "generate":
            self._do_generate(batch)
            return
        (job,) = batch
        handler = {
            "session_new": self._do_session_new,
            "ask": self._do_ask,
            "close": self._do_close,
            "chat": self._do_chat,
        }.get(kind)
        if handler is None:
            raise RequestError(f"unknown job kind {kind!r}")
        self._complete(job, handler(job.payload))

    # ---- generate (batched) ----------------------------------------------

    def _do_generate(self, batch: List[_Job]):
        p0 = batch[0].payload
        size = len(batch)
        self.stats["batches"][size] = self.stats["batches"].get(size, 0) + 1
        if self._batched is None or size == 1:
            # single request (or batched mode unavailable): the engine's
            # plain path, still on this worker thread
            for j in batch:
                p = j.payload
                on_tokens = self._stream_cb(p)
                texts = self.lvu.generate(
                    p["question"], p["video"],
                    max_new_tokens=p["max_new_tokens"],
                    do_sample=not p["greedy"],
                    temperature=p["temperature"],
                    top_p=p["top_p"], top_k=p["top_k"],
                    on_tokens=on_tokens,
                    **p.get("video_kwargs", {}),
                )
                self._complete(j, {"answer": texts[0]})
            return

        from quickvideo_tpu_torch.engines.qwen25 import (
            _config_with_video_kwargs,
            _fetch_frames,
        )
        from quickvideo_tpu_torch.tokenization import build_chat_ids
        from quickvideo_tpu_torch.utils.timing import SpanTimer
        from quickvideo_tpu_torch.video import reader as vreader

        lvu = self.lvu
        timer = SpanTimer()
        # decode + H2D once for the whole batch (identical video settings
        # by _gen_key), then one shared prefill + per-question forks
        vcfg = _config_with_video_kwargs(
            lvu, dict(p0.get("video_kwargs", {})), {}
        )
        frames, plan, native_hw = _fetch_frames(lvu, p0["video"], timer, vcfg)
        n_video_tokens = sum(plan.tokens_per_group)
        reqs = []
        for j in batch:
            ids = build_chat_ids(
                lvu.tokenizer, lvu.model_config,
                j.payload["question"], n_video_tokens,
            )
            reqs.append(vreader.build_prefill_inputs_from_frames(
                frames, plan, ids, native_hw=native_hw
            ))
        token_lists = self._batched.generate_batch(
            reqs,
            max_new_tokens=p0["max_new_tokens"],
            eos_token_ids=[lvu.tokenizer.eos_token_id],
            greedy=p0["greedy"],
            temperature=p0["temperature"],
            top_p=p0["top_p"],
            top_k=p0["top_k"],
        )
        for j, toks in zip(batch, token_lists):
            self._complete(j, {"answer": self._decode([int(t) for t in toks])})

    def _decode(self, tokens: List[int]) -> str:
        # exactly the single-sample path's decode (engines/qwen25.py
        # _generate): batched and unbatched answers stay byte-identical
        tok = self.lvu.tokenizer
        eos = [tok.eos_token_id]
        return tok.decode([t for t in tokens if t not in eos])

    # ---- sessions ----------------------------------------------------------

    def _touch(self, sid: str):
        self._sessions.move_to_end(sid)

    def _evict_to_fit(self):
        while len(self._sessions) > self.cfg.max_resident_sessions:
            old_sid, sess = self._sessions.popitem(last=False)
            os.makedirs(self.spill_dir, exist_ok=True)
            path = os.path.join(self.spill_dir, f"{old_sid}.npz")
            if getattr(sess, "_cache", None) is None:
                # no ask yet: nothing on device to spill; recreate lazily
                self._spilled[old_sid] = "unmaterialized:" + sess.video_path
                continue
            sess.save(path)
            self._spilled[old_sid] = path
            self.stats["spills"] += 1
            self._job_spilled.append(old_sid)

    def _resident(self, sid: str):
        if sid in self._sessions:
            self._touch(sid)
            return self._sessions[sid]
        where = self._spilled.pop(sid, None)
        if where is None:
            raise RequestError(f"unknown session {sid!r}")
        if where.startswith("unmaterialized:"):
            sess = self.lvu.start_chat(where.split(":", 1)[1])
        else:
            sess = self.lvu.resume_chat(where)
            self.stats["resumes"] += 1
            self._job_resumed.append(sid)
        self._sessions[sid] = sess
        self._evict_to_fit()
        return sess

    def _do_session_new(self, p: dict) -> dict:
        video = p["video"]
        if not os.path.exists(video):
            raise RequestError(f"video not found: {video}")
        sid = p["session_id"]  # drawn by the leader's worker
        self._sessions[sid] = self.lvu.start_chat(
            video, **p.get("video_kwargs", {})
        )
        self._evict_to_fit()
        return {"session_id": sid}

    def _do_ask(self, p: dict) -> dict:
        sess = self._resident(p["session_id"])
        answer = sess.ask(
            p["question"], max_new_tokens=p["max_new_tokens"],
            do_sample=not p["greedy"], temperature=p["temperature"],
            top_p=p["top_p"], top_k=p["top_k"],
            on_tokens=self._stream_cb(p),
        )
        return {"answer": answer}

    def _forget(self, sid: str) -> bool:
        """Drop a session, resident or spilled (its file too); whether it
        was known."""
        found = self._sessions.pop(sid, None) is not None
        where = self._spilled.pop(sid, None)
        if where and not where.startswith("unmaterialized:"):
            try:
                os.unlink(where)
            except OSError:
                pass
        return found or where is not None

    def _do_close(self, p: dict) -> dict:
        sid = p["session_id"]
        if not self._forget(sid):
            raise RequestError(f"unknown session {sid!r}")
        return {"closed": sid}

    # ---- OpenAI chat adapter ------------------------------------------------

    def _do_chat(self, p: dict) -> dict:
        texts = self.lvu.chat(
            p["messages"],
            max_new_tokens=p["max_new_tokens"],
            do_sample=not p["greedy"],
            temperature=p["temperature"],
            top_p=p["top_p"], top_k=p["top_k"],
            on_tokens=self._stream_cb(p),
        )
        return {"answer": texts[0]}


def _named(per_rank: list, rank: int) -> Optional[int]:
    """`rank`, unless every rank's entry is the same (an error every rank
    met alike names none)."""
    return None if all(x == per_rank[0] for x in per_rank) else rank


class _FaultWatch:
    """A rank's watch, from a thread of its own, for another rank's fault
    during one job: once the job's key appears in the store and the job
    has not ended within FAULT_GRACE_S, the mesh's groups are aborted, and
    the job has ABORT_BOUND_S more to end."""

    def __init__(self, store, key: str, mesh):
        self._store, self._key, self._mesh = store, key, mesh
        self._ended = threading.Event()
        self._lock = threading.Lock()
        self.aborted = False
        self._bound: Optional[_Bound] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="lvu-fault-watch")
        self._thread.start()

    def _run(self):
        while not self._ended.wait(FAULT_POLL_S):
            try:
                if self._store.check([self._key]):
                    break
            except Exception:  # noqa: BLE001 - the store's host has gone,
                return  # and with it the job's collectives
        else:
            return
        if self._ended.wait(FAULT_GRACE_S):
            return
        with self._lock:
            if self._ended.is_set():
                return
            self.aborted = True
            self._bound = _Bound(self._mesh.rank, "its job")
        logging.getLogger(__name__).warning(
            "rank %d: another rank failed the job (%s); aborting the "
            "model's groups", self._mesh.rank, self._key)
        self._mesh.abort()

    def end(self) -> bool:
        """The job has ended on this rank; whether the watch aborted it."""
        with self._lock:
            self._ended.set()
        self._thread.join()
        if self._bound is not None:
            self._bound.cancel()
        return self.aborted


class _Bound:
    """Exit the process unless `cancel` comes within ABORT_BOUND_S, with
    every thread's stack on stderr."""

    def __init__(self, rank: int, what: str):
        self._timer = threading.Timer(ABORT_BOUND_S, self._expire,
                                      args=(rank, what))
        self._timer.daemon = True
        self._timer.start()

    @staticmethod
    def _expire(rank: int, what: str) -> None:
        logging.getLogger(__name__).error(
            "rank %d: %s did not end within %.0f s of the abort of the "
            "model's groups; the rank exits", rank, what, ABORT_BOUND_S)
        faulthandler.dump_traceback(all_threads=True)
        os._exit(1)

    def cancel(self) -> None:
        self._timer.cancel()


# ---- OpenAI message translation ------------------------------------------


def _video_path_from_url(url: str) -> str:
    u = urlparse(url)
    if u.scheme in ("", "file"):
        return u.path or url
    raise RequestError(
        f"only local/file:// video URLs are served here, got {url!r}"
    )


def openai_to_reference_messages(messages: list) -> list:
    """OpenAI content parts -> the reference-style messages that LVU.chat
    consumes (reference lvu/models/qwen25_lvu.py message schema: parts with
    type 'video'/'text', optional fps/max_frames keys on the video part)."""
    out = []
    for m in messages:
        content = m.get("content")
        if isinstance(content, str):
            out.append({"role": m["role"], "content": content})
            continue
        parts = []
        for part in content or []:
            t = part.get("type")
            if t == "video_url":
                vp = dict(part.get("video_url") or {})
                url = vp.pop("url", "")
                parts.append(
                    {"type": "video",
                     "video": _video_path_from_url(url), **vp}
                )
            elif t in ("video", "text"):
                parts.append(part)
            elif t == "image_url":
                raise RequestError("image parts are not supported; send a "
                                   "video_url part")
            else:
                raise RequestError(f"unsupported content part type {t!r}")
        out.append({"role": m["role"], "content": parts})
    return out


# ---- HTTP layer ------------------------------------------------------------


def _gen_payload(body: dict, server: LVUServer) -> dict:
    vkw = {}
    for k in ("fps", "num_frames", "nframes"):
        if k in body:
            vkw[k] = body[k]
    return {
        "video": body.get("video"),
        "question": body.get("question"),
        "video_kwargs": vkw,
        "max_new_tokens": int(
            body.get("max_new_tokens",
                     server.cfg.default_max_new_tokens)
        ),
        "greedy": not body.get("do_sample", False),
        "temperature": float(body.get("temperature", 1.0)),
        "top_p": body.get("top_p"),
        "top_k": body.get("top_k"),
    }


class _Handler(BaseHTTPRequestHandler):
    server_version = "quickvideo-tpu-torch"
    protocol_version = "HTTP/1.1"

    # set by make_http_server
    lvu_server: LVUServer = None

    def log_message(self, fmt, *args):  # quiet by default
        if os.environ.get("QV_SERVE_VERBOSE"):
            super().log_message(fmt, *args)

    def _json(self, code: int, obj: dict):
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _sse(self, job, openai: bool = False):
        """Write the job's stream as Server-Sent Events. Plain mode frames
        are {"delta": ...} then {"answer": ...}; openai mode wraps them as
        chat.completion.chunk objects. Always ends with `data: [DONE]`."""
        s = self.lvu_server
        cid = "chatcmpl-" + uuid.uuid4().hex[:24]
        model = s.lvu.config.model_name_or_path
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        # no Content-Length: SSE body length is unknown, so the connection
        # closes at stream end instead of keep-alive
        self.send_header("Connection", "close")
        self.close_connection = True
        self.end_headers()

        def w(obj):
            self.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
            self.wfile.flush()

        first = True
        try:
            for ev in s.stream_events(job):
                if not openai:
                    w(ev)
                elif "delta" in ev:
                    delta = {"content": ev["delta"]}
                    if first:
                        delta["role"] = "assistant"
                        first = False
                    w({"id": cid, "object": "chat.completion.chunk",
                       "model": model,
                       "choices": [{"index": 0, "delta": delta,
                                    "finish_reason": None}]})
                else:  # final answer frame
                    w({"id": cid, "object": "chat.completion.chunk",
                       "model": model,
                       "choices": [{"index": 0, "delta": {},
                                    "finish_reason": "stop"}]})
        except BaseException as e:  # noqa: BLE001 - mid-stream: in-band
            w(e.body() if isinstance(e, RankFault)
              else {"error": f"{type(e).__name__}: {e}"})
        self.wfile.write(b"data: [DONE]\n\n")
        self.wfile.flush()

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        limit = self.lvu_server.cfg.max_body_bytes
        if n > limit:
            # close the connection rather than reading an oversized body —
            # draining it would be the resource exhaustion we're preventing
            self.close_connection = True
            raise BodyTooLargeError(
                f"request body {n} bytes exceeds max_body_bytes={limit}"
            )
        raw = self.rfile.read(n) if n else b"{}"
        try:
            body = json.loads(raw or b"{}")
        except json.JSONDecodeError as e:
            raise RequestError(f"invalid JSON body: {e}") from e
        if not isinstance(body, dict):
            raise RequestError("JSON body must be an object")
        return body

    def _route(self, method: str):
        s = self.lvu_server
        path = self.path.split("?", 1)[0].rstrip("/")
        try:
            if method == "GET":
                if path == "/healthz":
                    return self._json(200, {"status": "ok"})
                if path == "/v1/models":
                    lvu = s.lvu
                    return self._json(200, {
                        "object": "list",
                        "data": [{
                            "id": lvu.config.model_name_or_path,
                            "object": "model",
                            "model_type": lvu.config.model_type,
                            "param_dtype": lvu.config.param_dtype,
                        }],
                    })
                if path == "/v1/stats":
                    st = dict(s.stats)
                    st["queue_depth"] = s._q.qsize()
                    st["resident_sessions"] = len(s._sessions)
                    st["spilled_sessions"] = len(s._spilled)
                    return self._json(200, st)
                return self._json(404, {"error": f"no route {path}"})

            if method == "DELETE":
                if path.startswith("/v1/sessions/"):
                    sid = path.split("/")[3]
                    return self._json(
                        200, s.submit("close", {"session_id": sid})
                    )
                return self._json(404, {"error": f"no route {path}"})

            # POST
            body = self._body()
            if path == "/v1/generate":
                p = _gen_payload(body, s)
                if not p["video"] or p["question"] is None:
                    raise RequestError("'video' and 'question' are required")
                if not os.path.exists(p["video"]):
                    raise RequestError(f"video not found: {p['video']}")
                if body.get("stream"):
                    return self._sse(s.submit_stream("generate", p))
                return self._json(200, s.submit("generate", p))
            if path == "/v1/sessions":
                if not body.get("video"):
                    raise RequestError("'video' is required")
                p = _gen_payload(body, s)
                return self._json(200, s.submit("session_new", {
                    "video": body["video"],
                    "video_kwargs": p["video_kwargs"],
                }))
            if path.startswith("/v1/sessions/") and path.endswith("/ask"):
                sid = path.split("/")[3]
                p = _gen_payload(body, s)
                if p["question"] is None:
                    raise RequestError("'question' is required")
                p["session_id"] = sid
                if body.get("stream"):
                    return self._sse(s.submit_stream("ask", p))
                return self._json(200, s.submit("ask", p))
            if path == "/v1/chat/completions":
                msgs = body.get("messages")
                if not msgs:
                    raise RequestError("'messages' is required")
                p = _gen_payload(body, s)
                p["max_new_tokens"] = int(
                    body.get("max_tokens",
                             body.get("max_new_tokens",
                                      s.cfg.default_max_new_tokens))
                )
                p["messages"] = openai_to_reference_messages(msgs)
                if body.get("stream"):
                    return self._sse(
                        s.submit_stream("chat", p), openai=True
                    )
                out = s.submit("chat", p)
                return self._json(200, {
                    "id": "chatcmpl-" + uuid.uuid4().hex[:24],
                    "object": "chat.completion",
                    "model": s.lvu.config.model_name_or_path,
                    "choices": [{
                        "index": 0,
                        "message": {"role": "assistant",
                                    "content": out["answer"]},
                        "finish_reason": "stop",
                    }],
                })
            return self._json(404, {"error": f"no route {path}"})
        except BodyTooLargeError as e:
            return self._json(413, {"error": str(e)})
        except RequestError as e:
            return self._json(400, {"error": str(e)})
        except RankFault as e:
            return self._json(e.status, e.body())
        except OverloadedError as e:
            return self._json(503, {"error": str(e)})
        except TimeoutError as e:
            return self._json(504, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 - boundary: report, don't die
            return self._json(500, {"error": f"{type(e).__name__}: {e}"})

    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def do_DELETE(self):
        self._route("DELETE")


class _Follower:
    """What make_http_server returns in place of the HTTP server on a
    follower rank: `serve_forever()` runs the follow loop and returns at
    the leader's stop; it binds no port."""

    server_address = None

    def __init__(self, lvu_server: LVUServer):
        self.lvu_server = lvu_server

    def serve_forever(self):
        self.lvu_server.follow()

    def shutdown(self):
        pass

    def server_close(self):
        pass


def make_http_server(lvu, cfg: Optional[ServerConfig] = None):
    """Build (ThreadingHTTPServer, LVUServer). Caller runs serve_forever()
    (or spins it in a thread — tests do). Under a mesh every rank calls
    this: rank 0 gets the HTTP server, every other rank a follower whose
    serve_forever() runs the jobs rank 0 sends until rank 0 shuts down."""
    cfg = cfg or ServerConfig()
    lvu_server = LVUServer(lvu, cfg)
    if not lvu_server.is_leader:
        return _Follower(lvu_server), lvu_server
    handler = type("BoundHandler", (_Handler,), {"lvu_server": lvu_server})
    httpd = ThreadingHTTPServer((cfg.host, cfg.port), handler)
    return httpd, lvu_server


def main(argv: Optional[List[str]] = None):
    import argparse

    from quickvideo_tpu_torch.api import LVU
    from quickvideo_tpu_torch.config import LVUConfig

    ap = argparse.ArgumentParser(
        description="quickvideo-tpu-torch serving front end"
    )
    ap.add_argument("--model", default="qwen25-vl-7b")
    ap.add_argument("--model_type", default="qwen25_lvu")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--num_frames", type=int, default=1024)
    ap.add_argument("--fps", type=float, default=None)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--video_group_size", type=int, default=32)
    ap.add_argument("--top_p", type=float, default=0.5,
                    help="KV retention ratio (pruning), not sampling")
    ap.add_argument("--param_dtype", default="int8",
                    choices=["bfloat16", "int8"])
    ap.add_argument("--kv_cache_dtype", default="auto",
                    choices=["auto", "bfloat16", "int8", "int8k"])
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--max_resident_sessions", type=int, default=1)
    ap.add_argument("--spill_dir", default=None)
    ap.add_argument("--max_new_tokens", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default): the hand-written kernels on the "
                         "card; cpu: their plain versions")
    ap.add_argument("--mesh", default=None,
                    help="device mesh axes as dp,pp,tp,sp (e.g. --mesh "
                         "1,1,2,1), one process per rank under torchrun "
                         "(the CLI's flag); rank 0 binds --host / --port "
                         "and every rank runs every request")
    args = ap.parse_args(argv)
    from quickvideo_tpu_torch.lvu_cli import mesh_from_flag

    mesh_kw = mesh_from_flag(args.mesh)
    if mesh_kw is None:
        return 2

    lvu = LVU(LVUConfig(
        model_name_or_path=args.model,
        model_type=args.model_type,
        num_frames=args.num_frames,
        fps=args.fps,
        dtype=args.dtype,
        video_group_size=args.video_group_size,
        top_p=args.top_p,
        param_dtype=args.param_dtype,
        kv_cache_dtype=args.kv_cache_dtype,
        max_decode_tokens=args.max_new_tokens,
        **mesh_kw,
    ), device=args.device)
    cfg = ServerConfig(
        host=args.host, port=args.port, max_batch=args.max_batch,
        max_resident_sessions=args.max_resident_sessions,
        spill_dir=args.spill_dir,
        default_max_new_tokens=args.max_new_tokens,
    )
    httpd, lvu_server = make_http_server(lvu, cfg)
    import signal

    if not lvu_server.is_leader:
        # a follower ends at the leader's stop; a signal to every rank
        # (Ctrl-C, the launcher's SIGTERM) lets the leader drain first
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, signal.SIG_IGN)
        httpd.serve_forever()
        _leave_mesh(lvu)
        return None
    print(f"serving {args.model} ({args.model_type}) on "
          f"http://{cfg.host}:{httpd.server_address[1]}"
          + (f" over the mesh {lvu.mesh.config}" if lvu.mesh else ""))

    # graceful drain: SIGTERM/SIGINT stop accepting new connections, let
    # the worker finish the in-flight job(s), then exit — kubernetes-style
    # termination instead of killing a mid-prefill request; under a mesh
    # the worker then stops the followers

    def _drain(signum, frame):
        print(f"signal {signum}: draining ({lvu_server._admitted} in "
              f"flight) ...", flush=True)
        import threading as _t

        _t.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
    httpd.serve_forever()
    # serve_forever returned (shutdown called): wait for queued jobs to
    # finish before tearing the worker down
    deadline = time.monotonic() + 60
    while lvu_server._admitted > 0 and time.monotonic() < deadline:
        time.sleep(0.1)
    lvu_server.shutdown()
    _leave_mesh(lvu)
    print("drained, bye")


def _leave_mesh(lvu) -> None:
    """Close this rank's process group once its server has stopped."""
    if getattr(lvu, "mesh", None) is not None:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
