"""The port's HTTP server on a mesh of gloo ranks meeting faults, against
the JAX package's server meeting the same errors in its one process on
the same mesh (the conftest's 8 virtual CPU devices): tiny in f32 with
test_torch_serving_mesh.py's weights and video, answers that spell their
token ids.

Each mesh (tp = 2, pp = 3) meets its faults in one start of its ranks
(tests/torch_mesh_ranks.py::case_serve_faults, which injects them by
patching inside the rank processes), one after another, each followed by
a plain request:

  (a) a follower raises torch.OutOfMemoryError after the request's first
      collective of the model's groups, while the leader waits in the
      next one;
  (b) the leader does;
  (c) the video is missing on rank 1 only (the route checks it on rank 0);
  (d) under tp, a follower's spill of a session raises after its write
      (after the job's last collective); under pp, where sessions are
      refused, the refusal that every rank meets.

The JAX server raises the same error at the same point of its job: its
dispatch raises (a) and (b), its route finds (c)'s video missing, its
session's save raises (d) after the write. Held: each answer's status
and body against the JAX server's (the port's body also names the rank
where not every rank failed alike), each answer within ANSWER_S with the
model groups' default timeout in place, the next request's answer equal
to the direct call's on every rank, every rank's outcome, error, spill
and resume counts alike, the groups aborted and rebuilt where a rank was
left waiting and nowhere else ((c) and the failing rank abort none), no
aborted group left held, and every rank exiting 0 after shutdown.

A rank whose job does not end after it aborted the model's groups exits
once ABORT_BOUND_S has passed, and the mesh then ends as it does when a
follower exits (test_torch_serving_mesh.py
test_leader_fails_its_jobs_once_a_follower_has_exited), not in a hang.
"""

import os
import threading

import jax
import jax.numpy as jnp
import pytest
import torch

from quickvideo_tpu import serving as jserving
from quickvideo_tpu.api import LVU as JLVU
from quickvideo_tpu.chat import ChatSession as JChatSession
from quickvideo_tpu.config import LVUConfig as JLVUConfig
from quickvideo_tpu.config import MeshConfig as JMeshConfig
from test_torch_images import _patch_readers
from test_torch_parallel import _jax_params
from test_torch_serving_mesh import KW, _ranks, shared  # noqa: F401
from torch_mesh_ranks import (
    FAULT_QUESTIONS,
    OOM_MESSAGE,
    SERVE_QUESTIONS,
    SPILL_MESSAGE,
    fault_script,
    spell,
    start_ranks,
)

torch.set_num_threads(2)

MESHES = {"tp2": {"tp": 2}, "pp3": {"pp": 3}}
# the longest a faulted request may take to be answered
ANSWER_S = 30.0
# the rank each fault names: the one that met its error by itself
NAMED = {"a": 1, "b": 0, "c": 1, "d": 1}


def _jax_faults(mesh_kw, video, missing, other, spill, monkeypatch):
    """(the direct answer, fault_script's steps) of the JAX server on the
    JAX mesh, with the same errors raised in its process."""
    _patch_readers(monkeypatch)
    lvu = spell(JLVU(JLVUConfig(mesh=JMeshConfig(**mesh_kw), **KW),
                     params=jax.tree.map(jnp.asarray, _jax_params(False))))
    direct = lvu.generate(SERVE_QUESTIONS[0], video, max_new_tokens=4)[0]
    cfg = jserving.ServerConfig(port=0, spill_dir=spill,
                                default_max_new_tokens=4,
                                request_timeout_s=120)
    httpd, server = jserving.make_http_server(lvu, cfg)
    spilling = {"armed": False}
    dispatch = server._dispatch

    def faulty(batch):
        p = batch[0].payload
        if p.get("question") in FAULT_QUESTIONS:
            raise torch.OutOfMemoryError(OOM_MESSAGE)
        spilling["armed"] = (batch[0].kind == "session_new"
                             and p["video"] == other)
        try:
            return dispatch(batch)
        finally:
            spilling["armed"] = False

    server._dispatch = faulty
    save = JChatSession.save

    def failing_save(self, path):
        save(self, path)
        if spilling["armed"]:
            raise OSError(SPILL_MESSAGE)

    monkeypatch.setattr(JChatSession, "save", failing_save)
    exists = os.path.exists
    monkeypatch.setattr(os.path, "exists",
                        lambda p: p != missing and exists(p))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        steps = fault_script(f"http://127.0.0.1:{httpd.server_address[1]}",
                             video, missing, other,
                             mesh_kw.get("pp", 1) == 1)
    finally:
        httpd.shutdown()
        server.shutdown()
        httpd.server_close()
    return direct, steps, server.stats


@pytest.mark.parametrize("name", sorted(MESHES))
def test_port_server_on_a_mesh_answers_faults_as_the_jax_server(
        shared, monkeypatch, name):  # noqa: F811 - the fixture
    tmp, video, params = shared
    mesh_kw = MESHES[name]
    missing, other = (str(tmp / f"{n}-{name}.mp4") for n in ("missing",
                                                             "other"))
    for path in (missing, other):  # present on rank 0's host
        open(path, "wb").close()
    world = 1
    for n in mesh_kw.values():
        world *= n
    wait = start_ranks(
        tmp, "serve_faults", world, lvu=dict(KW, mesh=mesh_kw),
        params=params, video=video, missing=missing, other=other,
        spill=str(tmp / f"spill-faults-port-{name}"))
    jdirect, jsteps, jstats = _jax_faults(
        mesh_kw, video, missing, other,
        str(tmp / f"spill-faults-jax-{name}"), monkeypatch)
    ranks = wait()  # every rank exited 0, after the leader's shutdown
    leader = ranks[0]
    assert leader["direct"] == jdirect
    assert not leader["worker_alive"]
    steps = leader["steps"]
    assert [s[0] for s in steps] == [s[0] for s in jsteps]
    for (step, code, body, seconds), (_, jcode, jbody, _) in zip(steps,
                                                                  jsteps):
        assert seconds < ANSWER_S, (step, seconds)
        assert code == jcode, (step, body, jbody)
        assert body.pop("rank", None) == NAMED.get(step), (step, body)
        if step != "d_session":  # a drawn id
            assert body == jbody, step
        if step.endswith("_next"):
            assert body == {"answer": leader["direct"]}, step
    by_step = dict((s[0], s[1:3]) for s in steps)
    assert by_step["a"][1]["error"] == f"OutOfMemoryError: {OOM_MESSAGE}"
    assert by_step["c"] == (400, {"error": f"video not found: {missing}"})
    if "d" in by_step:
        assert by_step["d"] == (500, {"error": f"OSError: {SPILL_MESSAGE}"})
        assert by_step["d_gone"][0] == 400
    for r, rank in enumerate(ranks):
        events = rank["events"]
        assert rank["direct"] == leader["direct"]
        # every rank ran every job and ended it alike
        assert len(events) == len(steps)
        assert ([e["outcome"] for e in events]
                == [e["outcome"] for e in leader["events"]])
        for (step, *_), e in zip(steps, events):
            if step.endswith("_next"):
                assert e["results"] == [{"answer": leader["direct"]}], r
            if step in ("a", "b"):
                # a rank left waiting aborts, the failing rank never; every
                # rank rebuilds
                assert e["aborts"] == int(r != NAMED[step]), (step, r)
                assert e["rebuilds"] == 1, (step, r)
            elif step in ("c", "sessions_refused"):
                assert e["aborts"] == e["rebuilds"] == 0, (step, r)
            elif step == "d":
                assert e["aborts"] == 0 or r != NAMED[step], r
        for key in ("errors", "spills", "resumes"):
            assert rank["stats"][key] == leader["stats"][key], (r, key)
        # no aborted group is held, and the mesh holds live ones only
        assert rank["retired"] == 0, r
        assert rank["live"], r
        assert rank["groups"][0] == rank["groups"][1], r
    # (c) is a job on the port's ranks and a route's check on the JAX
    # server, which does not count it
    assert leader["stats"]["errors"] == jstats["errors"] + 1
    for key in ("spills", "resumes"):
        assert leader["stats"][key] == jstats[key], key


def test_a_rank_whose_job_outlives_its_abort_exits(shared):  # noqa: F811
    """The leader fails its first generate job by itself, and rank 1's job
    never ends, not even after it aborts the model's groups: rank 1 exits
    (code 1) ABORT_BOUND_S (lowered to 1 s in its process) after its
    abort, and the leader answers that request and the next with 500, the
    second naming the follower, within the control group's timeout, then
    shuts down and exits 0."""
    tmp, video, params = shared
    ranks = _ranks(tmp, "stuck", {"tp": 2}, video, params,
                   follower_stuck=True, abort_bound_s=1.0,
                   exit_codes=[0, 1])()
    leader = ranks[0]
    (code1, body1), (code2, body2) = leader["after_exit"]
    assert (code1, code2) == (500, 500), (body1, body2)
    assert "follower rank left the mesh during a job" in body1["error"]
    assert "follower rank" in body2["error"]
    assert not leader["worker_alive"]
