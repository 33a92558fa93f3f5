"""The port's HTTP server on a mesh of gloo ranks against the JAX package's
server on the same mesh (the conftest's 8 virtual CPU devices), tiny in
f32 with the same weights, the seeded fake video and answers that spell
their token ids (as tests/test_torch_serving.py).

The port runs one process per rank (tests/torch_mesh_ranks.py::
case_serve): every rank builds the LVU and makes the direct calls, then
rank 0 serves tests/torch_mesh_ranks.py::serve_script over HTTP while the
other ranks follow its jobs; the JAX server answers the same script in
this process meanwhile. Compared: status codes, answers, bodies without
their `id`, SSE frames, the batch histogram and the keys of /v1/stats;
the port's followers must have run every job (their direct answers and
error, spill and resume counts equal the leader's). Under pp = 3 the JAX
server answers the batched requests of a burst with 500 (ROADMAP C23)
while the port serves them one by one, so there the port's burst is held
to its own direct calls. Also: a spill and resume under tp and sp, an
idle gap beyond the lowered control timeout (parallel/mesh.py
CONTROL_TIMEOUT_S; the leader's heartbeat, serving/server.py HEARTBEAT_S,
keeps the followers), every rank exiting 0 after shutdown, the leader
failing its jobs once a follower has exited (it does not serve on alone),
and the disk frame cache on two ranks that share one directory, with one
rank writing its entry slowly while the other looks for it.
"""

import threading

import jax
import jax.numpy as jnp
import pytest
import torch

from quickvideo_tpu import serving as jserving
from quickvideo_tpu.api import LVU as JLVU
from quickvideo_tpu.config import LVUConfig as JLVUConfig
from quickvideo_tpu.config import MeshConfig as JMeshConfig
from quickvideo_tpu_torch.models.qwen25_vl.convert import params_from_jax
from test_torch_images import _patch_readers
from test_torch_parallel import _jax_params
from torch_mesh_ranks import (
    direct_answers,
    serve_script,
    spell,
    start_ranks,
)

torch.set_num_threads(2)

KW = dict(model_name_or_path="tiny", model_type="qwen25_lvu", num_frames=8,
          video_group_size=4, top_p=0.5, max_decode_tokens=8,
          decode_output="yuv420", dtype="float32")
MESHES = {"tp2": {"tp": 2}, "sp2": {"sp": 2}, "pp3": {"pp": 3}}
# lowered for the test: a follower's wait for its next job times out after
# CONTROL_TIMEOUT_S unless a heartbeat comes; the leader idles IDLE_S
CONTROL_TIMEOUT_S = 3.0
HEARTBEAT_S = 0.5
IDLE_S = 4.0


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """(tmp dir, the placeholder video, the port's params file)."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    video = tmp / "clip.mp4"
    video.write_bytes(b"")  # the routes check that the path exists
    torch.save(params_from_jax(_jax_params(False)), tmp / "params.pt")
    return tmp, str(video), str(tmp / "params.pt")


def _ranks(tmp, name, mesh_kw, video, params, lvu_kw=(), **extra):
    world = 1
    for n in mesh_kw.values():
        world *= n
    return start_ranks(
        tmp, "serve", world, lvu=dict(KW, mesh=mesh_kw, **dict(lvu_kw)),
        params=params,
        video=video, spill=str(tmp / f"spill-port-{name}"),
        control_timeout_s=CONTROL_TIMEOUT_S, heartbeat_s=HEARTBEAT_S,
        idle_s=IDLE_S, **extra)


def _jax_server(mesh_kw, video, spill, monkeypatch):
    """(direct answers, serve_script's observations) of the JAX server on
    the JAX mesh."""
    _patch_readers(monkeypatch)
    lvu = spell(JLVU(JLVUConfig(mesh=JMeshConfig(**mesh_kw), **KW),
                     params=jax.tree.map(jnp.asarray, _jax_params(False))))
    direct = direct_answers(lvu, video)
    cfg = jserving.ServerConfig(port=0, spill_dir=spill,
                                default_max_new_tokens=4,
                                request_timeout_s=120)
    httpd, server = jserving.make_http_server(lvu, cfg)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        obs = serve_script(f"http://127.0.0.1:{httpd.server_address[1]}",
                           server, video, direct)
    finally:
        httpd.shutdown()
        server.shutdown()
        httpd.server_close()
    return direct, obs


@pytest.mark.parametrize("name", sorted(MESHES))
def test_port_server_on_a_mesh_matches_the_jax_server(shared, monkeypatch,
                                                      name):
    tmp, video, params = shared
    mesh_kw = MESHES[name]
    wait = _ranks(tmp, name, mesh_kw, video, params)
    jdirect, jobs = _jax_server(mesh_kw, video,
                                str(tmp / f"spill-jax-{name}"), monkeypatch)
    ranks = wait()  # every rank exited 0, after the leader's shutdown
    leader, followers = ranks[0], ranks[1:]
    assert leader["role"] == "leader"
    assert [f["role"] for f in followers] == ["follower"] * len(followers)
    obs = leader["obs"]
    assert leader["direct"] == jdirect
    if mesh_kw.get("pp", 1) > 1:
        # C23: the JAX pp server answers a burst's batched requests with
        # 500; the port refuses BatchedQAEngine on every rank and serves
        # the burst one request at a time
        jax_answers, jax_batches = jobs.pop("burst")
        assert 500 in [c for c, _ in jax_answers]
        answers, batches = obs.pop("burst")
        assert answers == [(200, {"answer": leader["direct"]["generate"][1]})
                           ] * 3
        assert batches == jax_batches  # one drained batch of 3
        # sessions: refused with the JAX message on every rank, no hang
        assert obs["sessions"][0] == 500
        assert "chat sessions do not support pipeline parallelism" in (
            obs["sessions"][1]["error"])
    assert obs == jobs
    # the leader's answers after an idle gap beyond the control timeout
    assert leader["after_idle"] == (
        200, {"answer": leader["direct"]["generate"][0]})
    assert not leader["worker_alive"]
    for f in followers:  # each ran every job the leader ran
        assert f["direct"] == leader["direct"]
        for key in ("requests", "errors", "spills", "resumes", "batches"):
            assert f["stats"][key] == leader["stats"][key], key


def test_frame_cache_shared_by_two_ranks(shared):
    """save_video_cache on tp = 2 ranks sharing one cache_dir, rank 0
    writing its entry slowly while rank 1 looks for it: both requests
    answer alike, and the second reads the cache on every rank."""
    tmp, video, params = shared
    ranks = _ranks(tmp, "cache", {"tp": 2}, video, params,
                   lvu_kw=dict(save_video_cache=True,
                               cache_dir=str(tmp / "frames")),
                   frame_cache=True)()
    leader = ranks[0]
    assert leader["first"][0] == 200, leader["first"]
    assert leader["second"] == leader["first"]
    assert leader["decodes"][1] == leader["decodes"][0] <= 1
    assert ranks[1]["decodes"] <= 1
    assert not leader["worker_alive"]


def test_leader_fails_its_jobs_once_a_follower_has_exited(shared):
    """A follower that exits (code 3) at its first generate job: the
    leader answers that request and the next with 500, the second naming
    the follower, then shuts down and exits 0."""
    tmp, video, params = shared
    ranks = _ranks(tmp, "exit", {"tp": 2}, video, params,
                   follower_exits=True, exit_codes=[0, 3])()
    leader = ranks[0]
    (code1, body1), (code2, body2) = leader["after_exit"]
    assert (code1, code2) == (500, 500), (body1, body2)
    assert "follower rank" in body2["error"]
    assert not leader["worker_alive"]


def test_server_main_serves_a_mesh_and_drains_on_sigterm(tmp_path):
    """`python -m quickvideo_tpu_torch.serving --mesh 1,1,2,1 --device cpu`
    as two rank processes (the process group from QV_COORDINATOR /
    QV_NUM_PROCESSES / QV_PROCESS_ID, as torchrun's variables would give
    it): rank 0 alone prints the banner and answers on --port (a health
    check, a refused request, the stats), rank 1 binds nothing; SIGTERM to
    both, as a launcher sends it, drains rank 0, which then stops rank 1,
    and both exit 0."""
    import json
    import os
    import signal
    import socket
    import subprocess
    import sys
    import time
    import urllib.request

    from torch_mesh_ranks import ROOT, http

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = [sys.executable, "-m", "quickvideo_tpu_torch.serving", "--mesh",
            "1,1,2,1", "--device", "cpu", "--model", "tiny", "--dtype",
            "float32", "--num_frames", "8", "--max_new_tokens", "4",
            "--port", str(port), "--spill_dir", str(tmp_path / "spill")]
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                   QV_COORDINATOR=f"file://{tmp_path}/init",
                   QV_NUM_PROCESSES="2", QV_PROCESS_ID=str(rank))
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    base = f"http://127.0.0.1:{port}"
    try:
        for _ in range(600):
            try:
                with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                assert all(p.poll() is None for p in procs)
                time.sleep(0.1)
        assert health == {"status": "ok"}
        code, body = http(base, "/v1/generate", {"video": "/nonexistent.mp4",
                                                 "question": "?"})
        assert code == 400 and "not found" in body["error"]
        assert http(base, "/v1/stats")[0] == 200
        for p in procs:
            p.send_signal(signal.SIGTERM)
        outs = [p.communicate(timeout=60)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert f"on http://127.0.0.1:{port} over the mesh" in outs[0]
    assert "drained, bye" in outs[0]
    assert "serving" not in outs[1] and "drained" not in outs[1]
