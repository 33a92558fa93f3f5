"""The port's HTTP server against the JAX package's, case by case.

Every case of tests/test_serving.py runs against both servers, each over
its own package's LVU on the tiny preset in f32 with the same weights and
the same seeded fake video (both packages' decoders replaced, a placeholder
file where a path must exist, so no decoder library is needed), with
answers that spell their token ids. Each case
keeps its own checks (answers equal to the direct API call, batching,
spill and resume) and then holds the port's observations to the JAX
server's: status codes, answers, response bodies with their `id` dropped,
SSE frames, and the keys of /v1/stats.
"""

import contextlib
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from quickvideo_tpu.api import LVU as JLVU
from quickvideo_tpu import serving as jserving
from quickvideo_tpu_torch.api import LVU as TLVU
from quickvideo_tpu_torch import serving as tserving

from test_torch_engine import configs, params  # noqa: F401
from test_torch_images import _patch_readers

torch.set_num_threads(2)

PACKAGES = ("jax", "port")


@pytest.fixture(scope="module")
def lvus(params):  # noqa: F811
    """{"jax": JAX LVU, "port": the port's LVU} with the fake decoders in
    place for the module."""
    jp, tp = params
    mp = pytest.MonkeyPatch()
    _patch_readers(mp)
    jcfg, tcfg = configs(
        model_name_or_path="tiny", model_type="qwen25_lvu", num_frames=8,
        video_group_size=4, top_p=0.5, max_decode_tokens=8,
        decode_output="yuv420", dtype="float32",
    )
    out = {"jax": JLVU(jcfg, params=jp),
           "port": TLVU(tcfg, params=tp, device="cpu")}
    for lvu in out.values():
        # answers spell their token ids (the random tiny model's bytes
        # mostly decode to U+FFFD), so equal text means equal tokens; a
        # prefix of ids spells a prefix of the text, as streaming needs
        mp.setattr(lvu.tokenizer, "decode",
                   lambda ids: "".join(f"<{int(t)}>" for t in ids))
    yield out
    mp.undo()


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """A placeholder file: the routes check that the path exists, and the
    fake decoders draw the frames."""
    path = tmp_path_factory.mktemp("serve") / "clip.mp4"
    path.write_bytes(b"")
    return str(path)


@contextlib.contextmanager
def serve(pkg, lvu, spill_dir, **kw):
    """(base URL, LVUServer) of one package's server on a free port."""
    mod = jserving if pkg == "jax" else tserving
    cfg = mod.ServerConfig(port=0, spill_dir=str(spill_dir), **kw)
    httpd, server = mod.make_http_server(lvu, cfg)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}", server
    finally:
        httpd.shutdown()
        server.shutdown()
        httpd.server_close()


def _req(base, path, body=None, method=None):
    if body is not None:
        r = urllib.request.Request(
            base + path, data=json.dumps(body).encode(),
            method=method or "POST",
            headers={"Content-Type": "application/json"},
        )
    else:
        r = urllib.request.Request(base + path, method=method or "GET")
    try:
        with urllib.request.urlopen(r) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _without_id(obj):
    """A response body with its random `id` / `created` dropped, as the
    JSON text both servers would write for it."""
    if isinstance(obj, dict):
        obj = {k: v for k, v in obj.items() if k not in ("id", "created")}
    return json.dumps(obj)


def _sse_frames(base, path, body):
    data = json.dumps(body).encode()
    r = urllib.request.Request(
        base + path, data=data, method="POST",
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(r) as resp:
        assert resp.status == 200
        assert resp.headers.get("Content-Type") == "text/event-stream"
        raw = resp.read().decode()
    frames = [ln[len("data: "):] for ln in raw.split("\n\n")
              if ln.startswith("data: ")]
    assert frames and frames[-1] == "[DONE]"
    return [json.loads(f) for f in frames[:-1]]


def _wait(cond, tries=200):
    for _ in range(tries):
        if cond():
            return True
        time.sleep(0.05)
    return cond()


# -- the cases of tests/test_serving.py; each returns what it observed ------

def case_health_models_stats(base, server, lvu, video, tmp):
    assert _req(base, "/healthz") == (200, {"status": "ok"})
    code, models = _req(base, "/v1/models")
    assert code == 200 and models["data"][0]["id"] == "tiny"
    code, stats = _req(base, "/v1/stats")
    assert code == 200 and "queue_depth" in stats
    return [models, code, sorted(stats)]


def case_generate_matches_direct(base, server, lvu, video, tmp):
    direct = lvu.generate("What is happening?", video, max_new_tokens=4)[0]
    code, out = _req(base, "/v1/generate", {
        "video": video, "question": "What is happening?",
        "max_new_tokens": 4,
    })
    assert code == 200, out
    assert out["answer"] == direct
    return [code, out]


def _burst(base, server, video, n, stream=False):
    """n identical generate requests (and one streamed) queued behind a
    paused worker, then released."""
    server.pause()
    results = {}
    body = {"video": video, "question": "Describe the clip.",
            "max_new_tokens": 4}

    def ask(i):
        results[i] = _req(base, "/v1/generate", body)

    def ask_stream():
        results["s"] = _sse_frames(base, "/v1/generate",
                                   dict(body, stream=True))

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(n)]
    if stream:
        threads.append(threading.Thread(target=ask_stream))
    for t in threads:
        t.start()
    # the paused worker may already hold one popped job; the rest must be
    # queued before the release so that the drain sees them
    assert _wait(lambda: server._q.qsize() >= 2)
    time.sleep(0.2)
    server.resume()
    for t in threads:
        t.join(timeout=300)
    return results


def case_burst_batches_same_video(base, server, lvu, video, tmp):
    results = _burst(base, server, video, 3)
    answers = {results[i][1]["answer"] for i in range(3)}
    assert all(results[i][0] == 200 for i in range(3))
    assert len(answers) == 1
    assert server.stats["batches"].get(3, 0) >= 1
    return [sorted(answers), [results[i][0] for i in range(3)],
            dict(server.stats["batches"])]


def case_sessions_incremental_and_spill(base, server, lvu, video, tmp):
    code, s1 = _req(base, "/v1/sessions", {"video": video})
    assert code == 200
    sid1 = s1["session_id"]
    code, a1 = _req(base, f"/v1/sessions/{sid1}/ask",
                    {"question": "What happens?", "max_new_tokens": 4})
    assert code == 200 and isinstance(a1["answer"], str)
    direct = lvu.start_chat(video)
    assert a1["answer"] == direct.ask("What happens?", max_new_tokens=4)
    # a second session evicts the first (max_resident_sessions=1) to disk
    code2, s2 = _req(base, "/v1/sessions", {"video": video})
    sid2 = s2["session_id"]
    code3, b1 = _req(base, f"/v1/sessions/{sid2}/ask",
                     {"question": "And now?", "max_new_tokens": 4})
    assert code3 == 200
    assert server.stats["spills"] >= 1
    # asking session 1 again resumes it from disk; the follow-up equals the
    # in-memory session's
    code4, a2 = _req(base, f"/v1/sessions/{sid1}/ask",
                     {"question": "Why?", "max_new_tokens": 4})
    assert code4 == 200
    assert server.stats["resumes"] >= 1
    assert a2["answer"] == direct.ask("Why?", max_new_tokens=4)
    closed = [_req(base, f"/v1/sessions/{sid}", method="DELETE")[0]
              for sid in (sid1, sid2)]
    assert closed == [200, 200]
    code5, out = _req(base, f"/v1/sessions/{sid1}/ask", {"question": "gone?"})
    assert code5 == 400
    return [code, a1, code2, code3, b1, code4, a2, closed, code5,
            server.stats["spills"], server.stats["resumes"]]


def case_unmaterialized_spill(base, server, lvu, video, tmp):
    """A session evicted before its first ask spills no file and starts
    afresh on its next ask (not in tests/test_serving.py: the server's
    other spill branch)."""
    code, s1 = _req(base, "/v1/sessions", {"video": video})
    sid1 = s1["session_id"]
    _req(base, "/v1/sessions", {"video": video})
    assert server._spilled[sid1].startswith("unmaterialized:")
    code2, a1 = _req(base, f"/v1/sessions/{sid1}/ask",
                     {"question": "What happens?", "max_new_tokens": 4})
    assert code2 == 200
    assert a1["answer"] == lvu.start_chat(video).ask("What happens?",
                                                     max_new_tokens=4)
    return [code, code2, a1, server.stats["spills"], server.stats["resumes"]]


def _openai_body(video, **kw):
    return dict({
        "model": "tiny", "max_tokens": 4,
        "messages": [{
            "role": "user",
            "content": [
                {"type": "video_url",
                 "video_url": {"url": f"file://{video}"}},
                {"type": "text", "text": "What is happening?"},
            ],
        }],
    }, **kw)


def case_openai_chat_completions(base, server, lvu, video, tmp):
    direct = lvu.generate("What is happening?", video, max_new_tokens=4)[0]
    code, out = _req(base, "/v1/chat/completions", _openai_body(video))
    assert code == 200, out
    assert out["object"] == "chat.completion"
    assert out["choices"][0]["message"]["content"] == direct
    assert out["choices"][0]["finish_reason"] == "stop"
    return [code, _without_id(out)]


def case_error_paths(base, server, lvu, video, tmp):
    seen = []
    code, out = _req(base, "/v1/generate",
                     {"video": "/nonexistent.mp4", "question": "?"})
    assert code == 400 and "not found" in out["error"]
    seen.append((code, out))
    code, out = _req(base, "/v1/generate", {"question": "?"})
    assert code == 400
    seen.append((code, out))
    code, out = _req(base, "/v1/nope", {})
    assert code == 404
    seen.append((code, out))
    r = urllib.request.Request(base + "/v1/generate", data=b"{not json",
                               headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(r)
    assert ei.value.code == 400
    seen.append((ei.value.code, json.loads(ei.value.read())))
    return seen


def case_oversized_body_rejected_413(base, server, lvu, video, tmp):
    pkg = "jax" if isinstance(lvu, JLVU) else "port"
    with serve(pkg, lvu, tmp / "s413", max_body_bytes=1024,
               request_timeout_s=30) as (base2, _):
        big = json.dumps({"question": "x" * 4096, "video": "v"}).encode()
        r = urllib.request.Request(
            base2 + "/v1/generate", data=big,
            headers={"Content-Type": "application/json"},
        )
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(r)
        assert ei.value.code == 413
        body = json.loads(ei.value.read())
        code, _ = _req(base2, "/healthz")
        assert code == 200
    return [ei.value.code, body, code]


def case_load_shedding_503(base, server, lvu, video, tmp):
    pkg = "jax" if isinstance(lvu, JLVU) else "port"
    with serve(pkg, lvu, tmp / "s503", max_queue_depth=2,
               request_timeout_s=120) as (base2, server2):
        server2.pause()
        results = {}

        def go(i):
            results[i] = _req(base2, "/v1/generate", {
                "video": video, "question": f"q{i}", "max_new_tokens": 2,
            })

        threads = [threading.Thread(target=go, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        assert _wait(lambda: server2._admitted >= 2, 100)
        code, out = _req(base2, "/v1/generate", {
            "video": video, "question": "shed-me", "max_new_tokens": 2,
        })
        assert code == 503 and "retry" in out["error"]
        assert server2.stats.get("shed", 0) >= 1
        server2.resume()
        for th in threads:
            th.join(timeout=120)
        assert all(c == 200 for c, _ in results.values()), results
    return [code, out, sorted(results.items())]


def case_openai_message_translation(base, server, lvu, video, tmp):
    mod = jserving if isinstance(lvu, JLVU) else tserving
    msgs = mod.openai_to_reference_messages([{
        "role": "user",
        "content": [
            {"type": "video_url",
             "video_url": {"url": "file:///a/b.mp4", "fps": 2.0}},
            {"type": "text", "text": "q"},
        ],
    }])
    assert msgs[0]["content"][0] == {"type": "video", "video": "/a/b.mp4",
                                     "fps": 2.0}
    plain = mod.openai_to_reference_messages(
        [{"role": "system", "content": "be brief"}]
    )
    assert plain[0]["content"] == "be brief"
    errors = []
    for content in ([{"type": "video_url",
                      "video_url": {"url": "https://x/y.mp4"}}],
                    [{"type": "image_url", "image_url": {"url": "a.png"}}],
                    [{"type": "audio"}]):
        with pytest.raises(mod.RequestError) as ei:
            mod.openai_to_reference_messages(
                [{"role": "user", "content": content}]
            )
        errors.append(str(ei.value))
    return [msgs, plain, errors]


def case_stream_generate_sse(base, server, lvu, video, tmp):
    direct = lvu.generate("What is happening?", video, max_new_tokens=4)[0]
    frames = _sse_frames(base, "/v1/generate", {
        "video": video, "question": "What is happening?",
        "max_new_tokens": 4, "stream": True,
    })
    deltas = [f["delta"] for f in frames if "delta" in f]
    finals = [f for f in frames if "answer" in f]
    assert len(finals) == 1
    assert finals[0]["answer"] == direct
    assert "".join(deltas) == direct
    return frames


def case_stream_chat_completions_openai_chunks(base, server, lvu, video,
                                               tmp):
    direct = lvu.generate("What is happening?", video, max_new_tokens=4)[0]
    frames = _sse_frames(base, "/v1/chat/completions",
                         _openai_body(video, stream=True))
    assert all(f["object"] == "chat.completion.chunk" for f in frames)
    text = "".join(
        f["choices"][0]["delta"].get("content", "") for f in frames
    )
    assert text == direct
    assert frames[-1]["choices"][0]["finish_reason"] == "stop"
    first = next(f for f in frames
                 if f["choices"][0]["delta"].get("content"))
    assert first["choices"][0]["delta"].get("role") == "assistant"
    assert len({f["id"] for f in frames}) == 1
    return [_without_id(f) for f in frames]


def case_stream_session_ask_sse(base, server, lvu, video, tmp):
    code, out = _req(base, "/v1/sessions", {"video": video})
    assert code == 200, out
    sid = out["session_id"]
    frames = _sse_frames(base, f"/v1/sessions/{sid}/ask", {
        "question": "What is happening?", "max_new_tokens": 4,
        "stream": True,
    })
    finals = [f for f in frames if "answer" in f]
    assert len(finals) == 1
    deltas = "".join(f["delta"] for f in frames if "delta" in f)
    assert deltas == finals[0]["answer"]
    closed = _req(base, f"/v1/sessions/{sid}", method="DELETE")[0]
    return [code, frames, closed]


def case_mixed_stream_and_batch_burst(base, server, lvu, video, tmp):
    results = _burst(base, server, video, 2, stream=True)
    plain = {results[i][1]["answer"] for i in range(2)}
    assert len(plain) == 1
    stream_answer = [f["answer"] for f in results["s"] if "answer" in f]
    assert stream_answer == sorted(plain)
    assert _wait(lambda: server._admitted == 0, 100)
    return [sorted(plain), results["s"], dict(server.stats["batches"])]


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_server_matches_the_jax_server(lvus, video, tmp_path, case):
    seen = {}
    for pkg in PACKAGES:
        with serve(pkg, lvus[pkg], tmp_path / pkg / "spill",
                   default_max_new_tokens=4,
                   request_timeout_s=120) as (base, server):
            seen[pkg] = CASES[case](base, server, lvus[pkg], video,
                                    tmp_path / pkg)
            stats_keys = sorted(_req(base, "/v1/stats")[1])
        seen[pkg] = (seen[pkg], stats_keys)
    assert seen["port"] == seen["jax"]


def test_server_main_takes_a_device_flag(monkeypatch):
    """`main`'s --platform (a JAX backend) is --device {cuda, cpu} in the
    port, default cuda, passed to the LVU; the other flags and defaults
    are the JAX server's."""
    import quickvideo_tpu_torch.api as tapi
    from quickvideo_tpu_torch.serving import server as tserver

    built = {}

    class Stop(Exception):
        pass

    def fake_lvu(cfg, device=None):
        built.update(cfg=cfg, device=device)
        raise Stop

    monkeypatch.setattr(tapi, "LVU", fake_lvu)
    for argv, device in (([], "cuda"), (["--device", "cpu"], "cpu")):
        with pytest.raises(Stop):
            tserver.main(argv)
        assert built["device"] == device
        cfg = built["cfg"]
        assert (cfg.model_name_or_path, cfg.model_type, cfg.num_frames,
                cfg.param_dtype, cfg.top_p, cfg.video_group_size,
                cfg.max_decode_tokens) == (
            "qwen25-vl-7b", "qwen25_lvu", 1024, "int8", 0.5, 32, 128)
    with pytest.raises(SystemExit):
        tserver.main(["--device", "tpu"])


def test_server_main_takes_the_clis_mesh_flag(monkeypatch, capsys):
    """`--mesh dp,pp,tp,sp` (the port's; the JAX server has one controller
    and no such flag) is parsed and refused as lvu_cli's: four axes go to
    the LVU's MeshConfig, another count returns 2 with the CLI's error."""
    import quickvideo_tpu_torch.api as tapi
    from quickvideo_tpu_torch.config import MeshConfig
    from quickvideo_tpu_torch.serving import server as tserver

    built = {}

    class Stop(Exception):
        pass

    def fake_lvu(cfg, device=None):
        built.update(cfg=cfg)
        raise Stop

    monkeypatch.setattr(tapi, "LVU", fake_lvu)
    with pytest.raises(Stop):
        tserver.main(["--mesh", "1,2,2,1", "--device", "cpu"])
    assert built["cfg"].mesh == MeshConfig(dp=1, pp=2, tp=2, sp=1)
    with pytest.raises(Stop):
        tserver.main([])
    assert built["cfg"].mesh == MeshConfig()
    assert tserver.main(["--mesh", "1,2"]) == 2
    assert "dp,pp,tp,sp" in capsys.readouterr().err


def test_a_worker_that_cannot_select_its_device_fails_its_jobs(
        lvus, video, tmp_path, monkeypatch):
    """The worker selects the LVU's card before its first job. Where that
    fails (here: a CUDA device on a build of torch without CUDA), every
    request gets the error at once instead of waiting out
    request_timeout_s."""
    monkeypatch.setattr(lvus["port"], "device", torch.device("cuda"))
    with serve("port", lvus["port"], tmp_path / "spill",
               request_timeout_s=60) as (base, server):
        t0 = time.monotonic()
        for q in ("What happens?", "Why?"):
            code, body = _req(base, "/v1/generate",
                              {"video": video, "question": q})
            assert code == 500 and "could not select" in body["error"]
        assert time.monotonic() - t0 < 30
        assert server.stats["errors"] == 2
