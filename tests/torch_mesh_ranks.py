"""Rank processes of the PyTorch port's mesh tests
(tests/test_torch_parallel.py, tests/test_torch_context_parallel.py,
tests/test_torch_pipeline.py, tests/test_torch_pipeline_engine.py).

    python tests/torch_mesh_ranks.py SPEC.json RANK

runs one rank of the case the spec names: it joins the gloo process group
at spec["init"] (a file:// URL, so concurrent test workers never share a
port), runs the case on the CPU, and saves its result (with the jax /
quickvideo_tpu modules it has imported, which must be none) to
spec["out"] + ".RANK". `run_ranks` (imported by the tests) writes the spec,
starts every rank, waits for them with a time limit and returns their
results; a rank that fails or hangs fails the test. This module imports
neither jax nor the JAX package.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 240


def forbidden():
    return sorted(m for m in sys.modules
                  if m in ("jax", "quickvideo_tpu")
                  or m.startswith(("jax.", "jaxlib", "quickvideo_tpu.")))


def run_ranks(tmp_path, case: str, world: int, **spec):
    """Start `world` ranks of `case` with `spec` (JSON-able, plus paths
    the parent saved), wait for all, return their results by rank. Every
    rank must exit 0, or with spec["exit_codes"][rank] where that is given
    (its result is then None)."""
    return start_ranks(tmp_path, case, world, **spec)()


def start_ranks(tmp_path, case: str, world: int, **spec):
    """run_ranks in two halves: start the ranks and return a function that
    waits for them and returns their results (the caller works
    meanwhile)."""
    spec = dict(spec, case=case, world=world,
                init=f"file://{tmp_path}/init-{case}-{time.time_ns()}",
                out=str(tmp_path / f"res-{case}"))
    spec_path = tmp_path / f"spec-{case}-{time.time_ns()}.json"
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(spec_path), str(r)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
    ) for r in range(world)]
    deadline = time.monotonic() + RANK_TIMEOUT_S

    def wait():
        import torch

        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = spec.get("exit_codes") or [0] * world
        for r, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == codes[r], (
                f"rank {r} of {case} exited with {p.returncode}, not "
                f"{codes[r]}:\n{out[-4000:]}")
        results = [torch.load(f"{spec['out']}.{r}", weights_only=False)
                   if codes[r] == 0 else None for r in range(world)]
        for r, res in enumerate(results):
            assert res is None or res["forbidden"] == [], (
                r, res["forbidden"])
        return results

    return wait


# -- the seeded video reader (jax-free; the tests patch both packages with
# the same frames through tests/test_torch_engine.py's reader) -------------

HW = 280


class SeededReader:
    """The native InterleavedVideoReader's surface over seeded frames."""

    def __init__(self, path, num_threads=8, num_intervals=64):
        self.source_height = self.source_width = HW
        self.height = self.width = self.interpolation = None
        self.output_format, self.frame_iter, self._pos = "RGB", 1, 0

    def __len__(self):
        return 16

    def get_fps(self):
        return 4.0

    def process(self, indices):
        n = self.height * self.width * 3 // 2
        self._frames = np.stack([
            np.random.default_rng(i).integers(0, 256, n, dtype=np.uint8)
            for i in indices
        ])

    def __next__(self):
        block = self._frames[self._pos : self._pos + self.frame_iter]
        self._pos += len(block)
        if not len(block):
            raise StopIteration
        return block

    def close(self):
        pass


def patch_port_readers(set_attr=setattr):
    """The port's decoders replaced by SeededReader (frames as
    tests/test_torch_engine.py's FakeInterleavedReader draws them);
    `set_attr` is pytest's monkeypatch.setattr in a test process."""
    from quickvideo_tpu_torch.video import quickdecode as tqd
    from quickvideo_tpu_torch.video import reader as treader

    def decode(path, lvu):
        r = SeededReader(path)
        plan = treader.plan_from_reader(r, lvu)
        r.height, r.width = plan.resized_height, plan.resized_width
        r.output_format = "YUV420"
        r.process(plan.indices.tolist())
        return r._frames, plan, None

    set_attr(tqd, "InterleavedVideoReader", SeededReader)
    set_attr(treader, "decode_video_batch", decode)


# -- cases -----------------------------------------------------------------


def _lvu(spec):
    import torch

    from quickvideo_tpu_torch.api import LVU
    from quickvideo_tpu_torch.config import LVUConfig, MeshConfig

    kw = dict(spec["lvu"])
    kw["mesh"] = MeshConfig(**kw.get("mesh", {}))
    p = spec.get("params")  # None: the preset's deterministic weights
    p = torch.load(p, weights_only=False) if p else None
    return LVU(LVUConfig(**kw), params=p, device="cpu")


def case_generate(spec, rank):
    """A request through LVUEngine.generate, then its prefill and final
    prefill again for the retained index sets, the per-layer lengths and
    the final-prefill logits."""
    import torch

    from quickvideo_tpu_torch.ops import quantization as tq
    from quickvideo_tpu_torch.prefill import PrefillInputs

    if spec.get("act_min_dim"):
        tq.ACT_MIN_DIM = spec["act_min_dim"]
    lvu = _lvu(spec)
    ids, grid, groups, grids = torch.load(spec["request"], weights_only=False)

    def inputs():
        return PrefillInputs(ids, grid, groups, grids, 2.0)

    res = lvu.engine.generate(inputs(), max_new_tokens=spec["max_new"])
    cache, st = lvu.engine.prefill(inputs())
    lengths = lvu.engine.layer_lengths(cache, st)  # over every stage
    logits = lvu.engine.final_prefill(cache, st)
    sets = [i for g in st["retained"] for i in g if i is not None]
    sets += [i for i in (st.get("retained_final") or []) if i is not None]
    loaded = None
    if spec.get("sharded_load"):
        loaded = _sharded_load(lvu, spec["sharded_load"])
    return dict(
        sharded_load=loaded,
        tokens=res.tokens, cache_length=res.cache_length,
        layer_lengths=res.layer_lengths, kv_cache_bytes=res.kv_cache_bytes,
        prefill_lengths=lengths, capacity=cache.capacity,
        local_shape=tuple(cache.k.shape), kv_dtype=st["kv_dtype"],
        retained=[i.numpy() for i in sets], logits=logits.numpy(),
    )


def _sharded_load(lvu, directory):
    """"equal" when load_params_sharded reads this rank's part of the
    checkpoint `directory` as the LVU holds it and as the whole tree cut by
    mesh_params gives it, else what differs."""
    import torch

    from quickvideo_tpu_torch.models.qwen25_vl.load import (
        load_params,
        load_params_sharded,
    )
    from quickvideo_tpu_torch.parallel.sharding import mesh_params
    from quickvideo_tpu_torch.prefill.engine import tensor_leaves

    cfg, dtype = lvu.model_config, lvu.engine.dtype
    part = list(tensor_leaves(load_params_sharded(directory, cfg, lvu.mesh,
                                                  dtype, "cpu")))
    for what, tree in (("the LVU's", lvu.params), ("the whole tree's cut",
                       mesh_params(load_params(directory, cfg, dtype, "cpu"),
                                   lvu.mesh))):
        other = list(tensor_leaves(tree))
        if len(other) != len(part) or not all(
                torch.equal(a, b) for a, b in zip(part, other)):
            return f"differs from {what}"
    return "equal"


def case_cp_past(spec, rank):
    """cp_stacked_past_attention of one-layer caches whose capacity is
    split over the ranks (every rank holds its window), for each
    (length, (q, k, v)) of spec["tensors"]."""
    import torch

    from quickvideo_tpu_torch.config import MeshConfig
    from quickvideo_tpu_torch.ops.kv_cache import KVCache
    from quickvideo_tpu_torch.parallel.context_parallel import (
        cp_stacked_past_attention,
        shard_cache_cp,
    )
    from quickvideo_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MeshConfig(sp=spec["world"]), "cpu")
    out = {}
    for length, (q, k, v) in torch.load(spec["tensors"],
                                        weights_only=False):
        whole = KVCache(k=k[None], v=v[None], lengths=[length])
        cache = shard_cache_cp(whole, mesh.index("sp"), mesh.sp)
        pa = cp_stacked_past_attention(q, cache, 0, length, spec["scale"],
                                       mesh.group("sp"))
        out[length] = (pa.out.numpy(), pa.lse.numpy())
    return dict(cases=out)


def case_cp_append(spec, rank):
    """Appends at global offsets into a cache whose capacity is split over
    the ranks; returns this rank's window."""
    import torch

    from quickvideo_tpu_torch.ops.kv_cache import init_cache, stacked_append

    appends = torch.load(spec["tensors"], weights_only=False)
    l, h, cap, d = spec["shape"]
    cache = init_cache(l, h, cap, d, dtype=torch.float32,
                       quantized=spec["quantized"], sp_index=rank,
                       sp_size=spec["world"])
    for li, start, kn, vn in appends:
        stacked_append(cache, li, start, kn, vn)
    return dict(k=cache.k, v=cache.v, k_scale=cache.k_scale,
                v_scale=cache.v_scale)


def case_chat(spec, rank):
    """A chat session on the mesh: a first ask, saved; then the session
    that spec["resume"] names resumed and asked again."""
    patch_port_readers()
    lvu = _lvu(spec)
    s = lvu.start_chat("clip.mp4")
    first = s.ask(spec["questions"][0], max_new_tokens=4)
    s.save(spec["save"])
    resumed = lvu.resume_chat(spec["resume"])
    second = resumed.ask(spec["questions"][1], max_new_tokens=4)
    return dict(first=first, second=second,
                local_shape=tuple(resumed._cache.k.shape),
                capacity=resumed._cache.capacity)


def _score_batch_and_answer(lvu, request):
    """LVU.loglikelihood_multi, LVU.generate (through the seeded reader)
    and BatchedQAEngine over `request` and a copy with another last token:
    the paths beside generate that a mesh runs too."""
    from quickvideo_tpu_torch.prefill import PrefillInputs
    from quickvideo_tpu_torch.prefill.batch import BatchedQAEngine

    ids, grid, groups, grids = request
    other = np.array(ids)
    other[-2] = 9
    scores = lvu.loglikelihood_multi("What moves?", "clip.mp4",
                                     ["cat", "dogs"])
    answer = lvu.generate("What moves?", "clip.mp4", max_new_tokens=4)
    batch = BatchedQAEngine(lvu.engine).generate_batch(
        [PrefillInputs(i, grid, groups, grids, 2.0) for i in (ids, other)],
        4)
    return dict(scores=scores, answer=answer,
                batch=[b.tolist() for b in batch])


def case_score(spec, rank):
    import torch

    patch_port_readers()
    return _score_batch_and_answer(
        _lvu(spec), torch.load(spec["request"], weights_only=False))


def case_cli(spec, rank):
    """lvu_cli.main under the mesh (LVU's own process-group init from
    QV_COORDINATOR / QV_NUM_PROCESSES / QV_PROCESS_ID)."""
    import contextlib
    import io

    import torch.distributed as dist

    from quickvideo_tpu_torch import lvu_cli

    patch_port_readers()
    dist.destroy_process_group()  # the CLI starts its own
    os.environ.update(QV_COORDINATOR=spec["init"] + "-cli",
                      QV_NUM_PROCESSES=str(spec["world"]),
                      QV_PROCESS_ID=str(rank))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = lvu_cli.main(spec["argv"])
    return dict(rc=rc, lines=buf.getvalue().splitlines())


# the pipeline tests' sampled decode and scored continuations
PP_SAMPLE = dict(greedy=False, temperature=0.8, top_p=0.9, top_k=20)
PP_CONTS = ([7, 8], [11, 12, 13, 14, 15])


def _image(seed, h=140, w=140):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def pipeline_record(lvu, request, max_new, modes=False):
    """What the pipeline tests compare of one LVU (a rank of a pipeline
    mesh, or one device): `request` through LVUEngine.generate; its prefill
    and final prefill again (logits, the per-layer lengths over every
    stage, the retained index sets by (group, global layer)); with `modes`
    also decode sampled on the device and on the host, streamed chunks,
    scoring (lengths restored between continuations), LVU.loglikelihood
    (_multi), LVU.generate and LVU.chat with images (seeded reader,
    patch_port_readers) and evaluation/qa.py's run_qa_eval."""
    from quickvideo_tpu_torch.evaluation.qa import QASample, run_qa_eval
    from quickvideo_tpu_torch.prefill import PrefillInputs
    from quickvideo_tpu_torch.utils.timing import SpanTimer

    eng = lvu.engine
    ids, grid, groups, grids = request

    def inputs():
        return PrefillInputs(ids, grid, groups, grids, 2.0)

    res = eng.generate(inputs(), max_new_tokens=max_new)
    cache, st = eng.prefill(inputs())
    lengths = eng.layer_lengths(cache, st)
    stack = st["pp_stack"]
    layers = (list(stack.layers) if stack is not None
              else list(range(len(cache.lengths))))
    gathered = None
    if stack is not None:  # the slabs as one cache, after the prefill
        whole = stack.gather_cache()
        gathered = (whole.lengths, tuple(whole.k.shape))
    out = dict(gathered=gathered,
        tokens=res.tokens, cache_length=res.cache_length,
        kv_cache_bytes=res.kv_cache_bytes, layer_lengths=res.layer_lengths,
        prefill_lengths=lengths, layers=layers, capacity=cache.capacity,
        local_shape=tuple(cache.k.shape), kv_dtype=st["kv_dtype"],
        retained={(g, layers[j]): i.numpy()
                  for g, per in enumerate(st["retained"])
                  for j, i in enumerate(per) if i is not None},
        logits=eng.final_prefill(cache, st).numpy(),
    )
    if not modes:
        return out
    out["sampled"] = eng.generate(inputs(), max_new_tokens=max_new,
                                  **PP_SAMPLE).tokens
    chunks = []
    out["streamed"] = eng.generate(
        inputs(), max_new_tokens=max_new,
        on_tokens=lambda t: chunks.append(list(t))).tokens
    out["chunks"] = chunks
    cfg = eng.lvu
    eng.lvu = cfg.replace(sample_on_device=False)
    host_chunks = []
    out["host_sampled"] = eng.generate(
        inputs(), max_new_tokens=max_new,
        on_tokens=lambda t: host_chunks.append(list(t)), **PP_SAMPLE).tokens
    out["host_chunks"] = host_chunks
    eng.lvu = cfg
    cache, st = eng.prefill(inputs())
    before = eng.layer_lengths(cache, st)
    out["scores"] = [eng._score_one(cache, st, np.asarray(c), SpanTimer(),
                                    restore=True) for c in PP_CONTS]
    out["restored"] = eng.layer_lengths(cache, st) == before
    out["multi"] = eng.score_continuations(inputs(), list(PP_CONTS))
    out["ll"] = lvu.loglikelihood("What moves?", "clip.mp4", "cat")
    out["ll_multi"] = lvu.loglikelihood_multi("What moves?", "clip.mp4",
                                              ["cat", [5, 6, 7]])
    out["answer"] = lvu.generate("What moves?", "clip.mp4", max_new_tokens=4)
    out["chat"] = lvu.chat([{"role": "user", "content": [
        {"type": "image", "image": _image(1)},
        {"type": "video", "video": "clip.mp4"},
        {"type": "text", "text": "Compare them."},
        {"type": "image", "image": _image(2, 100, 150)}]}],
        max_new_tokens=4)
    out["chat_tokens"] = lvu.last_result.tokens
    samples = [QASample("clip.mp4", "What color dominates?",
                        ["A. red", "B. blue"], "A", id="s1")]
    out["qa"] = [p["raw"] for p in run_qa_eval(
        lvu, samples, max_new_tokens=4)["per_sample"]]
    return out


def case_pipeline(spec, rank):
    """Each of spec["runs"] (LVUConfig keywords, modes, optionally its own
    params file) on the mesh:
    pipeline_record, then with modes the refusals of chat sessions and
    batched QA under pp, which every rank must raise."""
    import torch

    from quickvideo_tpu_torch.ops import quantization as tq
    from quickvideo_tpu_torch.prefill.batch import BatchedQAEngine

    patch_port_readers()
    request = torch.load(spec["request"], weights_only=False)
    out = []
    default_dim = tq.ACT_MIN_DIM
    for run in spec["runs"]:
        tq.ACT_MIN_DIM = run.get("act_min_dim") or default_dim
        lvu = _lvu(dict(spec, lvu=run["lvu"],
                        params=run.get("params", spec.get("params"))))
        rec = pipeline_record(lvu, request, spec["max_new"], run["modes"])
        rec["holds"] = dict(
            vision="vision" in lvu.params, layers=len(
                lvu.params["language"]["layers"]),
            **{k: k in lvu.params["language"]
               for k in ("embed", "norm", "lm_head")})
        if run["modes"]:
            refused = []
            for call in (lambda: lvu.start_chat("clip.mp4"),
                         lambda: lvu.resume_chat(spec["session"]),
                         lambda: BatchedQAEngine(lvu.engine)):
                try:
                    call()
                    refused.append(None)
                except ValueError as e:
                    refused.append(str(e))
            rec["refused"] = refused
        out.append(rec)
    return dict(runs=out)


# -- the HTTP server on a mesh (tests/test_torch_serving_mesh.py): the
# client side, run against the JAX server in the test process and against
# the port's leader in rank 0 -------------------------------------------

SERVE_QUESTIONS = ("What is happening?", "Describe the clip.")
SESSION_QUESTIONS = ("What happens?", "Why?")


def http(base, path, body=None, method=None):
    """(status, decoded JSON body) of one request."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        base + path, data=data, method=method or ("POST" if data else "GET"),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def sse(base, path, body):
    """The JSON frames of a streamed request, before `data: [DONE]`."""
    import urllib.request

    req = urllib.request.Request(
        base + path, data=json.dumps(dict(body, stream=True)).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.status == 200
        assert resp.headers.get("Content-Type") == "text/event-stream"
        raw = resp.read().decode()
    frames = [f[len("data: "):] for f in raw.split("\n\n")
              if f.startswith("data: ")]
    assert frames and frames[-1] == "[DONE]"
    return [json.loads(f) for f in frames[:-1]]


def without_id(obj):
    """A body with its random `id` / `created` dropped, as JSON text."""
    return json.dumps({k: v for k, v in obj.items()
                       if k not in ("id", "created")})


def _wait(cond, tries=400):
    for _ in range(tries):
        if cond():
            return True
        time.sleep(0.05)
    return cond()


def serve_script(base, server, video, direct):
    """The requests that each package's server on a mesh answers, in
    order; {step: what was observed}. `direct` holds the same LVU's direct
    answers (SERVE_QUESTIONS by LVU.generate; the session's two turns by
    LVU.start_chat, None where sessions are refused)."""
    obs = {}
    code, models = http(base, "/v1/models")
    obs["health"] = [http(base, "/healthz"), code, models,
                     sorted(http(base, "/v1/stats")[1])]
    obs["generate"] = http(base, "/v1/generate", {
        "video": video, "question": SERVE_QUESTIONS[0],
        "max_new_tokens": 4})
    # a burst of 3 behind the paused worker (which may hold one popped
    # job), released at once: one micro-batch where batching runs
    server.pause()
    got = {}
    body = {"video": video, "question": SERVE_QUESTIONS[1],
            "max_new_tokens": 4}

    def ask(i):
        got[i] = http(base, "/v1/generate", body)

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    assert _wait(lambda: server._q.qsize() >= 2)
    time.sleep(0.2)
    server.resume()
    for t in threads:
        t.join(timeout=120)
    obs["burst"] = [[got[i] for i in range(3)],
                    dict(server.stats["batches"])]
    obs["stream"] = sse(base, "/v1/generate", {
        "video": video, "question": SERVE_QUESTIONS[0], "max_new_tokens": 4})
    code, out = http(base, "/v1/chat/completions", {
        "model": "tiny", "max_tokens": 4, "messages": [{
            "role": "user", "content": [
                {"type": "video_url", "video_url": {"url": f"file://{video}"}},
                {"type": "text", "text": SERVE_QUESTIONS[0]}]}]})
    obs["chat"] = [code, without_id(out)]
    code, s1 = http(base, "/v1/sessions", {"video": video})
    seen = [code, s1 if code != 200 else "id"]
    if code == 200:
        sid1 = s1["session_id"]
        a1 = http(base, f"/v1/sessions/{sid1}/ask",
                  {"question": SESSION_QUESTIONS[0], "max_new_tokens": 4})
        # a second session spills the first (max_resident_sessions=1)
        code2, s2 = http(base, "/v1/sessions", {"video": video})
        sid2 = s2["session_id"]
        b1 = http(base, f"/v1/sessions/{sid2}/ask",
                  {"question": SESSION_QUESTIONS[0], "max_new_tokens": 4})
        a2 = http(base, f"/v1/sessions/{sid1}/ask",  # resumed from disk
                  {"question": SESSION_QUESTIONS[1], "max_new_tokens": 4})
        closed = [http(base, f"/v1/sessions/{sid}", method="DELETE")[0]
                  for sid in (sid1, sid2)]
        code3, gone = http(base, f"/v1/sessions/{sid1}/ask",
                           {"question": "?"})
        gone = (code3, gone["error"].replace(sid1, "<id>"))
        seen += [a1, code2, b1, a2, closed, gone, server.stats["spills"],
                 server.stats["resumes"]]
        assert [a1[1]["answer"], a2[1]["answer"]] == list(direct["session"])
        assert server.stats["spills"] >= 1 and server.stats["resumes"] >= 1
    obs["sessions"] = seen
    obs["errors"] = [
        http(base, "/v1/generate", {"video": video}),
        http(base, "/v1/generate", {"video": "/nonexistent.mp4",
                                    "question": "?"}),
        http(base, "/v1/sessions/nope/ask", {"question": "?"}),
    ]
    obs["stats_keys"] = sorted(http(base, "/v1/stats")[1])
    assert obs["generate"] == (200, {"answer": direct["generate"][0]})
    assert [f["answer"] for f in obs["stream"] if "answer" in f] == [
        direct["generate"][0]]
    return obs


def spell(lvu):
    """Answers that spell their token ids (as tests/test_torch_serving.py
    patches both packages' tokenizers)."""
    lvu.tokenizer.decode = lambda ids: "".join(f"<{int(t)}>" for t in ids)
    return lvu


def direct_answers(lvu, video):
    """What serve_script holds the served answers to: LVU.generate of each
    SERVE_QUESTIONS, and a session's two turns (None where refused)."""
    gen = [lvu.generate(q, video, max_new_tokens=4)[0]
           for q in SERVE_QUESTIONS]
    session = None
    if lvu.config.mesh.pp == 1:
        s = lvu.start_chat(video)
        session = [s.ask(q, max_new_tokens=4) for q in SESSION_QUESTIONS]
    return {"generate": gen, "session": session}


def _slow_cache_writes(rank):
    """Frame-cache timing that a real deployment can hit: rank 0 writes its
    entry slowly (half of frames.npy, a pause, the rest) and rank 1 looks
    for the entry while rank 0 is still writing."""
    from quickvideo_tpu_torch.video import frame_cache

    if rank == 1:
        load = frame_cache.load

        def late_load(*a, **k):
            time.sleep(0.4)
            return load(*a, **k)

        frame_cache.load = late_load
        return
    real_save = np.save

    def slow_save(path, arr, *a, **k):
        if not str(path).endswith("frames.npy"):
            return real_save(path, arr, *a, **k)
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, np.lib.format.header_data_from_array_1_0(arr))
            raw = np.ascontiguousarray(arr).tobytes()
            f.write(raw[: len(raw) // 2])
            f.flush()
            time.sleep(1.0)
            f.write(raw[len(raw) // 2:])

    np.save = slow_save  # this rank process's numpy; frames.npy only


def case_serve(spec, rank):
    """The port's server on the mesh: every rank builds the LVU and makes
    the direct calls, then rank 0 serves serve_script over HTTP from a
    thread of its own while the others follow; then (rank 0) an idle gap
    of spec["idle_s"] beyond the lowered control timeout and one more
    request, and shutdown, after which every follower's serve_forever
    returns. With spec["frame_cache"] the LVU caches frames in one shared
    directory (slow writes, _slow_cache_writes) and rank 0 serves two
    requests for one video instead of the script. With
    spec["follower_exits"] rank 1 exits (code 3) when its first generate
    job comes, and rank 0 sends two requests after it instead."""
    from quickvideo_tpu_torch.parallel import mesh as tmesh
    from quickvideo_tpu_torch.serving import server as tserver
    from quickvideo_tpu_torch.video import reader as treader

    tmesh.CONTROL_TIMEOUT_S = spec["control_timeout_s"]
    tserver.HEARTBEAT_S = spec["heartbeat_s"]
    patch_port_readers()
    decodes = []
    decode = treader.decode_video_batch

    def counted(path, lvu):
        decodes.append(path)
        return decode(path, lvu)

    treader.decode_video_batch = counted
    video = spec["video"]
    if spec.get("frame_cache"):
        treader.open_reader = lambda path, n=None: ("native",
                                                    SeededReader(path))
        _slow_cache_writes(rank)
    lvu = spell(_lvu(spec))
    direct = None if spec.get("frame_cache") else direct_answers(lvu, video)
    cfg = tserver.ServerConfig(port=0, spill_dir=spec["spill"],
                               default_max_new_tokens=4,
                               request_timeout_s=120)
    httpd, server = tserver.make_http_server(lvu, cfg)
    if spec.get("follower_exits") and rank == 1:
        dispatch = server._dispatch

        def exit_at_generate(batch):
            if batch[0].kind == "generate":
                os._exit(3)
            return dispatch(batch)

        server._dispatch = exit_at_generate
    if not server.is_leader:
        assert httpd.server_address is None  # binds nothing
        httpd.serve_forever()
        server.shutdown()
        httpd.server_close()
        return dict(role="follower", direct=direct, decodes=len(decodes),
                    stats=server.stats)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    out = dict(role="leader", direct=direct)
    try:
        if spec.get("follower_exits"):
            body = {"video": video, "question": SERVE_QUESTIONS[0],
                    "max_new_tokens": 4}
            out["after_exit"] = [http(base, "/v1/generate", body)
                                 for _ in range(2)]
        elif spec.get("frame_cache"):
            body = {"video": video, "question": SERVE_QUESTIONS[0],
                    "max_new_tokens": 4}
            first = http(base, "/v1/generate", body)
            n_first = len(decodes)
            second = http(base, "/v1/generate", body)
            out.update(first=first, second=second,
                       decodes=[n_first, len(decodes)])
        else:
            out["obs"] = serve_script(base, server, video, direct)
            time.sleep(spec["idle_s"])
            out["after_idle"] = http(base, "/v1/generate", {
                "video": video, "question": SERVE_QUESTIONS[0],
                "max_new_tokens": 4})
    finally:
        httpd.shutdown()
        server.shutdown()
        httpd.server_close()
    out["worker_alive"] = server._worker.is_alive()
    out["stats"] = server.stats
    return out


CASES = {
    "pipeline": case_pipeline,
    "generate": case_generate,
    "cp_past": case_cp_past,
    "cp_append": case_cp_append,
    "chat": case_chat,
    "score": case_score,
    "cli": case_cli,
    "serve": case_serve,
}


def main():
    spec = json.loads(open(sys.argv[1]).read())
    rank = int(sys.argv[2])
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from quickvideo_tpu_torch.parallel.mesh import init_multihost

    init_multihost(spec["init"], spec["world"], rank, backend="gloo")
    result = CASES[spec["case"]](spec, rank)
    result["forbidden"] = forbidden()
    torch.save(result, f"{spec['out']}.{rank}")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
