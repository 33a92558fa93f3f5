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
    the parent saved), wait for all, return their results by rank."""
    import torch

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
    outs, deadline = [], time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {case} failed:\n{out[-4000:]}"
    results = [torch.load(f"{spec['out']}.{r}", weights_only=False)
               for r in range(world)]
    for r, res in enumerate(results):
        assert res["forbidden"] == [], (r, res["forbidden"])
    return results


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
    p = spec.get("params")  # None: the seeded random weights
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
    return dict(
        tokens=res.tokens, cache_length=res.cache_length,
        layer_lengths=res.layer_lengths, kv_cache_bytes=res.kv_cache_bytes,
        prefill_lengths=lengths, capacity=cache.capacity,
        local_shape=tuple(cache.k.shape), kv_dtype=st["kv_dtype"],
        retained=[i.numpy() for i in sets], logits=logits.numpy(),
    )


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


CASES = {
    "pipeline": case_pipeline,
    "generate": case_generate,
    "cp_past": case_cp_past,
    "cp_append": case_cp_append,
    "chat": case_chat,
    "score": case_score,
    "cli": case_cli,
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
