"""Pipeline parallelism in the PyTorch port (quickvideo_tpu_torch/parallel/
pipeline.py, the stage slices of parallel/sharding.py, convert.py and
load.py, the engine's pp routes) against one rank of the port, on the tiny
preset in f32 (3 layers: pp = 3, one layer per stage).

pp changes no arithmetic, so a pipeline gives one rank's request bit for
bit: tokens, final-prefill logits, lengths and retained index sets, and
the decode sampled on the device and on the host, the streamed chunks,
continuation scoring (lengths restored), LVU.loglikelihood(_multi),
LVU.generate and LVU.chat (through the seeded reader, images included) and
evaluation/qa.py's run_qa_eval; pp x tp gives tp's. The ranks are real
gloo processes (tests/torch_mesh_ranks.py::case_pipeline); the single-rank
side runs tests/torch_mesh_ranks.py::pipeline_record in this process.
Also: each rank holds only its stage, the random predictors draw one
rank's numbers (ROADMAP C24), the refusals, and the CLI under pp. The JAX
engine's pp parity: tests/test_torch_pipeline_engine.py.
"""

import json
import types

import numpy as np
import pytest
import torch

from quickvideo_tpu_torch.api import LVU
from quickvideo_tpu_torch.config import LVUConfig, MeshConfig
from quickvideo_tpu_torch.models.qwen25_vl import load as tload
from quickvideo_tpu_torch.models.qwen25_vl.config import get_config
from quickvideo_tpu_torch.models.qwen25_vl.convert import (
    init_params,
    params_from_jax,
)
from quickvideo_tpu_torch.models.qwen25_vl.language import (
    StepSpec,
    prefill_step_unrolled,
)
from quickvideo_tpu_torch.ops.kv_cache import init_cache
from quickvideo_tpu_torch.ops.quantization import quantize_model_params
from quickvideo_tpu_torch.parallel.sharding import (
    global_nbytes,
    mesh_params,
    shard_params,
    stage_params,
)
from quickvideo_tpu_torch.prefill import LVUEngine
from quickvideo_tpu_torch.prefill.engine import tensor_leaves
from quickvideo_tpu_torch.testing import write_checkpoint
from test_torch_engine import build_request
from test_torch_parallel import CLI_ARGV, _assert_trees_equal, _jax_params
from torch_mesh_ranks import patch_port_readers, pipeline_record, run_ranks

torch.set_num_threads(2)

CFG = get_config("tiny")
KW = dict(model_name_or_path="tiny", top_p=0.5, max_decode_tokens=8,
          dtype="float32", model_type="qwen25_lvu_interleaved", num_frames=8,
          video_group_size=4, decode_output="yuv420")
RANDOM = dict(top_k_predict_type="random")
MAX_NEW = 6


@pytest.fixture(scope="module")
def pp_runs(tmp_path_factory):
    """The ranks' records and one device's: {"pp3": (ranks, one rank),
    "pp3_tp2": (ranks, tp = 2's rank 0), "random": (ranks, one rank)}, and
    the saved session the pp ranks are refused to resume."""
    tmp = tmp_path_factory.mktemp("pp")
    params = params_from_jax(_jax_params(False))
    torch.save(params, tmp / "params.pt")
    request = build_request(n_post=7)
    torch.save(request, tmp / "request.pt")
    common = dict(params=str(tmp / "params.pt"),
                  request=str(tmp / "request.pt"), max_new=MAX_NEW,
                  session=str(tmp / "session.npz"))
    with pytest.MonkeyPatch.context() as mp:
        patch_port_readers(mp.setattr)
        one = LVU(LVUConfig(**KW), params=params, device="cpu")
        one_rec = pipeline_record(one, request, MAX_NEW, modes=True)
        s = one.start_chat("clip.mp4")
        s.ask("What moves?", max_new_tokens=2)
        s.save(common["session"])
        rand = pipeline_record(
            LVU(LVUConfig(**KW, **RANDOM), params=params, device="cpu"),
            request, MAX_NEW)

    def ranks(mesh, runs):
        r = run_ranks(tmp, "pipeline", int(np.prod(list(mesh.values()))),
                      runs=[dict(lvu=dict(KW, **kw, mesh=mesh), modes=m)
                            for kw, m in runs], **common)
        return [[x["runs"][i] for x in r] for i in range(len(runs))]

    pp3, pp3_random = ranks({"pp": 3}, [({}, True), (RANDOM, False)])
    pp3_tp2, = ranks({"pp": 3, "tp": 2}, [({}, True)])
    tp2, = ranks({"tp": 2}, [({}, True)])
    return {"pp3": (pp3, one_rec), "pp3_tp2": (pp3_tp2, tp2[0]),
            "random": (pp3_random, rand)}


def _same_request(r, ref):
    np.testing.assert_array_equal(r["tokens"], ref["tokens"])
    np.testing.assert_array_equal(r["logits"], ref["logits"])
    for key in ("cache_length", "kv_cache_bytes", "layer_lengths",
                "prefill_lengths", "capacity", "kv_dtype"):
        assert r[key] == ref[key], key
    # a stage's retained sets are one rank's at its layers
    assert r["retained"] and set(r["retained"]) <= set(ref["retained"])
    for key, idx in r["retained"].items():
        np.testing.assert_array_equal(idx, ref["retained"][key])


@pytest.mark.parametrize("mesh", ["pp3", "pp3_tp2"])
def test_pp_gives_one_ranks_request_bit_for_bit(pp_runs, mesh):
    """Every rank of pp = 3 (and pp = 3 x tp = 2, against tp = 2 alone)
    returns one rank's tokens, final-prefill logits, cache_length,
    kv_cache_bytes and per-layer lengths, bit for bit, and the stages'
    retained sets together are one rank's."""
    ranks, ref = pp_runs[mesh]
    for r in ranks:
        _same_request(r, ref)
    held = set().union(*(r["retained"] for r in ranks))
    assert held == set(ref["retained"])


@pytest.mark.parametrize("mesh", ["pp3", "pp3_tp2"])
def test_pp_sampling_streaming_and_scoring_are_one_ranks(pp_runs, mesh):
    """Decode sampled on the device and on the host (the last stage's
    generators), the streamed chunks (the first token alone, then chunks of
    stream_chunk_tokens; one call per token when sampling on the host, the
    JAX pp path's calls), scoring with the lengths restored on every
    stage, and the API paths through the seeded reader, on every rank."""
    ranks, ref = pp_runs[mesh]
    assert len(ref["chunks"][0]) == 1 and len(ref["chunks"]) == 2
    assert all(len(c) == 1 for c in ref["host_chunks"])
    for r in ranks:
        for key in ("sampled", "streamed", "host_sampled", "chat_tokens"):
            np.testing.assert_array_equal(r[key], ref[key], err_msg=key)
        for key in ("chunks", "host_chunks", "scores", "multi", "ll",
                    "ll_multi", "answer", "chat", "qa"):
            assert r[key] == ref[key], key
        assert r["restored"] and sum(r["chunks"], []) == list(r["streamed"])
    assert not np.array_equal(ref["sampled"], ref["tokens"])


def test_random_predictors_draw_one_ranks_numbers(pp_runs):
    """ROADMAP C24: the JAX pp path folds one rng for every group; each
    port stage draws from the generator of its global layers (seed + 1,
    group, layer), so a pipeline keeps one rank's random sets."""
    ranks, ref = pp_runs["random"]
    for r in ranks:
        _same_request(r, ref)


@pytest.mark.parametrize("mesh", ["pp3", "pp3_tp2"])
def test_each_rank_holds_its_stage(pp_runs, mesh):
    """The vision tower and embedding on the first stage, the norm and
    lm_head on the last, one layer and one layer's cache slab (its tp
    heads) on each; gather_cache puts the slabs back together."""
    ranks, ref = pp_runs[mesh]
    tp = 2 if mesh == "pp3_tp2" else 1
    t = CFG.text
    for r in ranks:
        stage = r["layers"][0]
        assert r["layers"] == [stage]
        assert r["holds"] == dict(vision=stage == 0, embed=stage == 0,
                                  norm=stage == 2, lm_head=stage == 2,
                                  layers=1)
        assert r["local_shape"] == (1, t.num_key_value_heads // tp,
                                    r["capacity"], t.head_dim)
        lengths, shape = r["gathered"]
        assert lengths == r["prefill_lengths"]
        assert shape == (3,) + r["local_shape"][1:]


def test_chat_sessions_and_batched_qa_are_refused_on_every_rank(pp_runs):
    """start_chat, resume_chat and BatchedQAEngine raise ValueError under
    pp on every rank (the JAX message for sessions; C23 for batching)."""
    for r in pp_runs["pp3"][0]:
        chat, resume, batch = r["refused"]
        assert "chat sessions do not support pipeline parallelism" in chat
        assert resume == chat
        assert "batched QA does not support pipeline parallelism" in batch


def _fake_mesh(stage, stages, tp_index=0, tp=1):
    return types.SimpleNamespace(
        index=lambda a: {"pp": stage, "tp": tp_index}.get(a, 0), pp=stages,
        tp=tp, device=torch.device("cpu"))


@pytest.mark.parametrize("param_dtype", [None, "int8"])
def test_a_stages_tree_is_the_slice_of_the_one_device_tree(param_dtype):
    """init_params(mesh=) and params_from_jax(mesh=) on each rank of
    pp = 3 and of pp = 3 x tp = 2: the stage's layers (and its tp slices)
    of the same seed's whole tree, the tower and embedding on the first
    stage, the norm and lm_head on the last; global_nbytes of the stages'
    trees sums to the whole model's."""
    whole = init_params(CFG, 0, torch.float32, param_dtype=param_dtype)
    n = sum(t.nbytes for t in tensor_leaves(whole))
    jp = _jax_params(param_dtype == "int8")
    from_jax = params_from_jax(jp)
    for tp in (1, 2):
        total = 0
        for stage in range(3):
            for ti in range(tp):
                mesh = _fake_mesh(stage, 3, ti, tp)
                part = init_params(CFG, 0, torch.float32,
                                   param_dtype=param_dtype, mesh=mesh)
                want = shard_params(stage_params(whole, stage, 3), ti, tp)
                _assert_trees_equal(part, want)
                _assert_trees_equal(params_from_jax(jp, mesh=mesh),
                                    mesh_params(from_jax, mesh))
                assert ("vision" in part) == (stage == 0)
                assert set(part["language"]) == {"layers"} | (
                    {"embed"} if stage == 0 else set()) | (
                    {"norm", "lm_head"} if stage == 2 else set())
                assert len(part["language"]["layers"]) == 1
                if ti == 0:
                    total += global_nbytes(part, tp)
        assert total == n


@pytest.mark.parametrize("int8", [False, True])
def test_load_params_sharded_reads_only_its_stage(tmp_path, monkeypatch,
                                                  int8):
    """Each pp = 3 rank reads only its stage's tensors from a checkpoint
    directory (counted as they are read), and its tree is that stage's
    slice of the whole one."""
    params = init_params(CFG, 0, torch.float32)
    write_checkpoint(str(tmp_path), params, CFG)
    whole = tload.load_params(str(tmp_path), CFG, torch.float32)
    if int8:
        whole = quantize_model_params(whole)
    read = []
    orig = tload.SafetensorsFile.tensor

    def counted(self, name):
        read.append(name)
        return orig(self, name)

    monkeypatch.setattr(tload.SafetensorsFile, "tensor", counted)
    names = set()
    for stage in range(3):
        read.clear()
        got = tload.load_params_sharded(str(tmp_path), CFG,
                                        _fake_mesh(stage, 3), torch.float32,
                                        int8=int8)
        if int8:
            got = quantize_model_params(got)
        _assert_trees_equal(got, stage_params(whole, stage, 3))
        layers = {n.split(".layers.")[1].split(".")[0] for n in read
                  if ".layers." in n}
        assert layers == {str(stage)}
        visual = [n for n in read if "visual" in n]
        assert bool(visual) == (stage == 0)
        assert any("norm.weight" in n and "layers" not in n
                   and "visual" not in n for n in read) == (stage == 2)
        assert len(read) == len(set(read))
        names |= set(read)
    # the three stages read every tensor once between them
    assert len(names) == sum(1 for _ in tensor_leaves(params))


def test_a_stages_layers_draw_from_the_one_device_generators():
    """The random predictors' generator of a stage's layer is one
    device's of its global layer (language.py::layer_generator of layer0 +
    li, the cache index li): running the layers as
    three one-layer slabs (each its own cache, layer0 = its global index)
    gives one device's hidden states and random retained sets, bit for
    bit."""
    params = init_params(CFG, 0, torch.float32)
    lang = params["language"]
    t = CFG.text
    torch.manual_seed(0)
    x = torch.randn(12, t.hidden_size)
    cos, sin = torch.ones(12, t.head_dim), torch.zeros(12, t.head_dim)
    spec = StepSpec(q_len=12, keep_k=5, predict_type="random")
    key = (1, 2)
    whole = init_cache(3, t.num_key_value_heads, 64, t.head_dim,
                       dtype=torch.float32)
    y, idx = prefill_step_unrolled(lang, whole, x, cos, sin, t, [spec] * 3,
                                   seed_key=key)
    h = x
    for li in range(3):
        slab = init_cache(1, t.num_key_value_heads, 64, t.head_dim,
                          dtype=torch.float32)
        h, got = prefill_step_unrolled({"layers": lang["layers"][li:li + 1]},
                                       slab, h, cos, sin, t, [spec],
                                       seed_key=key, layer0=li)
        torch.testing.assert_close(got[0], idx[li], rtol=0, atol=0)
    torch.testing.assert_close(h, y, rtol=0, atol=0)
    assert not all(torch.equal(idx[0], i) for i in idx[1:])


@pytest.mark.parametrize("kw,match", [
    (dict(top_k_decay_type="linear"), "decay/cascade"),
    (dict(prefill_prune_starting_layer=1), "decay/cascade"),
    (dict(mesh=MeshConfig(pp=3, sp=2)), "pp does not compose with sp"),
])
def test_what_pp_refuses_raises_before_any_process_group(kw, match):
    """Decay and cascade schedules and sp beside pp raise ValueError with
    the JAX engine's messages, from the facade and the engine, before any
    process group is asked for."""
    kw = dict(dict(mesh=MeshConfig(pp=3)), **kw)
    cfg = LVUConfig(**dict(KW, **kw))
    params = init_params(CFG, 0, torch.float32)
    with pytest.raises(ValueError, match=match):
        LVU(cfg, params=params, device="cpu")
    with pytest.raises(ValueError, match=match):
        LVUEngine(params, CFG, cfg, torch.float32)


def test_cli_under_pp3_prints_what_one_device_prints(tmp_path, monkeypatch,
                                                     capsys):
    """lvu_cli.main --mesh 1,3,1,1 in three gloo ranks: rank 0, on the
    first stage, prints the single-device CLI's answer and cache length;
    the other stages print nothing."""
    from quickvideo_tpu_torch import lvu_cli

    patch_port_readers(monkeypatch.setattr)
    assert lvu_cli.main(CLI_ARGV) == 0
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    ranks = run_ranks(tmp_path, "cli", 3,
                      argv=CLI_ARGV + ["--mesh", "1,3,1,1"])
    assert [r["rc"] for r in ranks] == [0, 0, 0]
    got = [json.loads(line) for line in ranks[0]["lines"]
           if line.startswith("{")]
    assert ranks[1]["lines"] == ranks[2]["lines"] == []
    assert len(got) == len(want) == 1
    for row in (got[0], want[0]):
        row.pop("timings")
    assert got == want
