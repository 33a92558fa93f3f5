"""The PyTorch port's mesh (quickvideo_tpu_torch/parallel/: mesh, comm,
sharding) and tensor parallelism against the JAX package's mesh
(quickvideo_tpu/parallel/ on the conftest's 8 virtual CPU devices), on the
tiny preset in f32 with the same weights and inputs.

The port's ranks are real gloo processes (tests/torch_mesh_ranks.py,
init_method file:// under tmp_path); the JAX side runs in this process
(LVU's engine with MeshConfig, params placed by shard_params). Compared:
greedy tokens, cache length, per-layer lengths and every retained index
set, exactly (the JAX sets read with jax.debug.callback around
select_and_compact, as tests/test_torch_modes.py does, compared as
multisets since the mesh's callbacks are unordered); the ranks' tokens,
index sets and logits, bit for bit; the final-prefill logits by rel. L2
under the limits of tests/test_torch_engine.py (f32 weights 1e-4; int8 KV
1e-4; int8 weights 3e-2, where the two packages' vision towers differ).
Also: sharded checkpoint loading, chat sessions between a mesh and one
device, the CLI under a mesh, and the refusals.
"""

import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quickvideo_tpu.config import LVUConfig as JLVUConfig
from quickvideo_tpu.config import MeshConfig as JMeshConfig
from quickvideo_tpu.models.qwen25_vl import model as jmodel
from quickvideo_tpu.ops import prune as jprune
from quickvideo_tpu.parallel import make_mesh as jmake_mesh
from quickvideo_tpu.parallel import shard_params as jshard_params
from quickvideo_tpu.prefill import LVUEngine as JEngine
from quickvideo_tpu.prefill import PrefillInputs as JInputs
from quickvideo_tpu_torch.api import LVU as TLVU
from quickvideo_tpu_torch.config import LVUConfig as TLVUConfig
from quickvideo_tpu_torch.config import MeshConfig
from quickvideo_tpu_torch.evaluation import qa as tqa
from quickvideo_tpu_torch.models.qwen25_vl.config import get_config
from quickvideo_tpu_torch.models.qwen25_vl.convert import (
    init_params,
    params_from_jax,
)
from quickvideo_tpu_torch.models.qwen25_vl.load import (
    load_params,
    load_params_sharded,
)
from quickvideo_tpu_torch.ops.quantization import quantize_model_params
from quickvideo_tpu_torch.parallel import comm
from quickvideo_tpu_torch.parallel import mesh as tmesh
from quickvideo_tpu_torch.parallel.sharding import (
    global_nbytes,
    shard_params,
)
from quickvideo_tpu_torch.prefill import LVUEngine, PrefillInputs
from quickvideo_tpu_torch.prefill.engine import tensor_leaves
from quickvideo_tpu_torch.testing import write_checkpoint
from test_torch_engine import CFG as JCFG
from test_torch_engine import _jax_final_prefill_logits, build_request
from torch_mesh_ranks import patch_port_readers, run_ranks

torch.set_num_threads(2)

CFG = get_config("tiny")
BASE = dict(model_name_or_path="tiny", top_p=0.5, max_decode_tokens=8,
            dtype="float32")
LOGITS_REL_L2 = 1e-4  # f32 weights, f32 or int8 KV
INT8_LOGITS_REL_L2 = 3e-2  # int8 weights (tests/test_torch_engine.py)
# tp = 2 with int8 weights against one rank of the port: every activation
# row is quantized with its whole-row scale on both, so the int8 codes are
# the same and only f32 summation order differs (measured 9.6e-8 with the
# gates lowered)
TP_INT8_SELF_REL_L2 = 1e-5

_JAX_PARAMS = {}


def _jax_params(int8: bool):
    """The seed-0 tiny weights as numpy trees (JAX package layout), float
    or quantized by the JAX package's quantizer."""
    if int8 not in _JAX_PARAMS:
        jp = jax.tree.map(np.asarray, jmodel.init_params(
            JCFG, seed=0, dtype=jnp.float32))
        if int8:
            from quickvideo_tpu.ops import quantization as jq

            jp = jax.tree.map(np.asarray, jq.quantize_model_params(
                jax.tree.map(jnp.array, jp)))
        _JAX_PARAMS[int8] = jp
    return _JAX_PARAMS[int8]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _as_multiset(sets):
    return sorted(tuple(int(i) for i in np.asarray(s)) for s in sets)


def check_engine_against_jax(tmp_path, monkeypatch, mesh_kw, kw,
                             act_min_dim=None):
    """One request through the JAX engine on a MeshConfig(**mesh_kw) mesh
    and through the port's ranks on the same mesh (LVUConfig keywords
    `kw`); every comparison of the module docstring. Returns the ranks'
    results."""
    int8_w = kw.get("param_dtype") == "int8"
    int8_kv = kw.get("kv_cache_dtype") in ("int8", "int8k")
    jp = _jax_params(int8_w)
    kw = dict(BASE, **kw)
    # the JAX engine's kernel route (B1's int8-QK variant and B3/B4 in
    # interpret mode, as the port runs them; its XLA route for int8 caches
    # has other numerics), except under sp: its Pallas kernels do not trace
    # inside its shard_map on this JAX (ROADMAP C22), so its CP past runs
    # the XLA route (f32 q over the dequantized cache) where the port's B1
    # quantizes q: the logits measured 1.7e-5 / 1.8e-5 apart (int8 /
    # int8k), inside LOGITS_REL_L2
    interpret = int8_w or (int8_kv and mesh_kw.get("sp", 1) == 1)
    if int8_kv and interpret:
        kw["attention_impl"] = "pallas"
    calls = []
    orig = jprune.select_and_compact

    def record(*args, **kwargs):
        res = orig(*args, **kwargs)
        jax.debug.callback(lambda i: calls.append(np.asarray(i)),
                           res.indices)
        return res

    monkeypatch.setattr(jprune, "select_and_compact", record)
    monkeypatch.setenv("QV_COMPILE_CACHE", "0")
    if interpret:
        monkeypatch.setenv("QV_PALLAS_INTERPRET", "1")
    if act_min_dim:
        from quickvideo_tpu.ops import quantization as jq

        monkeypatch.setattr(jq, "_ACT_MIN_DIM", act_min_dim)
    jlvu = JLVUConfig(mesh=JMeshConfig(**mesh_kw), **kw)
    jmesh = jmake_mesh(jlvu.mesh)
    params = jshard_params(jax.tree.map(jnp.asarray, jp), jmesh)
    jeng = JEngine(params, JCFG, jlvu, dtype=jnp.float32, mesh=jmesh)
    ids, grid, groups, grids = build_request(n_post=7)
    ref = jeng.generate(JInputs(ids, grid, groups, grids, 2.0),
                        max_new_tokens=6)
    want_sets = list(calls)
    jcache, _ = jeng.prefill(JInputs(ids, grid, groups, grids, 2.0))
    want_lengths = np.asarray(jcache.length).tolist()
    ref_logits = _jax_final_prefill_logits(
        jeng, JInputs(ids, grid, groups, grids, 2.0))
    monkeypatch.delenv("QV_PALLAS_INTERPRET", raising=False)

    torch.save(params_from_jax(jp), tmp_path / "params.pt")
    torch.save((ids, grid, groups, grids), tmp_path / "request.pt")
    world = int(np.prod(list(mesh_kw.values())))
    ranks = run_ranks(
        tmp_path, "generate", world, lvu=dict(kw, mesh=mesh_kw),
        params=str(tmp_path / "params.pt"),
        request=str(tmp_path / "request.pt"), max_new=6,
        act_min_dim=act_min_dim,
    )
    r0 = ranks[0]
    np.testing.assert_array_equal(r0["tokens"], ref.tokens)
    assert r0["cache_length"] == ref.cache_length
    assert r0["kv_cache_bytes"] == ref.kv_cache_bytes
    assert r0["prefill_lengths"] == want_lengths
    assert len(r0["retained"]) == len(want_sets) > 0
    if not int8_w:
        # int8 towers differ between the packages (tests/test_torch_
        # engine.py compares tokens and logits only): the index sets are
        # held against one rank of the port instead
        assert _as_multiset(r0["retained"]) == _as_multiset(want_sets)
    limit = INT8_LOGITS_REL_L2 if int8_w else LOGITS_REL_L2
    rel = _rel(r0["logits"], ref_logits)
    assert rel <= limit, rel
    assert int(r0["logits"].argmax()) == int(ref_logits.argmax())
    for r in ranks[1:]:  # the ranks agree bit for bit
        np.testing.assert_array_equal(r["tokens"], r0["tokens"])
        np.testing.assert_array_equal(r["logits"], r0["logits"])
        assert r["layer_lengths"] == r0["layer_lengths"]
        for a, b in zip(r["retained"], r0["retained"]):
            np.testing.assert_array_equal(a, b)
    return ranks


TP_CASES = {
    "tp2": ({"tp": 2}, {}),
    "tp2_salient_tokens": ({"tp": 2},
                           dict(top_k_predict_type="salient_tokens")),
    "tp2_query_based_dedup": (
        {"tp": 2}, dict(query_based=True,
                        top_k_predict_type="key_norms_small_deduplication")),
    "tp2_sp2": ({"tp": 2, "sp": 2}, {}),
}


@pytest.mark.parametrize("case", sorted(TP_CASES))
def test_tp_engine_matches_the_jax_engine(tmp_path, monkeypatch, case):
    """LVUEngine under tensor parallelism (local heads, all-reduced
    o-projection and MLP, predictor scores reduced over tp, gathered
    logits), with sp beside it in tp2_sp2, against the JAX engine on the
    same mesh."""
    mesh_kw, kw = TP_CASES[case]
    ranks = check_engine_against_jax(tmp_path, monkeypatch, mesh_kw, kw)
    for r in ranks:  # each rank caches its kv heads
        assert r["local_shape"][1] == CFG.text.num_key_value_heads // 2


def test_tp_int8_weights_quantize_whole_rows(tmp_path, monkeypatch):
    """int8 weights at tp = 2 with the act-quant gates lowered so that the
    row-split products (wo, wd) act-quantize: each rank quantizes its slice
    of a row with the whole row's scale (an all-reduce max over tp). Against
    the JAX engine's tp = 2 mesh (GSPMD reduces the max there), and against
    one rank of the port, whose codes are then the same."""
    from quickvideo_tpu_torch.ops import quantization as tq

    ranks = check_engine_against_jax(
        tmp_path, monkeypatch, {"tp": 2}, dict(param_dtype="int8"),
        act_min_dim=16,
    )
    monkeypatch.setattr(tq, "ACT_MIN_DIM", 16)
    params = params_from_jax(_jax_params(True))
    eng = LVUEngine(params, CFG, TLVUConfig(param_dtype="int8", **BASE),
                    torch.float32)
    ids, grid, groups, grids = build_request(n_post=7)
    cache, st = eng.prefill(PrefillInputs(ids, grid, groups, grids, 2.0))
    one = eng.final_prefill(cache, st).numpy()
    assert _rel(ranks[0]["logits"], one) <= TP_INT8_SELF_REL_L2
    sets = [i for g in st["retained"] for i in g if i is not None]
    assert len(sets) == len(ranks[0]["retained"])
    for a, b in zip(ranks[0]["retained"], sets):
        np.testing.assert_array_equal(a, b.numpy())


def test_load_params_sharded_reads_the_slices_of_load_params(tmp_path):
    """Each tp rank's tree from the checkpoint equals the slices of the
    whole tree, exactly, float and int8 (a row-split matrix quantized
    whole, then sliced)."""
    params = init_params(CFG, 0, torch.float32)
    write_checkpoint(str(tmp_path), params, CFG)
    whole = load_params(str(tmp_path), CFG, torch.float32)
    whole8 = quantize_model_params(load_params(str(tmp_path), CFG,
                                               torch.float32))
    for i in range(2):
        mesh = types.SimpleNamespace(index=lambda a, i=i: i, tp=2,
                                     device=torch.device("cpu"))
        got = load_params_sharded(str(tmp_path), CFG, mesh, torch.float32)
        _assert_trees_equal(got, shard_params(whole, i, 2))
        got8 = quantize_model_params(load_params_sharded(
            str(tmp_path), CFG, mesh, torch.float32, int8=True))
        _assert_trees_equal(got8, shard_params(whole8, i, 2))
        assert got["language"]["layers"][0]["wo"].shape == (24, 48)
        assert got["language"]["lm_head"].shape == (48, 512)


def _assert_trees_equal(a, b):
    la, lb = list(tensor_leaves(a)), list(tensor_leaves(b))
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


def test_sharded_init_holds_the_slices_of_the_single_device_tree():
    """init_params(mesh=) on each tp rank: the slices of the same seed's
    whole tree (int8: quantized whole, then sliced), and global_nbytes
    counts the whole model from either rank."""
    for pd in (None, "int8"):
        whole = init_params(CFG, 0, torch.float32, param_dtype=pd)
        n = sum(t.nbytes for t in tensor_leaves(whole))
        for i in range(2):
            mesh = types.SimpleNamespace(index=lambda a, i=i: i, tp=2)
            part = init_params(CFG, 0, torch.float32, param_dtype=pd,
                               mesh=mesh)
            _assert_trees_equal(part, shard_params(whole, i, 2))
            assert global_nbytes(part, 2) == n


def test_chat_sessions_move_between_a_mesh_and_one_device(tmp_path,
                                                           monkeypatch):
    """A session saved under sp = 2 (the windows gathered into the JAX
    package's .npz) resumed on one device, and one saved on one device
    resumed under sp = 2 (capacity rounded to 4096 * sp, re-split): every
    answer equals the single-device session's, and the two files hold the
    same cache."""
    patch_port_readers(monkeypatch.setattr)
    params = params_from_jax(_jax_params(False))
    torch.save(params, tmp_path / "params.pt")
    kw = dict(BASE, model_type="qwen25_lvu", num_frames=8,
              video_group_size=4, decode_output="yuv420")
    questions = ["What moves?", "And then?"]
    lvu = TLVU(TLVUConfig(**kw), params=params, device="cpu")
    s = lvu.start_chat("clip.mp4")
    first = s.ask(questions[0], max_new_tokens=4)
    s.save(str(tmp_path / "one.npz"))
    second = s.ask(questions[1], max_new_tokens=4)
    ranks = run_ranks(
        tmp_path, "chat", 2, lvu=dict(kw, mesh={"sp": 2}),
        params=str(tmp_path / "params.pt"), questions=questions,
        save=str(tmp_path / "mesh.npz"), resume=str(tmp_path / "one.npz"),
    )
    for r in ranks:
        assert (r["first"], r["second"]) == (first, second)
        assert r["capacity"] % 8192 == 0
        assert r["local_shape"][2] == r["capacity"] // 2
    resumed = TLVU(TLVUConfig(**kw), params=params,
                   device="cpu").resume_chat(str(tmp_path / "mesh.npz"))
    assert resumed.ask(questions[1], max_new_tokens=4) == second
    one, two = np.load(tmp_path / "one.npz"), np.load(tmp_path / "mesh.npz")
    assert sorted(one.files) == sorted(two.files)
    for name in ("k", "v", "length", "ids", "tail", "pos_prefix"):
        np.testing.assert_allclose(two[name], one[name], atol=1e-5,
                                   err_msg=name)
    assert json.loads(str(two["meta"]))["capacity"] == json.loads(
        str(one["meta"]))["capacity"]


@pytest.mark.parametrize("mesh_kw", [{"tp": 2}, {"sp": 2}],
                         ids=["tp2", "sp2"])
def test_scoring_batching_and_lvu_generate_under_a_mesh(tmp_path,
                                                        monkeypatch,
                                                        mesh_kw):
    """LVU.loglikelihood_multi, LVU.generate and BatchedQAEngine on a mesh
    of gloo ranks give one device's scores (within 1e-4, the tolerance of
    tests/test_torch_scoring.py), answers and batched tokens."""
    from torch_mesh_ranks import _score_batch_and_answer

    patch_port_readers(monkeypatch.setattr)
    params = params_from_jax(_jax_params(False))
    torch.save(params, tmp_path / "params.pt")
    request = build_request(n_post=7)
    torch.save(request, tmp_path / "request.pt")
    kw = dict(BASE, num_frames=8, video_group_size=4, decode_output="yuv420")
    want = _score_batch_and_answer(
        TLVU(TLVUConfig(**kw), params=params, device="cpu"), request)
    ranks = run_ranks(tmp_path, "score", 2, lvu=dict(kw, mesh=mesh_kw),
                      params=str(tmp_path / "params.pt"),
                      request=str(tmp_path / "request.pt"))
    for r in ranks:
        assert r["answer"] == want["answer"]
        assert r["batch"] == want["batch"]
        for (lp, greedy), (lp0, greedy0) in zip(r["scores"], want["scores"]):
            assert greedy == greedy0 and abs(lp - lp0) <= 1e-4


CLI_ARGV = ["--model_name_or_path", "tiny", "--dtype", "float32",
            "--num_frames", "8", "--video_group_size", "4",
            "--max_new_tokens", "4", "--decode_output", "yuv420",
            "--video_path", "clip.mp4", "--question", "What moves?",
            "--json", "--device", "cpu"]


def test_cli_runs_under_a_mesh_of_two_gloo_ranks(tmp_path, monkeypatch,
                                                 capsys):
    """lvu_cli.main --mesh 1,1,2,1 in two ranks (the process group from
    QV_COORDINATOR / QV_NUM_PROCESSES / QV_PROCESS_ID, gloo for --device
    cpu): rank 0 prints the single-device CLI's answer and cache length,
    rank 1 prints nothing."""
    from quickvideo_tpu_torch import lvu_cli

    patch_port_readers(monkeypatch.setattr)
    assert lvu_cli.main(CLI_ARGV) == 0
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    ranks = run_ranks(tmp_path, "cli", 2,
                      argv=CLI_ARGV + ["--mesh", "1,1,2,1"])
    assert [r["rc"] for r in ranks] == [0, 0]
    got = [json.loads(line) for line in ranks[0]["lines"]
           if line.startswith("{")]
    assert ranks[1]["lines"] == []
    assert len(got) == len(want) == 1
    for row in (got[0], want[0]):
        row.pop("timings")
    assert got == want


@pytest.mark.parametrize("mesh_kw,error,match", [
    ({"pp": 3, "sp": 2}, ValueError, "pp does not compose with sp"),
    ({"pp": 2}, ValueError, "num_hidden_layers=3 not divisible by pp=2"),
    ({"tp": 4}, NotImplementedError, "tp=4"),
    ({"tp": 3}, NotImplementedError, "tp=3"),
])
def test_pp_and_a_tp_that_does_not_divide_the_heads_raise(mesh_kw, error,
                                                          match):
    """What a mesh cannot run raises before any process group is asked
    for: pp beside sp and a pp that does not divide the tiny preset's 3
    layers (ValueError, the JAX engine's messages; until pipeline
    parallelism was ported these cases were pp = 2 and pp = 2 x tp = 2,
    NotImplementedError), and a tp that does not divide its 4 q / 2 kv
    heads (NotImplementedError)."""
    cfg = TLVUConfig(mesh=MeshConfig(**mesh_kw), **BASE)
    params = init_params(CFG, 0, torch.float32)
    with pytest.raises(error, match=match):
        TLVU(cfg, params=params, device="cpu")
    with pytest.raises(error, match=match):
        LVUEngine(params, CFG, cfg, torch.float32)


def test_a_mesh_needs_its_processes():
    """Without a process group a multi-device mesh raises with how to
    launch it; an engine given a mesh config but no Mesh raises too;
    init_multihost is a no-op in a single-process run."""
    assert tmesh.init_multihost(num_processes=1) is False
    with pytest.raises(RuntimeError, match="torchrun"):
        tmesh.make_mesh(MeshConfig(tp=2), "cpu")
    with pytest.raises(ValueError, match="Mesh"):
        LVUEngine(init_params(CFG, 0, torch.float32), CFG,
                  TLVUConfig(mesh=MeshConfig(sp=2), **BASE), torch.float32)
    one = tmesh.make_mesh(MeshConfig(), "cpu")
    assert one.groups == dict.fromkeys(tmesh.AXES) and one.is_first


def test_rank_layout_is_the_jax_meshs():
    """Global rank r sits at the (dp, pp, tp, sp) coordinates of device r
    in the JAX package's reshape (inner axes neighbours)."""
    cfg = MeshConfig(dp=2, pp=1, tp=2, sp=2)
    grid = np.arange(8).reshape(2, 1, 2, 2)
    for r in range(8):
        coords = tmesh._coords(cfg, r)
        assert grid[coords] == r and tmesh._rank_of(cfg, coords) == r
    assert tmesh._ranks_along(cfg, ("tp", "sp"), (1, 0, 0, 0)) == [4, 5, 6, 7]
    assert tmesh._ranks_along(cfg, ("sp",), (0, 0, 1, 0)) == [2, 3]


def test_collectives_of_one_rank_return_their_input():
    x = torch.arange(6.0).reshape(2, 3)
    for f in (comm.all_reduce_sum, comm.all_reduce_max, comm.all_gather):
        assert f(x, None) is x
    assert comm.group_size(None) == 1


@pytest.mark.parametrize("dp_index,want", [(0, [0, 2, 4]), (1, [1, 3])])
def test_shard_samples_follows_the_dp_axis(dp_index, want):
    """Under a mesh the samples split over dp, not over every rank: the tp
    ranks of one request share them."""
    mesh = types.SimpleNamespace(index=lambda a: dp_index,
                                 size=lambda a: 2)
    assert tqa.shard_samples(list(range(5)), mesh=mesh) == want
    assert tqa.shard_samples(list(range(5)), dp_index, 2) == want
