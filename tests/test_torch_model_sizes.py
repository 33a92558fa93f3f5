"""The PyTorch port at the structures of the other two model sizes,
against the JAX package, on the CPU in f32 with tiny widths.

The presets (models/qwen25_vl/config.py) differ from the 7B in more than
width: the 3B has 16 q heads over 2 kv heads (8 per group, where the 7B has
7) and a merger whose output is the text width; the 72B has 64 over 8 (8
per group), a text rmsnorm eps of 1e-5 and a vision `tokens_per_second` of
4.0 (its M-RoPE time positions). STRUCTURES scales each down to tiny's
widths with those ratios and fields kept. Each goes through `LVU(dir)` from
a checkpoint directory that `quickvideo_tpu_torch.testing.write_checkpoint`
writes (its config.json carries the fields), against the JAX engine built
from the JAX package's `get_config(dir)` on the same weights, on its kernel
route (attention_impl="pallas", QV_PALLAS_INTERPRET=1). Compared exactly:
greedy tokens, cache length, per-layer lengths and every retained index set
(read from the JAX side with jax.debug.callback around select_and_compact);
the final-prefill logits by rel. L2 under tests/test_torch_parallel.py's
limits. On gloo ranks (tests/torch_mesh_ranks.py): tp = 2 at the 3B's 16 : 2
heads and pp = 2 at the 72B's structure, against the JAX engine on the same
mesh, each rank reading its part of the directory with load_params_sharded.

Also ROADMAP C26: kv_cache_dtype="auto" at the 3B's and the 72B's full
weight bytes (counted from the presets, nothing allocated) resolves alike
in both packages' engines, and for the 72B to int8 even at 4096 slots.
"""

import dataclasses
import types
from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quickvideo_tpu.config import LVUConfig as JLVUConfig
from quickvideo_tpu.config import MeshConfig as JMeshConfig
from quickvideo_tpu.models.qwen25_vl import model as jmodel
from quickvideo_tpu.models.qwen25_vl.config import get_config as jget_config
from quickvideo_tpu.models.qwen25_vl.language import StepSpec as JStepSpec
from quickvideo_tpu.ops import prune as jprune
from quickvideo_tpu.parallel import make_mesh as jmake_mesh
from quickvideo_tpu.parallel import shard_params as jshard_params
from quickvideo_tpu.prefill import LVUEngine as JEngine
from quickvideo_tpu.prefill import PrefillInputs as JInputs
from quickvideo_tpu_torch.api import LVU as TLVU
from quickvideo_tpu_torch.config import LVUConfig as TLVUConfig
from quickvideo_tpu_torch.models.qwen25_vl.config import PRESETS
from quickvideo_tpu_torch.models.qwen25_vl.config import get_config
from quickvideo_tpu_torch.models.qwen25_vl.convert import params_from_jax
from quickvideo_tpu_torch.prefill import LVUEngine as TEngine
from quickvideo_tpu_torch.prefill import PrefillInputs
from quickvideo_tpu_torch.testing import write_checkpoint
from test_torch_engine import build_request
from test_torch_parallel import INT8_LOGITS_REL_L2, LOGITS_REL_L2, _rel
from torch_mesh_ranks import run_ranks

torch.set_num_threads(2)

TINY = jget_config("tiny")
# tiny's widths (head dim 12, M-RoPE sections (2, 2, 2)) at each size's
# head ratio and fields; 4 layers, so that pp = 2 splits them
STRUCTURES = {
    # 16 : 2 scaled to 8 : 1; merger out = the text width
    "3b": dict(text=dict(hidden_size=96, num_attention_heads=8,
                         num_key_value_heads=1),
               vision=dict(out_hidden_size=96)),
    # 64 : 8 scaled to 8 : 1; text eps 1e-5; 4 M-RoPE time steps a second
    "72b": dict(text=dict(hidden_size=96, num_attention_heads=8,
                          num_key_value_heads=1, rms_norm_eps=1e-5),
                vision=dict(out_hidden_size=96, tokens_per_second=4.0)),
    # the 3B's own 16 : 2, which tp = 2 splits into two 8 : 1 ranks
    "3b_tp": dict(text=dict(hidden_size=192, num_attention_heads=16,
                            num_key_value_heads=2),
                  vision=dict(out_hidden_size=192)),
}
MAX_NEW = 6


def structure(name: str):
    """The JAX package's ModelConfig of STRUCTURES[name]."""
    s = STRUCTURES[name]
    return dataclasses.replace(
        TINY, name=name,
        text=dataclasses.replace(TINY.text, num_hidden_layers=4,
                                 intermediate_size=192, **s["text"]),
        vision=dataclasses.replace(TINY.vision, **s["vision"]))


def port_config(jcfg):
    """The port's ModelConfig of the same fields as the JAX package's."""
    tiny = get_config("tiny")
    t, v = jcfg.text, jcfg.vision
    return dataclasses.replace(
        tiny, name=jcfg.name,
        text=dataclasses.replace(tiny.text, **{
            f.name: getattr(t, f.name) for f in dataclasses.fields(t)}),
        vision=dataclasses.replace(tiny.vision, **{
            f.name: getattr(v, f.name) for f in dataclasses.fields(v)}))


_CKPT = {}


def checkpoint(tmp_path_factory, name: str):
    """(directory, JAX config read back from it, float JAX weights as
    numpy): seed-0 JAX weights of the structure written as a checkpoint
    directory of the port's testing helper."""
    if name not in _CKPT:
        jcfg = structure(name)
        jp = jax.tree.map(np.asarray, jmodel.init_params(
            jcfg, seed=0, dtype=jnp.float32))
        d = str(tmp_path_factory.mktemp(f"ckpt_{name}"))
        write_checkpoint(d, params_from_jax(jp), port_config(jcfg))
        read = jget_config(d)
        assert (read.text, read.vision) == (jcfg.text, jcfg.vision)
        _CKPT[name] = (d, read, jp)
    return _CKPT[name]


def _jax_final_prefill_logits(eng, inputs):
    """The JAX engine's final-prefill logits (its padded-bucket program, as
    _generate_from_cache runs it), at the engine's own config."""
    cache, st = eng.prefill(inputs)
    ss, n = st["suffix_start"], st["L"] - st["suffix_start"]
    bucket = max(32, -(-n // 32) * 32)
    ids_pad = np.zeros(bucket, np.int64)
    ids_pad[:n] = st["ids"][ss:]
    spec = JStepSpec(cfg=eng.cfg.text, q_len=bucket, keep_k=0,
                     attn_impl=eng.lvu.attention_impl,
                     kv_quant=eng._cache_quant(cache), cp_mesh=eng.cp_mesh)
    _, logits = eng._final_prefill_jit(
        eng.params["language"], cache, jnp.asarray(ids_pad, jnp.int32),
        st["cos"][ss : ss + bucket], st["sin"][ss : ss + bucket],
        np.int32(0), np.int32(n), spec=spec, img=st.get("img_suffix"))
    return np.asarray(logits)


def _jax_weights(jp, int8: bool):
    if not int8:
        return jax.tree.map(jnp.asarray, jp)
    from quickvideo_tpu.ops import quantization as jq

    # the JAX quantizer donates its input: give it a copy
    return jq.quantize_model_params(jax.tree.map(jnp.array, jp))


def _record_retained(monkeypatch, with_keys=False):
    """The JAX engine's select_and_compact index sets, in call order (with
    `with_keys`, beside whether the keys were live: the skewed pipeline's
    fill and drain ticks run all-zero junk groups)."""
    calls = []
    orig = jprune.select_and_compact

    def record(*args, **kw):
        res = orig(*args, **kw)
        if with_keys:
            jax.debug.callback(
                lambda i, k: calls.append((np.asarray(i), bool(np.any(k)))),
                res.indices, args[2])
        else:
            jax.debug.callback(lambda i: calls.append(np.asarray(i)),
                               res.indices, ordered=True)
        return res

    monkeypatch.setattr(jprune, "select_and_compact", record)
    monkeypatch.setenv("QV_COMPILE_CACHE", "0")
    return calls


@pytest.mark.parametrize("top_p", [None, 0.5])
@pytest.mark.parametrize("weights", ["float", "int8"])
@pytest.mark.parametrize("size", ["3b", "72b"])
def test_size_matches_the_jax_engine(tmp_path_factory, monkeypatch, size,
                                     weights, top_p):
    """LVU(dir) on the CPU against the JAX engine at the size's structure:
    tokens, cache length, per-layer lengths and every retained set exactly,
    the final-prefill logits by rel. L2."""
    d, jcfg, jp = checkpoint(tmp_path_factory, size)
    int8 = weights == "int8"
    kw = dict(model_name_or_path=d, top_p=top_p, max_decode_tokens=8,
              dtype="float32", attention_impl="pallas",
              param_dtype="int8" if int8 else "bfloat16")
    ids, grid, groups, grids = build_request(n_post=7)
    calls = _record_retained(monkeypatch)
    monkeypatch.setenv("QV_PALLAS_INTERPRET", "1")
    jeng = JEngine(_jax_weights(jp, int8), jcfg, JLVUConfig(**kw),
                   dtype=jnp.float32)
    ref = jeng.generate(JInputs(ids, grid, groups, grids, 2.0),
                        max_new_tokens=MAX_NEW)
    jax.effects_barrier()
    calls.clear()
    jcache, _ = jeng.prefill(JInputs(ids, grid, groups, grids, 2.0))
    jax.effects_barrier()
    want_sets = list(calls)
    ref_logits = _jax_final_prefill_logits(
        jeng, JInputs(ids, grid, groups, grids, 2.0))
    monkeypatch.delenv("QV_PALLAS_INTERPRET")

    lvu = TLVU(TLVUConfig(**kw), device="cpu")
    assert lvu.model_config.text == get_config(d).text
    assert (lvu.model_config.text.rms_norm_eps,
            lvu.model_config.vision.tokens_per_second) == (
        jcfg.text.rms_norm_eps, jcfg.vision.tokens_per_second)
    got = lvu.engine.generate(PrefillInputs(ids, grid, groups, grids, 2.0),
                              max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    assert got.cache_length == ref.cache_length
    assert got.kv_cache_bytes == ref.kv_cache_bytes
    cache, st = lvu.engine.prefill(PrefillInputs(ids, grid, groups, grids,
                                                 2.0))
    assert cache.lengths == np.asarray(jcache.length).tolist()
    sets = [i for g in st["retained"] for i in g if i is not None]
    assert len(sets) == len(want_sets) == (
        0 if top_p is None else len(grids) * jcfg.text.num_hidden_layers)
    for n, (a, b) in enumerate(zip(sets, want_sets)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f"call {n}")
    logits = lvu.engine.final_prefill(cache, st).numpy()
    rel = _rel(logits, ref_logits)
    assert rel <= (INT8_LOGITS_REL_L2 if int8 else LOGITS_REL_L2), rel
    assert int(logits.argmax()) == int(ref_logits.argmax())


def _multiset(sets):
    return Counter(tuple(int(i) for i in np.asarray(s)) for s in sets)


# mesh -> the structure it runs
MESH_CASES = {"tp2": ({"tp": 2}, "3b_tp"), "pp2": ({"pp": 2}, "72b")}


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_size_on_a_mesh_matches_the_jax_mesh(tmp_path_factory, tmp_path,
                                             monkeypatch, case):
    """LVU(dir) on gloo ranks (each reading its tp slices or its stage's
    tensors from the directory, and load_params_sharded giving the same
    part) against the JAX engine on the same mesh: tokens, cache length,
    per-layer lengths and the retained sets (as multisets: a mesh's
    callbacks are unordered; under pp the junk ticks' are dropped), the
    final-prefill logits; the ranks agree bit for bit."""
    mesh_kw, name = MESH_CASES[case]
    d, jcfg, jp = checkpoint(tmp_path_factory, name)
    pp = mesh_kw.get("pp", 1)
    kw = dict(model_name_or_path=d, top_p=0.5, max_decode_tokens=8,
              dtype="float32")
    ids, grid, groups, grids = build_request(n_post=7)
    calls = _record_retained(monkeypatch, with_keys=True)
    jlvu = JLVUConfig(mesh=JMeshConfig(**mesh_kw), **kw)
    jmesh = jmake_mesh(jlvu.mesh)
    weights = jax.tree.map(jnp.asarray, jp)
    if pp == 1:
        weights = jshard_params(weights, jmesh)
    jeng = JEngine(weights, jcfg, jlvu, dtype=jnp.float32, mesh=jmesh)

    def inputs():
        return JInputs(ids, grid, groups, grids, 2.0)

    ref = jeng.generate(inputs(), max_new_tokens=MAX_NEW)
    jax.effects_barrier()
    calls.clear()
    jcache, st = jeng.prefill(inputs())
    jax.effects_barrier()
    want_sets = [i for i, live in calls if live]
    if pp == 1:
        want_lengths = np.asarray(jcache.length).tolist()
        ref_logits = _jax_final_prefill_logits(jeng, inputs())
    else:  # the pp path's final prefill: the suffix as one chunk
        stack = st["pp_stack"]
        want_lengths = np.asarray(stack.gather_cache().length).tolist()
        ss, L = st["suffix_start"], st["L"]
        spec = JStepSpec(cfg=jcfg.text, q_len=L - ss, keep_k=0,
                         attn_impl=jeng.lvu.attention_impl,
                         kv_quant=stack.quantized)
        x = jeng._embed_scatter_jit(jeng.params["language"]["embed"],
                                    jnp.asarray(ids[ss:], jnp.int32), None,
                                    st.get("img_suffix"))
        x, c, s = (jax.device_put(a, jeng._pp_rep)
                   for a in (x, st["cos"][ss:L], st["sin"][ss:L]))
        h = stack.chunk(x, c, s, spec)
        ref_logits = np.asarray(jeng._logits_jit(
            jeng.params["language"], np.asarray(h[-1]), jcfg.text))

    torch.save((ids, grid, groups, grids), tmp_path / "request.pt")
    world = int(np.prod(list(mesh_kw.values())))
    ranks = run_ranks(
        tmp_path, "generate", world, lvu=dict(kw, mesh=mesh_kw), params=None,
        request=str(tmp_path / "request.pt"), max_new=MAX_NEW,
        sharded_load=d)
    r0 = ranks[0]
    np.testing.assert_array_equal(r0["tokens"], ref.tokens)
    assert r0["cache_length"] == ref.cache_length
    assert r0["kv_cache_bytes"] == ref.kv_cache_bytes
    assert r0["prefill_lengths"] == want_lengths
    # under tp every rank holds every set, under pp each stage its own
    # layers'
    sets = [s for r in (ranks if pp > 1 else ranks[:1])
            for s in r["retained"]]
    assert len(sets) == len(grids) * jcfg.text.num_hidden_layers
    assert _multiset(sets) == _multiset(want_sets)
    rel = _rel(r0["logits"], ref_logits)
    assert rel <= LOGITS_REL_L2, rel
    assert int(r0["logits"].argmax()) == int(ref_logits.argmax())
    for r in ranks:
        assert r["sharded_load"] == "equal", r["sharded_load"]
        np.testing.assert_array_equal(r["tokens"], r0["tokens"])
        np.testing.assert_array_equal(r["logits"], r0["logits"])
        assert r["layer_lengths"] == r0["layer_lengths"]


def _weight_bytes(cfg, itemsize=2) -> int:
    """The whole model's float weight bytes, counted from the config as
    init_params draws it (matrices, norms, biases)."""
    t, v = cfg.text, cfg.vision
    c, hd = t.hidden_size, t.head_dim
    hq, hkv = t.num_attention_heads * hd, t.num_key_value_heads * hd
    f = t.intermediate_size
    layer = (2 * c + c * hq + hq + 2 * (c * hkv + hkv) + hq * c + 3 * c * f)
    lang = 2 * t.vocab_size * c + c + t.num_hidden_layers * layer
    vc, vi = v.hidden_size, v.intermediate_size
    block = 2 * vc + 4 * vc * vc + 4 * vc + 3 * vc * vi + 2 * vi + vc
    md = vc * v.spatial_merge_unit
    merger = vc + md * md + md + md * v.out_hidden_size + v.out_hidden_size
    vision = v.patch_input_dim * vc + v.depth * block + merger
    return itemsize * (lang + vision)


def test_weight_bytes_count_matches_the_drawn_tree():
    """_weight_bytes counts what init_params draws (tiny and 3b_tp, whose
    trees are small enough to draw)."""
    from quickvideo_tpu_torch.models.qwen25_vl.convert import init_params
    from quickvideo_tpu_torch.prefill.engine import tensor_leaves

    for jcfg in (TINY, structure("3b_tp")):
        p = init_params(port_config(jcfg), seed=0, dtype=torch.bfloat16)
        assert sum(t.numel() * t.element_size()
                   for t in tensor_leaves(p)) == _weight_bytes(jcfg)


@pytest.mark.parametrize("capacity", [4096, 131072])
@pytest.mark.parametrize("size", ["qwen25-vl-3b", "qwen25-vl-72b"])
def test_auto_kv_dtype_at_the_presets_weight_bytes(monkeypatch, size,
                                                   capacity):
    """ROADMAP C26: both packages' LVUEngine.resolve_kv_dtype, given the
    preset's whole bf16 weight bytes (counted, not allocated) and one
    80 GiB card, pick the same cache. The rule compares the whole model
    with one device's memory, so the 72B (146.8 GB) always gets int8,
    even where a mesh splits the weights over four cards."""
    cfg = PRESETS[size]
    wbytes = _weight_bytes(cfg)
    monkeypatch.setenv("QV_HBM_GB", "80")
    lvu_kw = dict(model_name_or_path=size, kv_cache_dtype="auto")
    port = types.SimpleNamespace(
        lvu=TLVUConfig(**lvu_kw), cfg=cfg, dtype=torch.bfloat16,
        _weight_bytes=wbytes, device=torch.device("cpu"))
    port.device_memory_bytes = lambda: TEngine.device_memory_bytes(port)
    got = TEngine.resolve_kv_dtype(port, capacity)
    jax_side = types.SimpleNamespace(
        lvu=JLVUConfig(**lvu_kw), cfg=jget_config(size), dtype=jnp.bfloat16,
        _weight_bytes=wbytes)
    want = JEngine.resolve_kv_dtype(jax_side, capacity)
    assert got == want
    gb = wbytes / 1e9
    if size == "qwen25-vl-72b":
        assert 146 < gb < 148 and got == "int8"
    else:
        assert 8 < gb < 9
        assert got == ("int8" if capacity > 65536 else "bfloat16")


def test_chip_smoke_cuts_a_preset_in_depth():
    """chip_smoke.make_lvu(..., layers=) builds the preset at that depth
    (the 72B at 8 of its 80 layers on one card): the seeded weights are
    drawn at that depth, a request gives what an LVUEngine on init_params
    of the cut config gives, and the published preset is restored."""
    import chip_smoke
    from quickvideo_tpu_torch.models.qwen25_vl.convert import init_params

    tiny = get_config("tiny")
    cut = dataclasses.replace(tiny, text=dataclasses.replace(
        tiny.text, num_hidden_layers=2))
    lvu = chip_smoke.make_lvu("cpu", None, model="tiny", layers=2,
                              dtype="float32")
    assert lvu.model_config == cut
    assert get_config("tiny") is tiny
    assert len(lvu.params["language"]["layers"]) == 2
    ids, grid, groups, grids = build_request()
    got = lvu.engine.generate(PrefillInputs(ids, grid, groups, grids, 2.0),
                              max_new_tokens=4)
    eng = TEngine(init_params(cut, seed=0, dtype=torch.float32), cut,
                  lvu.config, torch.float32)
    want = eng.generate(PrefillInputs(ids, grid, groups, grids, 2.0),
                        max_new_tokens=4)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.layer_lengths == want.layer_lengths and len(
        got.layer_lengths) == 2


@pytest.mark.parametrize("param_dtype", [None, "int8"])
def test_sharded_init_at_the_3bs_heads_holds_the_whole_trees_slices(
        param_dtype):
    """init_params(mesh=) on each tp = 2 rank of the 3B's 16 : 2 heads
    (8 : 1 a rank): the slices of the same seed's whole tree; with int8
    weights each matrix quantized whole, so every rank's scales are the
    whole matrix's."""
    from quickvideo_tpu_torch.models.qwen25_vl.convert import init_params
    from quickvideo_tpu_torch.parallel.sharding import shard_params
    from test_torch_parallel import _assert_trees_equal

    cfg = port_config(structure("3b_tp"))
    whole = init_params(cfg, 0, torch.float32, param_dtype=param_dtype)
    for i in range(2):
        mesh = types.SimpleNamespace(index=lambda a, i=i: i, tp=2)
        part = init_params(cfg, 0, torch.float32, param_dtype=param_dtype,
                           mesh=mesh)
        _assert_trees_equal(part, shard_params(whole, i, 2))


@pytest.mark.parametrize("rule", ["col", "row"])
def test_a_sharded_int8_leaf_keeps_no_view_of_the_whole_matrix(rule):
    """shard_leaf of a quantized matrix copies its slice: a column slice
    of quantize_weight's (in, out) view of a row-major (out, in) tensor is
    contiguous once transposed, and a view of it would keep the whole
    matrix alive on every rank (the 72B's int8 weights over tp = 2 ran a
    rank out of card memory so)."""
    from quickvideo_tpu_torch.ops.quantization import quantize_weight
    from quickvideo_tpu_torch.parallel.sharding import COL, ROW, shard_leaf

    w = torch.randn(64, 96)
    leaf = quantize_weight(w, -2)
    part = shard_leaf(leaf, COL if rule == "col" else ROW, 1, 2)
    whole = leaf["q8"].untyped_storage()
    for t in (part["q8"], part["sc"]):
        assert t.untyped_storage().data_ptr() != whole.data_ptr()
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()
    want = leaf["q8"][:, 48:] if rule == "col" else leaf["q8"][32:]
    assert torch.equal(part["q8"], want)
    assert part["q8"].t().is_contiguous()
