"""Pipeline parallelism in the PyTorch port (quickvideo_tpu_torch/parallel/
pipeline.py and the engine's pp routes) against the JAX engine on its pp
mesh (quickvideo_tpu/parallel/pipeline.py's PipelinedStack, on the
conftest's 8 virtual CPU devices), tiny preset in f32, the same weights and
request.

The port's ranks are real gloo processes (tests/torch_mesh_ranks.py): one
launch of pp = 3 runs every case's LVU in turn, one of pp = 3 x tp = 2 the
tp case. tiny has 3 layers, one per stage. Compared, per case: greedy
tokens, cache_length, kv_cache_bytes and the per-layer lengths (the JAX
side from its stack's gather_cache), exactly; every retained index set as
multisets (the JAX sets read with jax.debug.callback around
select_and_compact; its skewed pipeline's fill and drain ticks run junk
groups of zero hidden states, whose all-zero keys mark their callbacks,
which are dropped; under tp every tp device of a stage calls back, so each
set comes tp times); the final-prefill logits by rel. L2 under the limits
of tests/test_torch_parallel.py (1e-4; int8 weights 3e-2, where the two
packages' vision towers differ); and the ranks' agreement, bit for bit.
"""

from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quickvideo_tpu.config import LVUConfig as JLVUConfig
from quickvideo_tpu.config import MeshConfig as JMeshConfig
from quickvideo_tpu.models.qwen25_vl.language import StepSpec as JStepSpec
from quickvideo_tpu.ops import prune as jprune
from quickvideo_tpu.parallel import make_mesh as jmake_mesh
from quickvideo_tpu.prefill import LVUEngine as JEngine
from quickvideo_tpu.prefill import PrefillInputs as JInputs
from quickvideo_tpu_torch.models.qwen25_vl.convert import params_from_jax
from test_torch_engine import CFG as JCFG
from test_torch_engine import build_request
from test_torch_parallel import (
    INT8_LOGITS_REL_L2,
    LOGITS_REL_L2,
    _jax_params,
    _rel,
)
from torch_mesh_ranks import run_ranks

torch.set_num_threads(2)

KW = dict(model_name_or_path="tiny", top_p=0.5, max_decode_tokens=8,
          dtype="float32")
# case -> (mesh, LVUConfig keywords)
CASES = {
    "key_norms_small": ({"pp": 3}, {}),
    "pp3_tp2": ({"pp": 3, "tp": 2}, {}),
    "int8_kv": ({"pp": 3}, dict(kv_cache_dtype="int8",
                                attention_impl="pallas")),
    "int8_weights": ({"pp": 3}, dict(param_dtype="int8")),
    "salient_tokens": ({"pp": 3}, dict(top_k_predict_type="salient_tokens")),
}
MAX_NEW = 6


def _int8_w(kw):
    return kw.get("param_dtype") == "int8"


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every case through the port's ranks: one launch per mesh, each
    LVU in turn; {case: the ranks' pipeline_record results}."""
    tmp = tmp_path_factory.mktemp("pp_engine")
    torch.save(build_request(n_post=7), tmp / "request.pt")
    for int8 in (False, True):
        torch.save(params_from_jax(_jax_params(int8)),
                   tmp / f"params{int(int8)}.pt")
    out = {}
    for mesh_kw in ({"pp": 3}, {"pp": 3, "tp": 2}):
        mine = [c for c, (m, _) in CASES.items() if m == mesh_kw]
        ranks = run_ranks(
            tmp, "pipeline", int(np.prod(list(mesh_kw.values()))),
            request=str(tmp / "request.pt"), max_new=MAX_NEW,
            runs=[dict(lvu=dict(KW, **CASES[c][1], mesh=mesh_kw),
                       modes=False, params=str(
                           tmp / f"params{int(_int8_w(CASES[c][1]))}.pt"))
                  for c in mine],
        )
        for i, c in enumerate(mine):
            out[c] = [r["runs"][i] for r in ranks]
    return out


def jax_pp_engine(mesh_kw, kw, monkeypatch):
    """The JAX engine on a MeshConfig(**mesh_kw) mesh with the request:
    (generate's result, per-layer lengths after its prefill, the retained
    sets of that prefill without the junk ticks', the final-prefill
    logits of its pp path (the suffix as one sequential chunk, the logits
    of its last row, as _generate_from_stack runs them))."""
    calls = []
    orig = jprune.select_and_compact

    def record(*args, **kwargs):
        res = orig(*args, **kwargs)
        jax.debug.callback(
            lambda i, k: calls.append((np.asarray(i), bool(np.any(k)))),
            res.indices, args[2])
        return res

    monkeypatch.setattr(jprune, "select_and_compact", record)
    monkeypatch.setenv("QV_COMPILE_CACHE", "0")
    interpret = _int8_w(kw) or kw.get("kv_cache_dtype") in ("int8", "int8k")
    if interpret:
        monkeypatch.setenv("QV_PALLAS_INTERPRET", "1")
    jlvu = JLVUConfig(mesh=JMeshConfig(**mesh_kw), **KW, **kw)
    jp = jax.tree.map(jnp.asarray, _jax_params(_int8_w(kw)))
    eng = JEngine(jp, JCFG, jlvu, dtype=jnp.float32,
                  mesh=jmake_mesh(jlvu.mesh))
    ids, grid, groups, grids = build_request(n_post=7)

    def inputs():
        return JInputs(ids, grid, groups, grids, 2.0)

    res = eng.generate(inputs(), max_new_tokens=MAX_NEW)
    calls.clear()
    _, st = eng.prefill(inputs())
    jax.effects_barrier()
    sets = [i for i, live in calls if live]
    stack = st["pp_stack"]
    lengths = np.asarray(stack.gather_cache().length).tolist()
    ss, L = st["suffix_start"], st["L"]
    spec = JStepSpec(cfg=JCFG.text, q_len=L - ss, keep_k=0,
                     attn_impl=eng.lvu.attention_impl,
                     kv_quant=stack.quantized)
    x = eng._embed_scatter_jit(eng.params["language"]["embed"],
                               jnp.asarray(ids[ss:], jnp.int32), None,
                               st.get("img_suffix"))
    x, c, s = (jax.device_put(a, eng._pp_rep)
               for a in (x, st["cos"][ss:L], st["sin"][ss:L]))
    h = stack.chunk(x, c, s, spec)
    logits = np.asarray(eng._logits_jit(eng.params["language"],
                                        np.asarray(h[-1]), JCFG.text))
    monkeypatch.delenv("QV_PALLAS_INTERPRET", raising=False)
    return res, lengths, sets, logits


def _multiset(sets):
    return Counter(tuple(int(i) for i in np.asarray(s)) for s in sets)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pp_engine_matches_the_jax_engine(port_runs, monkeypatch, case):
    """LVUEngine under pipeline parallelism (each stage its slab of layers
    and cache, activations sent on, the token broadcast from the last
    stage) against the JAX engine's skewed pipeline on the same mesh."""
    mesh_kw, kw = CASES[case]
    ranks = port_runs[case]
    ref, want_lengths, want_sets, ref_logits = jax_pp_engine(mesh_kw, kw,
                                                             monkeypatch)
    r0 = ranks[0]
    np.testing.assert_array_equal(r0["tokens"], ref.tokens)
    assert r0["cache_length"] == ref.cache_length
    assert r0["kv_cache_bytes"] == ref.kv_cache_bytes
    assert r0["prefill_lengths"] == want_lengths
    tp = mesh_kw.get("tp", 1)
    # each rank holds its stage's layers' sets; the tp ranks of a stage
    # hold the same ones, as the JAX tp devices call back the same
    sets = [s for r in ranks for s in r["retained"].values()]
    assert len(sets) > 0
    if not _int8_w(kw):
        # int8 towers differ between the packages (tests/test_torch_
        # engine.py): their sets are held against one port rank instead
        # (tests/test_torch_pipeline.py)
        assert _multiset(sets) == _multiset(want_sets)
    else:
        assert len(sets) == len(want_sets)
    limit = INT8_LOGITS_REL_L2 if _int8_w(kw) else LOGITS_REL_L2
    rel = _rel(r0["logits"], ref_logits)
    assert rel <= limit, rel
    assert int(r0["logits"].argmax()) == int(ref_logits.argmax())
    for r in ranks[1:]:  # every rank returns the same request, bit for bit
        np.testing.assert_array_equal(r["tokens"], r0["tokens"])
        np.testing.assert_array_equal(r["logits"], r0["logits"])
        assert r["layer_lengths"] == r0["layer_lengths"]
    assert len({tuple(r["layers"]) for r in ranks}) == 3 and tp * 3 == len(
        ranks)
