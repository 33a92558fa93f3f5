"""The PyTorch port's main path against the JAX package's, end to end, on
the tiny preset in f32 with identical weights and inputs: greedy tokens of
LVUEngine.generate (and of LVU.generate through the interleaved engine and
its upload pipeline) must be identical."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quickvideo_tpu.api import LVU as JLVU
from quickvideo_tpu.config import LVUConfig as JLVUConfig
from quickvideo_tpu.models.qwen25_vl import get_config
from quickvideo_tpu.models.qwen25_vl import model as jmodel
from quickvideo_tpu.prefill import LVUEngine as JEngine
from quickvideo_tpu.prefill import PrefillInputs as JInputs
from quickvideo_tpu.video import quickdecode as qd
from quickvideo_tpu_torch.api import LVU as TLVU
from quickvideo_tpu_torch.config import LVUConfig as TLVUConfig
from quickvideo_tpu_torch.models.qwen25_vl.config import (
    get_config as tget_config,
)
from quickvideo_tpu_torch.models.qwen25_vl.convert import params_from_jax
from quickvideo_tpu_torch.prefill import LVUEngine, PrefillInputs
from quickvideo_tpu_torch.video import quickdecode as tqd

torch.set_num_threads(2)

CFG = get_config("tiny")
TCFG = tget_config("tiny")
HW = 280  # 20 x 20 patches: ragged 4+4+2-unit windows


@pytest.fixture(scope="module")
def params():
    jp = jmodel.init_params(CFG, seed=0, dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def configs(**kw):
    """The JAX package's LVUConfig and the port's, from the same keywords."""
    return JLVUConfig(**kw), TLVUConfig(**kw)


def build_request(seed=1, n_pre=4, n_post=5, groups_t=(2, 2)):
    """Like tests/test_engine.py's build_request, with packed yuv420 frame
    groups (2 frames per temporal patch) instead of patchified floats."""
    rng = np.random.default_rng(seed)
    h = w = HW // 14
    t = sum(groups_t)
    n_vid = t * (h // 2) * (w // 2)
    ids = np.concatenate([
        rng.integers(5, 900, n_pre),
        [CFG.vision_start_token_id],
        np.full(n_vid, CFG.video_token_id),
        [CFG.vision_end_token_id],
        rng.integers(5, 900, n_post),
    ]).astype(np.int64)
    frames = rng.integers(0, 256, (2 * t, HW * HW * 3 // 2), dtype=np.uint8)
    groups, grids, off = [], [], 0
    for tg in groups_t:
        groups.append(frames[off : off + 2 * tg])
        grids.append((tg, h, w))
        off += 2 * tg
    return ids, (t, h, w), groups, grids


@pytest.mark.parametrize("top_p", [None, 0.5])
def test_greedy_tokens_identical_to_jax_engine(params, top_p):
    jp, tp = params
    ids, grid, groups, grids = build_request()
    jlvu, tlvu = configs(model_name_or_path="tiny", top_p=top_p,
                         max_decode_tokens=8)
    ref = JEngine(jp, CFG, jlvu, dtype=jnp.float32).generate(
        JInputs(ids, grid, groups, grids, 2.0), max_new_tokens=6
    )
    got = LVUEngine(tp, TCFG, tlvu, dtype=torch.float32).generate(
        PrefillInputs(ids, grid, groups, grids, 2.0), max_new_tokens=6
    )
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    assert got.cache_length == ref.cache_length
    assert got.layer_lengths == [got.cache_length] * CFG.text.num_hidden_layers
    assert got.kv_cache_bytes == ref.kv_cache_bytes
    for span in ("vision", "prefill", "final_prefill", "decode", "e2e"):
        assert got.timings[span] > 0


def test_eos_stops_decode(params):
    _, tp = params
    ids, grid, groups, grids = build_request()
    eng = LVUEngine(tp, TCFG, TLVUConfig(model_name_or_path="tiny", top_p=0.5,
                                         max_decode_tokens=8), torch.float32)
    first = eng.generate(PrefillInputs(ids, grid, groups, grids, 2.0),
                         max_new_tokens=6).tokens
    res = eng.generate(PrefillInputs(ids, grid, groups, grids, 2.0),
                       max_new_tokens=6, eos_token_ids=[int(first[1])])
    np.testing.assert_array_equal(res.tokens, first[:2])


class FakeInterleavedReader:
    """The native InterleavedVideoReader's surface over seeded frames, so
    the interleaved engines of both packages run without FFmpeg."""

    instances = []

    def __init__(self, path, num_threads=8, num_intervals=64):
        self.source_height = self.source_width = HW
        self.height = self.width = None
        self.interpolation = None
        self.output_format = "RGB"
        self.frame_iter = 1
        self._pos = 0
        self.closed = False
        FakeInterleavedReader.instances.append(self)

    def __len__(self):
        return 16

    def get_fps(self):
        return 4.0

    def process(self, indices):
        # frames come out at the size the plan asked for, packed yuv420
        assert self.output_format == "YUV420" and self.height and self.width
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
        self.closed = True


def _fake_decode_video_batch(plan_from_reader, path, lvu):
    """decode_video_batch over the fake reader, planned by one package's
    plan_from_reader: (frames, plan, native_hw)."""
    reader = FakeInterleavedReader(path)
    plan = plan_from_reader(reader, lvu)
    reader.height, reader.width = plan.resized_height, plan.resized_width
    reader.output_format = "YUV420"
    reader.process(plan.indices.tolist())
    reader.close()
    return reader._frames, plan, None


@pytest.mark.parametrize(
    "model_type", ["qwen25_lvu_interleaved", "qwen25_lvu", "qwen25_vl"]
)
def test_lvu_generate_matches_jax_for_each_engine(params, monkeypatch,
                                                   model_type):
    """LVU.generate(question, video_path) of both packages, with the native
    decoder replaced by the same fake (streamed for the interleaved
    engine, batch-decoded for the sync ones): same tokens."""
    import functools

    from quickvideo_tpu.video import reader as jreader
    from quickvideo_tpu_torch.video import reader as treader

    jp, tp = params
    for mod in (qd, tqd):
        monkeypatch.setattr(mod, "InterleavedVideoReader",
                            FakeInterleavedReader)
    for mod in (jreader, treader):
        monkeypatch.setattr(mod, "decode_video_batch", functools.partial(
            _fake_decode_video_batch, mod.plan_from_reader
        ))
    monkeypatch.setenv("QV_COMPILE_CACHE", "0")
    FakeInterleavedReader.instances.clear()
    jcfg, tcfg = configs(
        model_name_or_path="tiny", model_type=model_type,
        num_frames=8, video_group_size=4, top_p=0.5, max_decode_tokens=8,
        decode_output="yuv420", dtype="float32",
    )
    jlvu = JLVU(jcfg, params=jp)
    ref_text = jlvu.generate("what moves?", "clip.mp4", max_new_tokens=5)
    lvu = TLVU(tcfg, params=tp, device="cpu")
    text = lvu.generate("what moves?", "clip.mp4", max_new_tokens=5)
    assert text == ref_text
    res = lvu.last_result
    np.testing.assert_array_equal(res.tokens, jlvu.last_result.tokens)
    assert res.cache_length == jlvu.last_result.cache_length
    assert len(res.tokens) == 5 and res.timings["frame_fetch"] > 0
    assert FakeInterleavedReader.instances
    assert all(r.closed for r in FakeInterleavedReader.instances)


def test_sampled_and_streamed_requests_run(params):
    """Sampling and streaming, once refused, run through generate:
    top_k=1 sampling gives the greedy tokens, and the streamed chunks
    concatenate to them (tests/test_torch_decode_variants.py has the
    rest)."""
    _, tp = params
    ids, grid, groups, grids = build_request()
    eng = LVUEngine(tp, TCFG, TLVUConfig(model_name_or_path="tiny",
                                         max_decode_tokens=8),
                    torch.float32)

    def inputs():
        return PrefillInputs(ids, grid, groups, grids, 2.0)

    greedy = eng.generate(inputs(), max_new_tokens=6)
    sampled = eng.generate(inputs(), max_new_tokens=6, greedy=False, top_k=1)
    np.testing.assert_array_equal(sampled.tokens, greedy.tokens)
    chunks = []
    streamed = eng.generate(inputs(), max_new_tokens=6, on_tokens=chunks.append)
    np.testing.assert_array_equal(streamed.tokens, greedy.tokens)
    assert sum(chunks, []) == greedy.tokens.tolist() and len(chunks[0]) == 1


@pytest.mark.parametrize(
    "kw",
    [
        {"mesh": {"pp": 2}},  # pipeline parallelism: not ported
    ],
)
def test_out_of_slice_configs_raise(params, kw):
    _, tp = params
    cfg = TLVUConfig(model_name_or_path="tiny", **kw)
    with pytest.raises(NotImplementedError, match="not ported"):
        LVUEngine(tp, TCFG, cfg, torch.float32)
    with pytest.raises(NotImplementedError, match="not ported"):
        TLVU(cfg, params=tp, device="cpu")


def _jax_final_prefill_logits(eng, inputs):
    """The JAX engine's final-prefill logits (its padded-bucket program, as
    _generate_from_cache runs it)."""
    from quickvideo_tpu.models.qwen25_vl.language import StepSpec

    cache, st = eng.prefill(inputs)
    ss, L = st["suffix_start"], st["L"]
    n = L - ss
    bucket = max(32, -(-n // 32) * 32)
    ids_pad = np.zeros(bucket, np.int64)
    ids_pad[:n] = st["ids"][ss:]
    spec = StepSpec(cfg=CFG.text, q_len=bucket, keep_k=0,
                    attn_impl=eng.lvu.attention_impl,
                    kv_quant=eng._cache_quant(cache), cp_mesh=eng.cp_mesh)
    _, logits = eng._final_prefill_jit(
        eng.params["language"], cache, jnp.asarray(ids_pad, jnp.int32),
        st["cos"][ss : ss + bucket], st["sin"][ss : ss + bucket],
        np.int32(0), np.int32(n), spec=spec, img=st.get("img_suffix"),
    )
    return np.asarray(logits)


@pytest.fixture(scope="module")
def params_int8(params):
    from quickvideo_tpu.ops import quantization as jq

    jp = jax.tree.map(np.asarray, params[0])
    # the JAX quantizer donates its input: give it a copy
    jqp = jax.tree.map(np.asarray, jq.quantize_model_params(
        jax.tree.map(jnp.array, jp)
    ))
    return jqp, params_from_jax(jqp)


# final-prefill logits, int8 weights, f32 activations: the vision towers
# differ by ~1e-2 rel. L2 (tests/test_torch_vision.py), which the language
# stack carries to the logits. Measured 1.6e-3 / 4.2e-3 (top_p=1, default /
# lowered gates) and 5.9e-3 / 1.2e-2 (top_p=0.5, where a flipped retained
# key moves more)
INT8_LOGITS_REL_L2 = 3e-2


@pytest.mark.parametrize("gates", ["default", "lowered"])
@pytest.mark.parametrize("top_p", [None, 0.5])
def test_int8_greedy_tokens_identical_to_jax_engine(params_int8, monkeypatch,
                                                     top_p, gates):
    """param_dtype="int8": the JAX engine on its kernel route
    (QV_PALLAS_INTERPRET=1: B3/B4 and the padded-head vision attention in
    interpret mode) against the port's plain versions. `lowered` sets both
    packages' act-quant width gate to 16 so that every product acts."""
    from quickvideo_tpu.ops import quantization as jq
    from quickvideo_tpu_torch.ops import quantization as tq

    if gates == "lowered":
        monkeypatch.setattr(jq, "_ACT_MIN_DIM", 16)
        monkeypatch.setattr(tq, "ACT_MIN_DIM", 16)
    jqp, tqp = params_int8
    ids, grid, groups, grids = build_request()
    jlvu, tlvu = configs(model_name_or_path="tiny", top_p=top_p,
                         max_decode_tokens=8, param_dtype="int8")
    monkeypatch.setenv("QV_PALLAS_INTERPRET", "1")
    jeng = JEngine(jax.tree.map(jnp.asarray, jqp), CFG, jlvu,
                   dtype=jnp.float32)
    ref = jeng.generate(JInputs(ids, grid, groups, grids, 2.0),
                        max_new_tokens=6)
    ref_logits = _jax_final_prefill_logits(
        jeng, JInputs(ids, grid, groups, grids, 2.0)
    )
    monkeypatch.delenv("QV_PALLAS_INTERPRET")
    eng = LVUEngine(tqp, TCFG, tlvu, dtype=torch.float32)
    got = eng.generate(PrefillInputs(ids, grid, groups, grids, 2.0),
                       max_new_tokens=6)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    assert got.cache_length == ref.cache_length
    cache, st = eng.prefill(PrefillInputs(ids, grid, groups, grids, 2.0))
    logits = eng.final_prefill(cache, st).numpy()
    rel = np.linalg.norm(logits - ref_logits) / np.linalg.norm(ref_logits)
    assert rel <= INT8_LOGITS_REL_L2, rel
    assert int(logits.argmax()) == int(ref_logits.argmax())


# final-prefill logits with an int8 KV cache, f32 activations: the two
# packages' activations differ in f32 summation order (vision tower
# included), which moves row scales by ulps and can flip a K, V or q code
# sitting on a rounding boundary. Measured rel. L2 2.1e-5 (int8) and 3.1e-7
# (int8k)
INT8_KV_LOGITS_REL_L2 = 1e-4


@pytest.mark.parametrize("top_p", [None, 0.5])
@pytest.mark.parametrize("kv_dtype", ["int8", "int8k"])
def test_int8_kv_greedy_tokens_identical_to_jax_engine(params, monkeypatch,
                                                        kv_dtype, top_p):
    """kv_cache_dtype int8 / int8k: the JAX engine on its kernel route
    (attention_impl="pallas", QV_PALLAS_INTERPRET=1: B1's int8-QK variant in
    interpret mode; its XLA route for int8 caches has other numerics)
    against the port's plain versions: tokens, cache length and bytes."""
    jp, tp = params
    ids, grid, groups, grids = build_request()
    jlvu, tlvu = configs(model_name_or_path="tiny", top_p=top_p,
                         max_decode_tokens=8, kv_cache_dtype=kv_dtype,
                         attention_impl="pallas")
    monkeypatch.setenv("QV_PALLAS_INTERPRET", "1")
    jeng = JEngine(jp, CFG, jlvu, dtype=jnp.float32)
    ref = jeng.generate(JInputs(ids, grid, groups, grids, 2.0),
                        max_new_tokens=6)
    ref_logits = _jax_final_prefill_logits(
        jeng, JInputs(ids, grid, groups, grids, 2.0)
    )
    monkeypatch.delenv("QV_PALLAS_INTERPRET")
    eng = LVUEngine(tp, TCFG, tlvu, dtype=torch.float32)
    got = eng.generate(PrefillInputs(ids, grid, groups, grids, 2.0),
                       max_new_tokens=6)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    assert got.cache_length == ref.cache_length
    assert got.layer_lengths == [got.cache_length] * CFG.text.num_hidden_layers
    assert got.kv_cache_bytes == ref.kv_cache_bytes
    assert got.kv_unpruned_bytes == ref.kv_unpruned_bytes
    cache, st = eng.prefill(PrefillInputs(ids, grid, groups, grids, 2.0))
    assert st["kv_dtype"] == kv_dtype
    assert cache.k.dtype == torch.int8 and cache.k_scale is not None
    assert (cache.v.dtype == torch.int8) == (kv_dtype == "int8")
    logits = eng.final_prefill(cache, st).numpy()
    rel = np.linalg.norm(logits - ref_logits) / np.linalg.norm(ref_logits)
    assert rel <= INT8_KV_LOGITS_REL_L2, rel


@pytest.mark.parametrize(
    "capacity,hbm_gb,param_dtype",
    [(4096, None, "bfloat16"), (65536, None, "bfloat16"),
     (69632, None, "bfloat16"), (131072, None, "int8"),
     (4096, "0.00001", "bfloat16"), (4096, "0.00001", "int8"),
     (131072, "80", "bfloat16"), (65536, "80", "int8")],
)
def test_auto_kv_dtype_resolves_as_the_jax_engine(params_int8, params,
                                                   monkeypatch, capacity,
                                                   hbm_gb, param_dtype):
    """kv_cache_dtype="auto": the port's resolve_kv_dtype gives the JAX
    engine's answer for the same capacity and QV_HBM_GB (the JAX engine's
    16 GiB default on the CPU when unset): int8 above 65,536 planned slots,
    or when a bf16 cache would not fit beside the weights."""
    if hbm_gb is None:
        monkeypatch.delenv("QV_HBM_GB", raising=False)
    else:
        monkeypatch.setenv("QV_HBM_GB", hbm_gb)
    (jp, tp) = params_int8 if param_dtype == "int8" else params
    jlvu, tlvu = configs(model_name_or_path="tiny", param_dtype=param_dtype)
    jeng = JEngine(jax.tree.map(jnp.asarray, jp), CFG, jlvu,
                   dtype=jnp.float32)
    eng = LVUEngine(tp, TCFG, tlvu, dtype=torch.float32)
    want = jeng.resolve_kv_dtype(capacity)
    assert eng.resolve_kv_dtype(capacity) == want
    assert want == ("int8" if capacity > 65536 or hbm_gb == "0.00001"
                    else "bfloat16")
    assert eng.device_memory_bytes() == (
        16 << 30 if hbm_gb is None else int(float(hbm_gb) * (1 << 30))
    )


def test_auto_kv_dtype_allocates_the_resolved_cache(params, monkeypatch):
    """A request under "auto" gets the cache the rule picks: bf16 (the
    compute dtype) at tiny capacity, int8 K and V with scales when the
    memory is too small for a bf16 cache."""
    _, tp = params
    ids, grid, groups, grids = build_request()
    eng = LVUEngine(tp, TCFG, TLVUConfig(model_name_or_path="tiny"),
                    torch.float32)
    monkeypatch.delenv("QV_HBM_GB", raising=False)
    cache, st = eng.prefill(PrefillInputs(ids, grid, groups, grids, 2.0))
    assert st["kv_dtype"] == "bfloat16" and cache.quantized is False
    assert cache.k.dtype == torch.float32
    monkeypatch.setenv("QV_HBM_GB", "0.00001")
    cache, st = eng.prefill(PrefillInputs(ids, grid, groups, grids, 2.0))
    assert st["kv_dtype"] == "int8" and cache.quantized is True
    assert cache.k.dtype == cache.v.dtype == torch.int8
    assert cache.k_scale.shape == cache.k.shape[:3] == cache.v_scale.shape


def test_the_jax_packages_config_is_refused(params):
    """The port takes its own LVUConfig: the JAX package's is a TypeError,
    not a silent duck-typed run."""
    _, tp = params
    with pytest.raises(TypeError, match="quickvideo_tpu_torch.config"):
        LVUEngine(tp, TCFG, JLVUConfig(model_name_or_path="tiny"),
                  torch.float32)
