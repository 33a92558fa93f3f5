"""The language model's int8 glue (ops/int8_glue.py) on the CPU: each plain
version against the op sequence it stands for, bit for bit; the route rule
of the int8 chain; a decoder layer on the chain against the plain route;
and the checks the CUDA entries make before a launch (the kernels
themselves run in tests/test_torch_cuda.py)."""

import pytest
import torch
import torch.nn.functional as F

from quickvideo_tpu_torch.models.qwen25_vl import language as tlang
from quickvideo_tpu_torch.models.qwen25_vl.config import get_config
from quickvideo_tpu_torch.models.qwen25_vl.convert import init_params
from quickvideo_tpu_torch.ops import int8_glue as glue
from quickvideo_tpu_torch.ops import kv_cache as tkv
from quickvideo_tpu_torch.ops import quantization as tq
from quickvideo_tpu_torch.ops.quantization import (
    int_mm,
    linear,
    linear_multi,
    qdot_pre,
    quantize_act,
    quantize_weight,
)

torch.set_num_threads(2)

K = 256  # the contraction of the products below: at ACT_MIN_DIM


def _rows(rows, c, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(rows, c, generator=gen) * 2.0).to(dtype)


def _weight(k, n, seed):
    gen = torch.Generator().manual_seed(seed)
    return quantize_weight(torch.randn(k, n, generator=gen) * 0.02)


def _equal(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


# rows 1, 16 (the decode-sized and the gate's), 17 (int_mm's padding edge)
# and 3,600 (a group step); the 7B's widths (C 3,584; q/o 3,584, k/v 512;
# I 18,944) and the 72B's (C 8,192; I 29,568), cut in rows
ROW_CASES = [(1, 3584), (16, 3584), (17, 8192), (3600, 3584)]
RESCALE_CASES = [(1, 3584), (16, 512), (17, 8192), (3600, 3584)]
SWIGLU_CASES = [(1, 18944), (16, 18944), (17, 29568), (3600, 512)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,c", ROW_CASES)
def test_row_quantize_plain_is_the_norm_then_quantize_act(rows, c, dtype):
    x = _rows(rows, c, dtype, rows + c)
    ln = (1.0 + 0.1 * _rows(1, c, torch.float32, 7)[0]).to(dtype)
    eps = 1e-6
    # the decoder's rms_norm as it was written before the chain
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    h = (xf * torch.rsqrt(var + eps)).to(x.dtype) * ln
    _equal(glue.rms_quantize_plain(x, ln, eps), quantize_act(h))
    _equal(glue.rms_quantize(x, ln, eps), quantize_act(h))
    _equal(tlang.rms_norm(x, ln, eps), h)
    _equal(glue.quantize_rows(x), quantize_act(x))


@pytest.mark.parametrize("rows,n", RESCALE_CASES)
def test_rescale_plain_is_the_cast_product_and_its_adds(rows, n):
    x = _rows(rows, K, torch.bfloat16, rows)
    w = _weight(K, n, n)
    b = _rows(1, n, torch.bfloat16, 3)[0] * 0.05
    xq, xs = quantize_act(x)
    acc = int_mm(xq, w["q8"])
    # q/k/v: linear_multi's cast of qdot_pre, then the bias add
    want = qdot_pre(xq, xs, w).to(torch.bfloat16) + b
    _equal(glue.rescale(acc, xs, w["sc"], bias=b), want)
    # wo / wd: x + linear(a, w) (a residual of the output width)
    res = _rows(rows, n, torch.bfloat16, rows + 1)
    _equal(glue.rescale_plain(acc, xs, w["sc"], residual=res),
           res + linear(x, w, min_rows=0))
    # f32 activations (the CPU tests' models)
    xf = x.float()
    xq, xs = quantize_act(xf)
    _equal(glue.rescale(int_mm(xq, w["q8"]), xs, w["sc"],
                        residual=res.float(), dtype=torch.float32),
           res.float() + linear(xf, w, min_rows=0))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,inter", SWIGLU_CASES)
def test_swiglu_quantize_plain_is_silu_times_up_then_quantize_act(
        rows, inter, dtype):
    h = _rows(rows, K, dtype, inter)
    wg, wu = _weight(K, inter, 1), _weight(K, inter, 2)
    g, u = linear_multi(h, (wg, wu), min_rows=0)
    want = quantize_act(F.silu(g) * u)
    xq, xs = quantize_act(h)
    got = glue.swiglu_quantize(int_mm(xq, wg["q8"]), int_mm(xq, wu["q8"]),
                               xs, wg["sc"], wu["sc"], dtype=dtype)
    _equal(got, want)


def _meta(rows, cols, dtype):
    return torch.empty(rows, cols, dtype=dtype, device="meta")


def test_the_chain_route_rule():
    """The chain: quantized weights, no tp group, the act-quant gate on the
    rows and width, and on a card bf16 rows (a meta tensor stands for one
    here); everything else keeps the plain route."""
    wq = _weight(K, 64, 0)
    wf = torch.zeros(K, 64)
    x = _rows(40, K, torch.float32, 0)
    tp = object()  # any tp group
    assert glue.chain_applies(x, (wq, wq), None)
    assert not glue.chain_applies(x, (wq, wq), None, tp)
    assert not glue.chain_applies(x, (wq, wf), None)  # bf16 weights
    assert not glue.chain_applies(x[:15], (wq,), None)  # the row gate
    assert glue.chain_applies(x[:1], (wq,), 0)  # the final prefill's
    assert not glue.chain_applies(x[:1], (wq,), 0, tp)
    assert not glue.chain_applies(x[:, :255], (wq,), None)  # the width gate
    assert glue.chain_applies(x[:, :255], (wq,), 0) is False
    assert glue.chain_applies(_meta(40, K, torch.bfloat16), (wq,), None)
    assert not glue.chain_applies(_meta(40, K, torch.float32), (wq,), None)
    assert not glue.chain_applies(x[None], (wq,), None)  # not (rows, C)


class _Calls:
    """The chain's entries on `glue`, wrapped to count their calls."""

    NAMES = ("rms_quantize", "quantize_rows", "rescale", "swiglu_quantize")

    def __init__(self, monkeypatch):
        self.n = dict.fromkeys(self.NAMES, 0)
        for name in self.NAMES:
            orig = getattr(glue, name)

            def counted(*args, _name=name, _orig=orig, **kw):
                self.n[_name] += 1
                return _orig(*args, **kw)

            monkeypatch.setattr(glue, name, counted)

    def take(self):
        out, self.n = self.n, dict.fromkeys(self.NAMES, 0)
        return out


@pytest.fixture(scope="module")
def tiny_int8():
    cfg = get_config("tiny")
    params = init_params(cfg, seed=0, dtype=torch.float32)["language"]
    gen = torch.Generator().manual_seed(1)
    for lp in params["layers"]:  # the init's zero biases would hide an add
        for b in ("bq", "bk", "bv"):
            lp[b] = torch.randn(lp[b].shape, generator=gen) * 0.05
    return cfg.text, tq.quantize_language_params(params)


def _prefill(text, params, x, min_rows, spec=None, cap=256):
    cache = tkv.init_cache(text.num_hidden_layers, text.num_key_value_heads,
                           cap, text.head_dim, dtype=torch.float32)
    rows = x.shape[0]
    cos = torch.ones(rows, text.head_dim)
    sin = torch.zeros(rows, text.head_dim)
    h, _ = tlang.prefill_step(params, cache, x, cos, sin, text,
                              spec or tlang.StepSpec(q_len=rows),
                              min_rows=min_rows)
    return h, cache


@pytest.mark.parametrize("rows,min_rows,keep", [(40, None, 0), (40, None, 20),
                                                (5, 0, 0)])
def test_layers_on_the_chain_equal_the_plain_route(tiny_int8, monkeypatch,
                                                   rows, min_rows, keep):
    """The tiny int8 stack with the width gate lowered (every product
    act-quantizes): a group step (with and without pruning) and a final
    prefill of 5 rows run the chain, its entries called per layer as the
    chain's route says, and give the plain route's hidden states and cache
    bit for bit on the CPU; one decode-sized row calls none of them."""
    text, params = tiny_int8
    monkeypatch.setattr(tq, "ACT_MIN_DIM", 16)
    calls = _Calls(monkeypatch)
    x = _rows(rows, text.hidden_size, torch.float32, rows)
    spec = tlang.StepSpec(q_len=rows, keep_k=keep)
    h, cache = _prefill(text, params, x, min_rows, spec)
    layers = text.num_hidden_layers
    assert calls.take() == {"rms_quantize": 2 * layers,
                            "quantize_rows": layers,
                            "rescale": 5 * layers,
                            "swiglu_quantize": layers}
    monkeypatch.setattr(glue, "chain_applies", lambda *a, **k: False)
    h_plain, cache_plain = _prefill(text, params, x, min_rows, spec)
    assert sum(calls.take().values()) == 0
    _equal(h, h_plain)
    _equal(cache.k, cache_plain.k)
    _equal(cache.v, cache_plain.v)
    assert cache.lengths == cache_plain.lengths


def test_decode_rows_and_tp_keep_the_plain_route(tiny_int8, monkeypatch):
    """One row below the row gate (a decode step) and a layer's q/k/v under
    a tp group call none of the chain's entries."""
    text, params = tiny_int8
    monkeypatch.setattr(tq, "ACT_MIN_DIM", 16)
    calls = _Calls(monkeypatch)
    _prefill(text, params, _rows(1, text.hidden_size, torch.float32, 0),
             None)
    assert sum(calls.take().values()) == 0
    lp = params["layers"][0]
    x = _rows(40, text.hidden_size, torch.float32, 1)
    q, k, v = tlang._project_qkv(lp, x, text, None, tp=object())
    assert sum(calls.take().values()) == 0
    q0, k0, v0 = tlang._project_qkv(lp, x, text, None)
    assert calls.take()["rms_quantize"] == 1
    for a, b in ((q, q0), (k, k0), (v, v0)):
        _equal(a, b)


def test_what_the_card_entries_refuse():
    """The checks every CUDA entry makes before a launch (pure Python, so
    checked here on CPU tensors; the launches' own refusals on the card are
    in tests/test_torch_cuda.py)."""
    dev = torch.device("cpu")
    bf = torch.zeros(4, 64, dtype=torch.bfloat16)
    assert glue._matrix("x", bf, torch.bfloat16, dev, 8) == 64
    assert glue._matrix("x", bf[1:3], torch.bfloat16, dev, 8) == 64
    with pytest.raises(TypeError):  # f32 rows
        glue._matrix("x", bf.float(), torch.bfloat16, dev, 8)
    with pytest.raises(ValueError):  # column-major
        glue._matrix("x", torch.zeros(64, 8, dtype=torch.bfloat16).t(),
                     torch.bfloat16, dev, 8)
    with pytest.raises(ValueError):  # C not a multiple of 8
        glue._matrix("x", bf[:, :60], torch.bfloat16, dev, 8)
    with pytest.raises(ValueError):  # rows not 16-byte aligned
        glue._matrix("x", bf[:, 2:58], torch.bfloat16, dev, 4)
    with pytest.raises(ValueError):  # not 2-D
        glue._matrix("x", bf[None], torch.bfloat16, dev, 8)
    with pytest.raises(ValueError):  # another device
        glue._matrix("x", bf, torch.bfloat16, torch.device("meta"), 8)
    acc = torch.zeros(17, 64, dtype=torch.int32)
    assert glue._matrix("acc", acc[:5], torch.int32, dev, 4) == 64
    sc = torch.ones(64)
    assert glue._vector("sc", sc, torch.float32, 64, dev) is sc
    with pytest.raises(ValueError):  # the wrong length
        glue._vector("sc", sc[:60], torch.float32, 64, dev)
    with pytest.raises(ValueError):  # strided
        glue._vector("sc", torch.ones(128)[::2], torch.float32, 64, dev)
    with pytest.raises(ValueError):  # f32 bias where bf16 is read
        glue._vector("bias", sc, torch.bfloat16, 64, dev)
    unaligned = glue._vector("sc", torch.ones(65)[1:], torch.float32, 64, dev)
    assert unaligned.data_ptr() % 16 == 0
    for c in (0, glue.MAX_ROW_WIDTH + 8):
        with pytest.raises(ValueError):
            glue._check_row_width(c)
    glue._check_row_width(glue.MAX_ROW_WIDTH)
    meta = _meta(4, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        glue.quantize_rows(meta)


def test_entries_keep_their_launch_counts_on_the_cpu():
    """The plain versions launch nothing: the counts move only on a card."""
    before = {f: getattr(glue, f).launches for f in _Calls.NAMES}
    x = _rows(20, 64, torch.bfloat16, 0)
    xq, xs = glue.rms_quantize(x, torch.ones(64, dtype=torch.bfloat16), 1e-6)
    glue.quantize_rows(x)
    acc = int_mm(xq, _weight(64, 32, 0)["q8"])
    glue.rescale(acc, xs, torch.ones(32))
    glue.swiglu_quantize(acc, acc, xs, torch.ones(32), torch.ones(32))
    assert {f: getattr(glue, f).launches for f in _Calls.NAMES} == before
