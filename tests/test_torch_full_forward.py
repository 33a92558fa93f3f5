"""The port's last model-level functions against the JAX package's, on the
tiny preset in f32 with the same weights and inputs:
`model.forward_full_sequence` (over `language.full_forward_logits`: the
ungrouped, uncached forward, whose attention is kernel B1's plain version
over an empty past) with a video, with an image, and with both, within
1e-4; `load.params_from_torch_model` on a tiny transformers Qwen2.5-VL
equal to `params_from_state_dict` of its state dict and, leaf for leaf, to
the JAX package's `params_from_torch_model`; `SpanTimer.report`'s text.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quickvideo_tpu.models.qwen25_vl import model as jmodel
from quickvideo_tpu.utils.timing import SpanTimer as JSpanTimer
from quickvideo_tpu_torch.models.qwen25_vl import model as tmodel
from quickvideo_tpu_torch.models.qwen25_vl.config import get_config
from quickvideo_tpu_torch.models.qwen25_vl.convert import params_from_jax
from quickvideo_tpu_torch.models.qwen25_vl.load import (
    params_from_state_dict,
    params_from_torch_model,
)
from quickvideo_tpu_torch.utils.timing import SpanTimer
from test_torch_engine import CFG as JCFG

torch.set_num_threads(2)

CFG = get_config("tiny")
LOGITS_ATOL = 1e-4
VIDEO_GRID = (2, 16, 16)
IMAGE_GRID = (1, 10, 10)


@pytest.fixture(scope="module")
def params():
    jp = jmodel.init_params(JCFG, seed=0, dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _span(token_id, grid):
    t, h, w = grid
    return np.concatenate([[CFG.vision_start_token_id],
                           np.full(t * (h // 2) * (w // 2), token_id),
                           [CFG.vision_end_token_id]])


def _pixels(rng, grid):
    return rng.standard_normal(
        (int(np.prod(grid)), CFG.vision.patch_input_dim)).astype(np.float32)


def _sequence(what):
    """(input_ids, forward_full_sequence keywords as numpy) of a request
    with a video, an image, or an image before a video."""
    rng = np.random.default_rng(3)
    parts, kw = [rng.integers(5, 900, 5)], {}
    if what in ("image", "both"):
        parts += [_span(CFG.image_token_id, IMAGE_GRID),
                  rng.integers(5, 900, 3)]
        kw.update(image_pixels=[_pixels(rng, IMAGE_GRID)],
                  image_grid_thw=np.array([IMAGE_GRID]))
    if what in ("video", "both"):
        parts += [_span(CFG.video_token_id, VIDEO_GRID)]
        kw.update(pixels=_pixels(rng, VIDEO_GRID),
                  video_grid_thw=np.array([VIDEO_GRID]),
                  second_per_grid_ts=[2.0])
    parts.append(rng.integers(5, 900, 4))
    return np.concatenate(parts).astype(np.int64), kw


@pytest.mark.parametrize("what", ["video", "image", "both"])
def test_forward_full_sequence_matches_jax(params, what):
    jp, tp = params
    ids, kw = _sequence(what)
    jkw = dict(kw)
    if "pixels" in kw:
        jkw["pixels"] = jnp.asarray(kw["pixels"])
    if "image_pixels" in kw:
        jkw["image_pixels"] = [jnp.asarray(p) for p in kw["image_pixels"]]
    want = np.asarray(jmodel.forward_full_sequence(jp, JCFG, ids, **jkw))
    got = tmodel.forward_full_sequence(tp, CFG, ids, **kw)
    assert got.dtype == torch.float32
    assert got.shape == (len(ids), CFG.text.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGITS_ATOL)
    assert (got.argmax(-1).numpy() == want.argmax(-1)).all()


def test_params_from_torch_model_matches_the_jax_loader():
    pytest.importorskip("transformers")
    from test_model_parity import make_hf_config
    from transformers import Qwen2_5_VLForConditionalGeneration

    from quickvideo_tpu.models.qwen25_vl.load import (
        params_from_torch_model as jparams_from_torch_model,
    )

    torch.manual_seed(0)
    hf = Qwen2_5_VLForConditionalGeneration(make_hf_config()).eval().float()
    got = params_from_torch_model(hf, CFG, torch.float32)
    state = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    ref = params_from_state_dict(state, CFG, torch.float32)
    jref = params_from_jax(jax.tree.map(np.asarray, jparams_from_torch_model(
        hf, JCFG, dtype=jnp.float32)))
    leaves = _named(got)
    assert leaves
    for other in (ref, jref):
        others = _named(other)
        assert sorted(others) == sorted(leaves)
        for path, a in leaves.items():
            b = others[path]
            assert a.shape == b.shape and a.dtype == b.dtype, path
            assert torch.equal(a, b), path


def _named(tree, path=""):
    """{path: tensor} of a parameter tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tree} if isinstance(tree, torch.Tensor) else {}
    out = {}
    for k, v in items:
        out.update(_named(v, f"{path}/{k}"))
    return out


def test_span_timer_report_is_the_jax_text():
    spans = [("vision", 1.234), ("prefill", 0.5), ("vision", 0.4),
             ("decode", 2.0), ("rope", 0.004)]
    port, jax_timer = SpanTimer(sync=False), JSpanTimer(sync=False)
    for name, seconds in spans:
        port.add(name, seconds)
        jax_timer.add(name, seconds)
    assert port.report() == jax_timer.report()
    assert port.report().splitlines()[0] == "decode: 2.00s (n=1)"
    assert SpanTimer().report() == JSpanTimer().report() == ""
