"""The port's public entry `LVU`: the device it runs on, and the int8
weight route."""

import pytest
import torch

from quickvideo_tpu_torch.config import LVUConfig
from quickvideo_tpu_torch.models.qwen25_vl.config import get_config
from quickvideo_tpu_torch.api import LVU
from quickvideo_tpu_torch.models.qwen25_vl.convert import init_params

torch.set_num_threads(2)


def test_lvu_without_cuda_raises_instead_of_running_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LVU(LVUConfig(model_name_or_path="tiny", dtype="float32"))
    with pytest.raises(RuntimeError, match="CUDA"):
        LVU(LVUConfig(model_name_or_path="tiny"), device="cuda")


def test_cpu_runs_only_when_asked():
    lvu = LVU(LVUConfig(model_name_or_path="tiny", dtype="float32"),
              device="cpu")
    assert lvu.device == torch.device("cpu")
    assert lvu.params["language"]["norm"].device.type == "cpu"


@pytest.mark.parametrize("given", [False, True])
def test_int8_params_are_quantized_and_prepped(given):
    """param_dtype="int8": random weights quantized as drawn, or float
    weights passed in quantized in place; the engine's B4 prep replaces the
    vision MLP leaves."""
    from quickvideo_tpu_torch.ops.quantization import is_quantized

    cfg = LVUConfig(model_name_or_path="tiny", dtype="float32",
                    param_dtype="int8", seed=3)
    params = init_params(get_config("tiny"), 3, torch.float32) if given else None
    lvu = LVU(cfg, params=params, device="cpu")
    lang, vis = lvu.params["language"], lvu.params["vision"]
    assert is_quantized(lang["embed"]) and is_quantized(lang["lm_head"])
    assert is_quantized(lang["layers"][0]["wq"])
    assert is_quantized(vis["blocks"][0]["wqkv"])
    assert "wgu_p" in vis["blocks"][0] and "wg" not in vis["blocks"][0]
    assert lvu.engine.params is lvu.params
    # the same seed gives the same int8 weights either way
    other = LVU(cfg, params=None if given else init_params(
        get_config("tiny"), 3, torch.float32), device="cpu")
    assert torch.equal(other.params["language"]["layers"][1]["wd"]["q8"],
                       lang["layers"][1]["wd"]["q8"])
