"""Parameter state of the port: conversion from the JAX tree, random init.

The port's state is a plain dict of tensors with the JAX package's names
(`model.py::init_params`, `load.py::params_from_state_dict`), except that
the stacked per-layer leaves become per-layer lists:

    {"language": {"embed", "norm", "lm_head",
                  "layers": [{"ln1", "ln2", "wq", "bq", "wk", "bk", "wv",
                              "bv", "wo", "wg", "wu", "wd"}, ...]},
     "vision": {"patch_embed", "merger": {"ln_q", "w1", "b1", "w2", "b2"},
                "blocks": [{"ln1", "ln2", "wqkv", "bqkv", "wo", "bo", "wg",
                            "bg", "wu", "bu", "wd", "bd"}, ...]}}

Matrices keep the JAX (in, out) layout and the port applies them as
`x @ w`, so no leaf is transposed. With int8 weights a matrix is a
{"q8", "sc"} dict (ops/quantization.py): q8 keeps the (in, out) shape as a
view of a row-major (out, in) tensor, the layout the int8 products read.
A safetensors checkpoint loads into the same tree (load.py).

Under a mesh (`mesh=`, parallel/mesh.py) each tp rank keeps its slices of
the language matrices (parallel/sharding.py), cut from the same full
tensors a single-device run holds, so a sharded run and a single-rank run
hold the same numbers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from quickvideo_tpu_torch.models.qwen25_vl.config import ModelConfig
from quickvideo_tpu_torch.ops.quantization import (
    col_major,
    is_quantized,
    quantize_weight,
)
from quickvideo_tpu_torch.parallel.sharding import (
    COL,
    shard_language_layer,
    shard_leaf,
    shard_params,
)


def _tp_rank(mesh):
    """(this rank's tp index, tp) of `mesh` (None: one device)."""
    return (0, 1) if mesh is None else (mesh.index("tp"), mesh.tp)


def _to(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: torch reads it via f32
        t = torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.tensor(a)
    return t.to(device=device, dtype=dtype)


def _leaf(a, device, dtype, i=None, row_scales=False):
    """One leaf (layer `i` of a stacked one); a quantized {"q8", "sc"} leaf
    keeps its int8 codes and f32 scales whatever `dtype` says."""
    if not is_quantized(a):
        return _to(a if i is None else a[i], device, dtype)
    q8, sc = (np.asarray(a[k]) if i is None else np.asarray(a[k])[i]
              for k in ("q8", "sc"))
    q8 = torch.from_numpy(np.ascontiguousarray(q8))
    return {
        "q8": (q8 if row_scales else col_major(q8)).to(device),
        "sc": torch.from_numpy(np.asarray(sc, np.float32)).to(device),
    }


def _unstack(stacked: dict, device, dtype) -> list:
    first = next(iter(stacked.values()))
    n = len(first["q8"] if is_quantized(first) else first)
    return [
        {name: _leaf(leaf, device, dtype, i) for name, leaf in stacked.items()}
        for i in range(n)
    ]


def params_from_jax(tree: dict, device="cpu", dtype=None, mesh=None) -> dict:
    """Map the JAX parameter tree (leaves as numpy arrays, e.g.
    `jax.tree.map(np.asarray, params)`) onto the port's state. `dtype`
    None keeps each leaf's dtype. Quantized leaves (the JAX package's
    quantize_model_params) stay quantized. With `mesh`, this rank's
    tensor-parallel shard of it."""
    if mesh is not None and mesh.tp > 1:
        return shard_params(params_from_jax(tree, device, dtype),
                            *_tp_rank(mesh))
    out = {}
    if "language" in tree:
        lang = tree["language"]
        out["language"] = {
            "embed": _leaf(lang["embed"], device, dtype, row_scales=True),
            "norm": _to(lang["norm"], device, dtype),
            "lm_head": _leaf(lang["lm_head"], device, dtype),
            "layers": _unstack(lang["layers"], device, dtype),
        }
    if "vision" in tree:
        vis = tree["vision"]
        out["vision"] = {
            "patch_embed": _leaf(vis["patch_embed"], device, dtype),
            "blocks": _unstack(vis["blocks"], device, dtype),
            "merger": {
                k: _leaf(v, device, dtype) for k, v in vis["merger"].items()
            },
        }
    return out


def init_params(
    cfg: ModelConfig,
    seed: int = 0,
    dtype=torch.bfloat16,
    device="cpu",
    param_dtype: Optional[str] = None,
    mesh=None,
) -> dict:
    """Seeded random weights at the config's full shapes, generated ON
    `device` (the 7B's ~16.6 GB of bf16 never passes through the host).
    Same scheme as the JAX package's init: N(0, 0.02) matrices, unit norm
    weights, zero biases. The numbers differ from jax.random's.

    param_dtype="int8": each matrix is quantized as soon as it is drawn
    (the embedding per row), so the float tree never exists whole. The
    generator runs the same sequence, so the int8 and float trees of one
    seed hold the same weights up to quantization.

    With `mesh`, this rank's tensor-parallel shard: each language matrix is
    drawn whole (and quantized whole) from the same sequence, then sliced,
    so a rank never holds more than one full layer beside its shard."""
    tpi, tpn = _tp_rank(mesh)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    int8 = param_dtype == "int8"

    def nrm(*shape, contract_axis=-2):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        w.normal_(0.0, 0.02, generator=gen)
        w = w.to(dtype)
        return quantize_weight(w, contract_axis) if int8 else w

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    t, v = cfg.text, cfg.vision
    c, hd = t.hidden_size, t.head_dim
    hq, hkv = t.num_attention_heads * hd, t.num_key_value_heads * hd
    language = {
        "embed": nrm(t.vocab_size, c, contract_axis=-1),
        "layers": [
            shard_language_layer({
                "ln1": ones(c), "ln2": ones(c),
                "wq": nrm(c, hq), "bq": zeros(hq),
                "wk": nrm(c, hkv), "bk": zeros(hkv),
                "wv": nrm(c, hkv), "bv": zeros(hkv),
                "wo": nrm(hq, c),
                "wg": nrm(c, t.intermediate_size),
                "wu": nrm(c, t.intermediate_size),
                "wd": nrm(t.intermediate_size, c),
            }, tpi, tpn)
            for _ in range(t.num_hidden_layers)
        ],
        "norm": ones(c),
        "lm_head": shard_leaf(nrm(c, t.vocab_size), COL, tpi, tpn),
    }
    vc, vi = v.hidden_size, v.intermediate_size
    merge_dim = vc * v.spatial_merge_unit
    vision = {
        "patch_embed": nrm(v.patch_input_dim, vc),
        "blocks": [
            {
                "ln1": ones(vc), "ln2": ones(vc),
                "wqkv": nrm(vc, 3 * vc), "bqkv": zeros(3 * vc),
                "wo": nrm(vc, vc), "bo": zeros(vc),
                "wg": nrm(vc, vi), "bg": zeros(vi),
                "wu": nrm(vc, vi), "bu": zeros(vi),
                "wd": nrm(vi, vc), "bd": zeros(vc),
            }
            for _ in range(v.depth)
        ],
        "merger": {
            "ln_q": ones(vc),
            "w1": nrm(merge_dim, merge_dim), "b1": zeros(merge_dim),
            "w2": nrm(merge_dim, v.out_hidden_size),
            "b2": zeros(v.out_hidden_size),
        },
    }
    return {"language": language, "vision": vision}


def params_to(params: dict, device=None, dtype: Optional[torch.dtype] = None):
    """Copy of a state dict with every tensor moved/cast. Quantized leaves
    are only moved (their layout is kept)."""
    if is_quantized(params):
        return {k: v.to(device=device) for k, v in params.items()}
    if isinstance(params, dict):
        return {k: params_to(v, device, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device, dtype) for v in params]
    return params.to(device=device, dtype=dtype)
