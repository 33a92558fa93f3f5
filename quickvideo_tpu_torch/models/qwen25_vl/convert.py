"""Parameter state of the port: conversion from the JAX tree, seeded random
init, and the deterministic weights of a preset name (`init_params_fast`).

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
hold the same numbers; under pipeline parallelism a rank holds only its
stage's layers and parts (`sharding.stage_params`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from quickvideo_tpu_torch.models.qwen25_vl.config import ModelConfig
from quickvideo_tpu_torch.ops.quantization import (
    LANG_LAYER_KEYS,
    VIS_BLOCK_KEYS,
    col_major,
    is_quantized,
    quantize_weight,
)
from quickvideo_tpu_torch.parallel.sharding import (
    COL,
    LAYER_RULES,
    mesh_params,
    shard_language_layer,
    shard_leaf,
    stage_holds,
    stage_layers,
    stage_of,
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
    quantize_model_params) stay quantized. With `mesh`, this rank's part
    of it: its pipeline stage's layers and parts, and its tensor-parallel
    slices (parallel/sharding.py::mesh_params)."""
    if mesh is not None:
        return mesh_params(params_from_jax(tree, device, dtype), mesh)
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


def leaf_shapes(cfg: ModelConfig):
    """The JAX tree's leaf shapes, in its init order: (one decoder
    layer's, one vision block's, the merger's), each {key: shape}
    (matrices (in, out)); norms are "ln*", biases "b*"."""
    t, v = cfg.text, cfg.vision
    c, hd, f = t.hidden_size, t.head_dim, t.intermediate_size
    hq, hkv = t.num_attention_heads * hd, t.num_key_value_heads * hd
    vc, vi = v.hidden_size, v.intermediate_size
    md = vc * v.spatial_merge_unit
    layer = {
        "ln1": (c,), "ln2": (c,), "wq": (c, hq), "bq": (hq,),
        "wk": (c, hkv), "bk": (hkv,), "wv": (c, hkv), "bv": (hkv,),
        "wo": (hq, c), "wg": (c, f), "wu": (c, f), "wd": (f, c),
    }
    block = {
        "ln1": (vc,), "ln2": (vc,), "wqkv": (vc, 3 * vc), "bqkv": (3 * vc,),
        "wo": (vc, vc), "bo": (vc,), "wg": (vc, vi), "bg": (vi,),
        "wu": (vc, vi), "bu": (vi,), "wd": (vi, vc), "bd": (vc,),
    }
    merger = {"ln_q": (vc,), "w1": (md, md), "b1": (md,),
              "w2": (md, v.out_hidden_size), "b2": (v.out_hidden_size,)}
    return layer, block, merger


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
    so a rank never holds more than one full layer beside its shard. Under
    pipeline parallelism every leaf is drawn in the same order, and the
    rank keeps its stage's (parallel/sharding.py::stage_params): its
    layers, the vision tower and embedding on the first stage, the norm
    and lm_head on the last; the rest is dropped as it is drawn."""
    tpi, tpn = _tp_rank(mesh)
    stage, stages = stage_of(mesh)
    mine = stage_layers(cfg.text.num_hidden_layers, stage, stages)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    int8 = param_dtype == "int8"

    def nrm(*shape, contract_axis=-2):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        w.normal_(0.0, 0.02, generator=gen)
        w = w.to(dtype)
        return quantize_weight(w, contract_axis) if int8 else w

    def init(key, shape):  # norms one, biases zero, matrices drawn
        if key.startswith("ln"):
            return torch.ones(shape, dtype=dtype, device=device)
        if key.startswith("b"):
            return torch.zeros(shape, dtype=dtype, device=device)
        return nrm(*shape)

    t, v = cfg.text, cfg.vision
    c = t.hidden_size
    layer_shapes, block_shapes, merger_shapes = leaf_shapes(cfg)

    def holds(part, key=None):
        return stage_holds(part, key, stage, stages)

    # every leaf is drawn, so the sequence is one device's; a stage keeps
    # its own and drops the rest as it is drawn
    language = {}
    embed = nrm(t.vocab_size, c, contract_axis=-1)
    if holds("language", "embed"):
        language["embed"] = embed
    del embed
    language["layers"] = []
    for li in range(t.num_hidden_layers):
        layer = {k: init(k, s) for k, s in layer_shapes.items()}
        if li in mine:
            language["layers"].append(shard_language_layer(layer, tpi, tpn))
    head = nrm(c, t.vocab_size)
    if holds("language", "lm_head"):  # with the final norm
        language["norm"] = torch.ones(c, dtype=dtype, device=device)
        language["lm_head"] = shard_leaf(head, COL, tpi, tpn)
    del head
    vision = {"patch_embed": nrm(v.patch_input_dim, v.hidden_size),
              "blocks": []}
    for _ in range(v.depth):
        block = {k: init(k, s) for k, s in block_shapes.items()}
        if holds("vision"):
            vision["blocks"].append(block)
    vision["merger"] = {k: init(k, s) for k, s in merger_shapes.items()}
    if not holds("vision"):
        return {"language": language}
    return {"language": language, "vision": vision}


# -- the deterministic weights of a preset name without a checkpoint ---------
#
# Counterparts of quickvideo_tpu/models/qwen25_vl/model.py::init_params_fast
# and quickvideo_tpu/ops/quantization.py::init_params_fast_quantized. Each
# JAX leaf is a function of its flat index in the JAX layout (matrices
# (in, out), the per-layer leaves stacked on a leading layer axis), taken
# from XLA's int32 iota: past 2^31 the index wraps (two's complement), as
# in the 72B's stacked wq, wo, wg, wu and wd. A float leaf holds
# ((i % 17) - 8) * 0.01 in f32, cast to the dtype; with int8 weights a
# matrix holds the codes (i % 255) - 127 with every scale 8e-5 (the
# embedding per row), other leaves stay float. `%` is a floor modulo, as
# jnp's. The values are computed on the device from the indices of the
# part a rank holds, so no leaf exists whole anywhere first.

FAST_SCALE = 8e-5
FAST_MATMUL_KEYS = frozenset(LANG_LAYER_KEYS + VIS_BLOCK_KEYS
                             + ("w1", "w2", "patch_embed", "lm_head"))


def fast_index(shape, offset: int, rows: range, cols: range, device="cpu",
               transposed: bool = False) -> torch.Tensor:
    """XLA's int32 iota at the block (rows, cols) of a leaf of 2-D `shape`
    whose flat JAX index starts at `offset` (a layer's of a stacked leaf:
    layer * its numel): the flat index in int64, cast to int32 (the same
    two's-complement wrap); (len(rows), len(cols)), or transposed
    (len(cols), len(rows))."""
    r = torch.arange(rows.start, rows.stop, dtype=torch.int64,
                     device=device) * shape[-1] + offset
    c = torch.arange(cols.start, cols.stop, dtype=torch.int64, device=device)
    idx = r[None, :] + c[:, None] if transposed else r[:, None] + c[None, :]
    return idx.to(torch.int32)


def fast_values(index: torch.Tensor, dtype) -> torch.Tensor:
    """The float weights of `fast_index`'s indices."""
    dev = index.device
    table = ((torch.arange(17, dtype=torch.float32, device=dev) - 8)
             * torch.full((), 0.01, dtype=torch.float32, device=dev))
    return table.to(dtype)[index.remainder(17)]


def fast_codes(index: torch.Tensor) -> torch.Tensor:
    """The int8 codes of `fast_index`'s indices."""
    return (index.remainder(255) - 127).to(torch.int8)


def _fast_block(shape, offset, rows, cols, make, dtype, device,
                transposed=False) -> torch.Tensor:
    """make(fast_index(...)) over the block, stored (len(rows), len(cols)),
    or `transposed` as a row-major (len(cols), len(rows)) tensor, computed
    a chunk of its outer axis at a time."""
    outer, inner = (cols, rows) if transposed else (rows, cols)
    out = torch.empty(len(outer), len(inner), dtype=dtype, device=device)
    # index elements a pass: on a CPU few enough that the int64
    # temporaries stay in its caches, on the card enough that the launches
    # do not dominate (500 passes for the 7B)
    chunk = 1 << 20 if out.device.type == "cpu" else 1 << 24
    step = max(1, chunk // max(1, len(inner)))
    for a in range(0, len(outer), step):
        part = outer[a:a + step]
        r, c = (inner, part) if transposed else (part, inner)
        out[a:a + len(part)] = make(
            fast_index(shape, offset, r, c, device, transposed))
    return out


def _tp_part(r: range, index: int, n: int, shape) -> range:
    if len(r) % n:
        raise ValueError(f"{tuple(shape)} does not split over tp={n}")
    w = len(r) // n
    return r[index * w:(index + 1) * w]


def _init_fast(cfg: ModelConfig, dtype, device, mesh, int8: bool) -> dict:
    tpi, tpn = _tp_rank(mesh)
    stage, stages = stage_of(mesh)
    f32 = torch.float32

    def leaf(key, shape, offset=0, rule=None):
        """Rank's part of the JAX leaf `key` of (per-layer) `shape` whose
        flat index starts at `offset`, under the tp `rule`."""
        two_d = tuple(shape) if len(shape) == 2 else (1, shape[0])
        rows, cols = range(two_d[0]), range(two_d[1])
        if rule is not None and tpn > 1:
            if rule == COL or len(shape) == 1:
                cols = _tp_part(cols, tpi, tpn, shape)
            else:
                rows = _tp_part(rows, tpi, tpn, shape)
        if not int8 or (key != "embed" and key not in FAST_MATMUL_KEYS):
            t = _fast_block(two_d, offset, rows, cols,
                            lambda i: fast_values(i, dtype), dtype, device)
            return t.reshape(-1) if len(shape) == 1 else t
        if key == "embed":  # per-row scales, row-major codes
            q8 = _fast_block(two_d, offset, rows, cols, fast_codes,
                             torch.int8, device)
            return {"q8": q8, "sc": torch.full((len(rows),), FAST_SCALE,
                                               dtype=f32, device=device)}
        q8 = _fast_block(two_d, offset, rows, cols, fast_codes, torch.int8,
                         device, transposed=True).t()
        return {"q8": q8, "sc": torch.full((len(cols),), FAST_SCALE,
                                           dtype=f32, device=device)}

    def stacked(shapes, li, rules=None):
        return {k: leaf(k, s, li * int(np.prod(s)), (rules or {}).get(k))
                for k, s in shapes.items()}

    def holds(part, key=None):
        return stage_holds(part, key, stage, stages)

    t, v = cfg.text, cfg.vision
    c = t.hidden_size
    layer_shapes, block_shapes, merger_shapes = leaf_shapes(cfg)
    language = {}
    if holds("language", "embed"):
        language["embed"] = leaf("embed", (t.vocab_size, c))
    language["layers"] = [
        stacked(layer_shapes, li, LAYER_RULES)
        for li in stage_layers(t.num_hidden_layers, stage, stages)]
    if holds("language", "lm_head"):  # with the final norm
        language["norm"] = leaf("norm", (c,))
        language["lm_head"] = leaf("lm_head", (c, t.vocab_size), rule=COL)
    if not holds("vision"):
        return {"language": language}
    vision = {
        "patch_embed": leaf("patch_embed",
                            (v.patch_input_dim, v.hidden_size)),
        "blocks": [stacked(block_shapes, b) for b in range(v.depth)],
        "merger": {k: leaf(k, s) for k, s in merger_shapes.items()},
    }
    return {"language": language, "vision": vision}


def init_params_fast(cfg: ModelConfig, dtype=torch.bfloat16, device="cpu",
                     mesh=None) -> dict:
    """The JAX package's deterministic weights of a checkpoint-less preset
    (quickvideo_tpu/models/qwen25_vl/model.py::init_params_fast), made on
    `device`: every leaf equals, element for element, the JAX tree's under
    `params_from_jax`. With `mesh`, this rank's part of it (its stage's
    layers and parts, its tp slices), computed from those indices alone."""
    return _init_fast(cfg, dtype, device, mesh, int8=False)


def init_params_fast_quantized(cfg: ModelConfig, dtype=torch.bfloat16,
                               device="cpu", mesh=None) -> dict:
    """The int8 counterpart (quickvideo_tpu/ops/quantization.py::
    init_params_fast_quantized): the matrices as {"q8", "sc"} in the port's
    int8 layout (ops/quantization.py), the rest as init_params_fast's; no
    float matrix is made first."""
    return _init_fast(cfg, dtype, device, mesh, int8=True)


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
