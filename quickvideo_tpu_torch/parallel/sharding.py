"""Tensor-parallel slicing rules: which part of each parameter a tp rank
holds, and the cache's per-rank shape.

Counterpart of quickvideo_tpu/parallel/sharding.py (Megatron layout, the
same as its `param_shardings`), applied as per-rank slices instead of
GSPMD annotations:

  wq/wk/wv + bq/bk/bv  columns (heads) over tp  -> local heads
  wo                   rows (heads) over tp     -> partial sums, all-reduced
  wg/wu                columns over tp; wd rows -> one all-reduce per MLP
  lm_head              columns (vocab) over tp  -> logits all-gathered
  embed, norms, the vision tower                replicated

An int8 leaf ({"q8", "sc"}, one scale per output column) slices q8 like
the weight; its scale follows the output split: sliced for a column-split
product, replicated for a row-split one (quickvideo_tpu/parallel/
sharding.py:95-111). The KV cache holds the rank's kv heads
(`shard_cache`) and, under context parallelism, its capacity window
(parallel/context_parallel.py::shard_cache_cp).

tp must divide both num_attention_heads and num_key_value_heads (the 7B:
tp in {1, 2, 4}); any other tp raises NotImplementedError.

Pipeline parallelism (pp) splits the layer axis first: stage s of S holds
layers [s * L / S, (s + 1) * L / S) (`stage_layers`), the vision tower and
the embedding live on the first stage, the final norm and lm_head on the
last (`stage_params`), and tp then slices within the stage as above
(quickvideo_tpu/parallel/pipeline.py:179-208). A mesh-like object without
a pp axis counts as one stage (`stage_of`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from quickvideo_tpu_torch.ops.quantization import is_quantized

COL, ROW = "col", "row"

# per decoder layer: the JAX spec's sharded axis, as the port's (in, out)
# matrices and (out,) biases see it
LAYER_RULES = {
    "wq": COL, "bq": COL, "wk": COL, "bk": COL, "wv": COL, "bv": COL,
    "wo": ROW, "wg": COL, "wu": COL, "wd": ROW,
}
LANGUAGE_RULES = {"lm_head": COL}


def check_tp(text_cfg, tp: int) -> None:
    """NotImplementedError unless tp divides the q and kv head counts."""
    if tp < 1 or (text_cfg.num_attention_heads % tp
                  or text_cfg.num_key_value_heads % tp):
        raise NotImplementedError(
            f"not ported to quickvideo_tpu_torch: tp={tp}, which does not "
            f"divide num_attention_heads={text_cfg.num_attention_heads} and "
            f"num_key_value_heads={text_cfg.num_key_value_heads} (the KV "
            "cache is split by kv heads)"
        )


def stage_of(mesh) -> tuple:
    """(this rank's stage, stages) of `mesh` ((0, 1) for None or a mesh
    without a pp axis)."""
    stages = getattr(mesh, "pp", 1) if mesh is not None else 1
    return (mesh.index("pp"), stages) if stages > 1 else (0, 1)


def stage_layers(n_layers: int, stage: int, stages: int) -> range:
    """The global layers of `stage` (stages divides n_layers)."""
    per = n_layers // stages
    return range(stage * per, (stage + 1) * per)


def stage_holds(part: str, key: Optional[str], stage: int,
                stages: int) -> bool:
    """Whether `stage` holds params[part][key] (key None: the whole part):
    the vision tower and the embedding on the first stage, the final norm
    and lm_head on the last; the layers are split (stage_layers)."""
    if part == "vision" or key == "embed":
        return stage == 0
    if key in ("norm", "lm_head"):
        return stage == stages - 1
    return True


def stage_params(params: dict, stage: int, stages: int) -> dict:
    """Stage `stage` of `stages`' tree from the whole one (module
    docstring); its leaves are the whole tree's, not copies."""
    if stages == 1:
        return params
    out = {}
    for part, tree in params.items():
        if part != "language":
            if stage_holds(part, None, stage, stages):
                out[part] = tree
            continue
        rows = stage_layers(len(tree["layers"]), stage, stages)
        out[part] = {
            k: v[rows.start:rows.stop] if k == "layers" else v
            for k, v in tree.items()
            if k == "layers" or stage_holds(part, k, stage, stages)
        }
    return out


def _slice(t: torch.Tensor, dim: int, index: int, n: int) -> torch.Tensor:
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over tp={n}")
    w = size // n
    return t.narrow(dim, index * w, w)


def shard_leaf(leaf, rule: Optional[str], index: int, n: int):
    """Rank `index` of `n`'s part of one leaf under `rule` (COL: the last
    dim; ROW: the second-to-last of a matrix), as a new contiguous tensor
    that holds no view of `leaf` (a quantized q8 keeps its column-major
    layout). rule None: the leaf itself."""
    if rule is None or n == 1:
        return leaf
    if is_quantized(leaf):
        q8, sc = leaf["q8"], leaf["sc"]
        if rule == COL:
            q8, sc = _slice(q8, -1, index, n), _slice(sc, -1, index, n)
        else:
            q8 = _slice(q8, -2, index, n)
        # (in, out) view of a row-major (out, in) tensor, as quantize_weight
        # lays it out; copied even where the column slice's transpose is
        # already contiguous, so the whole matrix is not kept alive
        q8 = q8.t().clone(memory_format=torch.contiguous_format).t()
        return {"q8": q8, "sc": sc.clone()}
    dim = -1 if rule == COL or leaf.dim() == 1 else -2
    return _slice(leaf, dim, index, n).contiguous().clone()


def shard_language_layer(lp: dict, index: int, n: int) -> dict:
    return {k: shard_leaf(v, LAYER_RULES.get(k), index, n)
            for k, v in lp.items()}


def shard_params(params: dict, index: int, n: int) -> dict:
    """tp rank `index` of `n`'s tree from the full one (leaves it does not
    split are shared, not copied)."""
    if n == 1:
        return params
    out = dict(params)
    if "language" in params:
        lang = params["language"]
        out["language"] = {
            k: (v if k == "layers"
                else shard_leaf(v, LANGUAGE_RULES.get(k), index, n))
            for k, v in lang.items()
        }
        out["language"]["layers"] = [
            shard_language_layer(lp, index, n) for lp in lang["layers"]
        ]
    return out


def mesh_params(params: dict, mesh) -> dict:
    """This rank's tree from the whole one: its pipeline stage's part
    (stage_params), then its tp slices (shard_params)."""
    if mesh is None:
        return params
    return shard_params(stage_params(params, *stage_of(mesh)),
                        mesh.index("tp"), mesh.tp)


def shard_cache(cache, index: int, n: int):
    """Rank `index` of `n`'s kv heads of a KVCache (values and int8 scales
    alike), as new tensors; the lengths and capacity window are kept."""
    if n == 1:
        return cache

    def part(t):
        return None if t is None else _slice(t, 1, index, n).contiguous()

    return dataclasses.replace(cache, k=part(cache.k), v=part(cache.v),
                               k_scale=part(cache.k_scale),
                               v_scale=part(cache.v_scale))


def _leaf_nbytes(leaf, rule: Optional[str], tp: int) -> int:
    """Bytes of the whole of a leaf whose tp rank's part is `leaf`."""
    if isinstance(leaf, dict) and not is_quantized(leaf):
        return sum(_leaf_nbytes(v, None, tp) for v in leaf.values())
    if isinstance(leaf, (list, tuple)):
        return sum(_leaf_nbytes(v, None, tp) for v in leaf)
    if not isinstance(leaf, torch.Tensor) and not is_quantized(leaf):
        return 0
    n = tp if rule is not None else 1
    if is_quantized(leaf):
        sc_n = n if rule == COL else 1
        return leaf["q8"].nbytes * n + leaf["sc"].nbytes * sc_n
    return leaf.nbytes * n


def global_nbytes(params: dict, tp: int) -> int:
    """Bytes of the whole model's parameters, from a tp rank's tree (the
    JAX engine counts its sharded arrays whole); from a pipeline stage's
    tree, the bytes of that stage's part, which the stages sum
    (prefill/engine.py::LVUEngine.resolve_kv_dtype)."""
    total = 0
    for part, tree in params.items():
        if part != "language":
            total += _leaf_nbytes(tree, None, tp)
            continue
        for k, v in tree.items():
            if k == "layers":
                total += sum(_leaf_nbytes(x, LAYER_RULES.get(name), tp)
                             for lp in v for name, x in lp.items())
            else:
                total += _leaf_nbytes(v, LANGUAGE_RULES.get(k), tp)
    return total
