"""Seeded random weights, made on the device in the type they are served.

One flat buffer of normal draws (std 0.02) is made with one generator on
the device; every matrix of the parameter tree is a view of it, and every
norm weight (shifted to 1 + N(0, 0.02)) and bias a copy of its slice, so
that once the port has replaced the matrices by its int8 codes nothing
holds the buffer. The same seed on the same
device gives the same tensors, so the reference makes them anew after the
program has been freed instead of keeping a second copy beside it.
"""

from __future__ import annotations

import numpy as np
import torch

from qvbench.spec import ModelSpec, layer_shapes

STD = 0.02


def _leaf_list(spec: ModelSpec):
    """(path, shape) of every leaf in draw order; a path is a tuple of
    keys into the tree."""
    t, v = spec.text, spec.vision
    layer, block, merger = layer_shapes(spec)
    out = [(("language", "embed"), (t.vocab, t.hidden))]
    for li in range(t.layers):
        out += [(("language", "layers", li, k), s) for k, s in layer.items()]
    out.append((("language", "norm"), (t.hidden,)))
    if not t.tied:
        out.append((("language", "lm_head"), (t.hidden, t.vocab)))
    out.append((("vision", "patch_embed"), (v.patch_dim, v.hidden)))
    for bi in range(v.depth):
        out += [(("vision", "blocks", bi, k), s) for k, s in block.items()]
    out += [(("vision", "merger", k), s) for k, s in merger.items()]
    return out


def _is_norm(path) -> bool:
    return str(path[-1]).startswith("ln") or path[-1] == "norm"


def make_params(spec: ModelSpec, seed: int, device, dtype=torch.bfloat16):
    """The parameter tree of `spec` from `seed`, in the port's layout:
    {"language": {embed, layers: [...], norm, lm_head}, "vision":
    {patch_embed, blocks: [...], merger}}; with tied embeddings lm_head is
    the embedding's transpose."""
    leaves = _leaf_list(spec)
    total = sum(int(np.prod(s)) for _, s in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(0.0, STD, generator=gen)
    tree = {"language": {"layers": [{} for _ in range(spec.text.layers)]},
            "vision": {"blocks": [{} for _ in range(spec.vision.depth)],
                       "merger": {}}}
    off = 0
    for path, shape in leaves:
        n = int(np.prod(shape))
        leaf = flat[off : off + n].view(shape)
        off += n
        if len(shape) == 1:
            leaf = leaf + 1.0 if _is_norm(path) else leaf.clone()
        node = tree
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = leaf
    if spec.text.tied:
        lang = tree["language"]
        lang["lm_head"] = lang["embed"].t()
    return tree

