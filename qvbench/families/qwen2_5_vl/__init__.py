"""Qwen2.5-VL (the 3B, 7B and 72B configs), served by the port's
`qwen25_lvu_interleaved` engine.

Re-exports the benchmark's Qwen2.5-VL files, which stay where they are:
qvbench/spec.py (the config's sizes), weights.py (the seeded tree),
template.py (the chat template), counts.py (operations and kernel bounds)
and reference/ (the plain reference and the comparison). Its own: a mix's
groups at the 2-frame temporal patch, the KV cache kind from a request's
bytes a slot, and the control, which exists for int8 weights only (the
reference with int4 weights in the program's place).
"""

from qvbench.counts import b1_group_bound_s, request_ops, vision_mlp_bounds_s
from qvbench.reference import compare
from qvbench.reference.compare import NUMBERS, check_program
from qvbench.spec import load_spec
from qvbench.template import prefix_ids, suffix_ids
from qvbench.weights import make_params

__all__ = ["LVU_MODEL_TYPE", "NUMBERS", "b1_group_bound_s", "check_control",
           "check_program", "control_unavailable", "group_frames",
           "group_tokens", "kv_variant", "load_spec", "make_params",
           "patches_per_group", "prefix_len", "request_ops", "suffix_len",
           "vision_mlp_bounds_s"]

LVU_MODEL_TYPE = "qwen25_lvu_interleaved"


def group_frames(spec, mix):
    """Frames of each group: the group size rounded up to the temporal
    patch (2), the last group what is left."""
    n = int(mix.video["frames"])
    g = int(mix.lvu["video_group_size"])
    g += g % 2
    return [min(g, n - off) for off in range(0, n, g)]


def group_tokens(spec, mix):
    """Merged video tokens of each group at the model grid (the frames'
    own size: the mix keeps it within the pixel budget)."""
    v = spec.vision
    h, w = int(mix.video["height"]), int(mix.video["width"])
    per_t = (h // v.patch // v.merge) * (w // v.patch // v.merge)
    return [-(-cnt // v.temporal_patch) * per_t
            for cnt in group_frames(spec, mix)]


def patches_per_group(spec, mix):
    """Patches each group's vision tower runs, where every group has the
    same count; else None."""
    v = spec.vision
    h, w = int(mix.video["height"]), int(mix.video["width"])
    per_t = (h // v.patch) * (w // v.patch)
    counts = {-(-c // v.temporal_patch) * per_t
              for c in group_frames(spec, mix)}
    return counts.pop() if len(counts) == 1 else None


def prefix_len(spec) -> int:
    """Tokens before the first video placeholder."""
    return len(prefix_ids(spec))


def suffix_len(spec, question: str) -> int:
    """Tokens after the last video placeholder."""
    return len(suffix_ids(spec, question))


def kv_variant(spec, record) -> str:
    """The cache kind from the request's bytes a slot, layer and kv head:
    bf16 K and V, int8 K and V with f32 scales, or int8 K beside bf16 V."""
    t = spec.text
    per = (record.kv_bytes / max(record.cache_length, 1)
           / (t.layers * t.kv_heads))
    d = t.head_dim
    return {4 * d: "bf16", 2 * (d + 4): "int8", 3 * d + 4: "int8k"}.get(
        round(per), "bf16")


def control_unavailable(spec):
    if spec.int8_weights:
        return None
    return (f"{spec.name}: a control is defined for int8 weights only (the "
            "reference at int4)")


def check_control(tree, spec, mix, pool, records, device):
    """The reference with int4 weights in the program's place."""
    return compare.check_control(tree, spec, mix, pool, records, device,
                                 "int4")
