"""Helpers shared by `chip_smoke.py` and the tests: the checks of the int8
vision kernels (B3, B4, B6) against their plain versions, and a writer of
safetensors checkpoints (`write_checkpoint`) for machines without the
`safetensors` package.

Tolerances. Kernel and plain version compute the same rounding points, but
their f32 row sums (rmsnorm), rsqrt and exp differ by ulps. Now and then
that flips a bf16 rounding of the normed row and with it an int8 code, or a
row's scale by one bf16 step: on 1280-wide rows a few percent of the rows
see such a flip. So at least FUSED_ROWS of the rows must agree exactly (B3)
or with a row scale within 1e-5 relative and dequantized values within one
quantization step of that row (B4, B6). Every row must lie within
FUSED_ATOL + FUSED_RTOL * |plain| (B3, the JAX suite's own tolerance) or
have its scale within FUSED_SCALE_RTOL (B4, B6: a row whose input codes
changed has other silu * mul values; measured up to 1.6e-2 on an H100).
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import torch

from quickvideo_tpu_torch.ops import fused_vision_mlp as fm
from quickvideo_tpu_torch.ops.quantization import quantize_weight

FUSED_ROWS = 0.9
FUSED_ATOL = FUSED_RTOL = 5e-2
FUSED_SCALE_RTOL = 5e-2
SAME_SCALE_RTOL = 1e-5


def fused_block(dev, c: int, n_qkv: int, inter: int, seed: int) -> dict:
    """One int8 vision block's QKV and MLP weights at widths (C, N) and
    (C, I), drawn from `seed` on `dev`, the MLP prepped for B4
    (fuse_vision_mlp_weights)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    bp = {
        "wg": quantize_weight(rnd(c, inter, scale=0.02)),
        "wu": quantize_weight(rnd(c, inter, scale=0.02)),
        "wd": quantize_weight(rnd(inter, c, scale=0.02)),
        "bg": rnd(inter, scale=0.05).bfloat16(),
        "bu": rnd(inter, scale=0.05).bfloat16(),
        "bd": rnd(c, scale=0.05).bfloat16(),
    }
    cfg = SimpleNamespace(intermediate_size=inter)
    bp = fm.fuse_vision_mlp_weights({"blocks": [bp]}, cfg)["blocks"][0]
    bp["wqkv"] = quantize_weight(rnd(c, n_qkv, scale=0.02))
    bp["bqkv"] = rnd(n_qkv, scale=0.05).bfloat16()
    bp["ln"] = (1.0 + rnd(c, scale=0.1)).bfloat16()
    return bp


def bf16_rows_close(got: torch.Tensor, ref: torch.Tensor):
    """B3: (max abs error, ok, what failed) under the FUSED_* rule."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    rows_same = (got == ref).all(1).float().mean().item()
    why = []
    if not torch.isfinite(g).all():
        why.append("non-finite output")
    if not (diff <= FUSED_ATOL + FUSED_RTOL * r.abs()).all():
        why.append(f"outside {FUSED_ATOL} + {FUSED_RTOL} * |plain|")
    if rows_same < FUSED_ROWS:
        why.append(f"{rows_same:.4f} of rows identical < {FUSED_ROWS}")
    return diff.max().item(), not why, "; ".join(why)


def quantized_close(got, ref):
    """B4/B6: (max abs error of the dequantized values, ok, what failed)
    under the FUSED_* rule; `got` and `ref` are (codes (S, Np), scales
    (S, 1)). A row whose scale agrees is held to one step of its own
    scale."""
    (q, s), (qr, sr) = got, ref
    if q.dtype != torch.int8 or q.shape != qr.shape or s.shape != sr.shape:
        return float("inf"), False, (
            f"got {q.dtype} {tuple(q.shape)} / {tuple(s.shape)}, expected "
            f"{qr.dtype} {tuple(qr.shape)} / {tuple(sr.shape)}"
        )
    rel = ((s - sr).abs() / sr).squeeze(1)
    agree = rel <= SAME_SCALE_RTOL
    diff = (q.float() * s - qr.float() * sr).abs()
    share = agree.float().mean().item()
    why = []
    if not torch.isfinite(s).all():
        why.append("non-finite scale")
    if not (rel <= FUSED_SCALE_RTOL).all():
        why.append(f"a row scale off by {rel.max().item():.3e} relative")
    if share < FUSED_ROWS:
        why.append(f"{share:.4f} of row scales agree < {FUSED_ROWS}")
    if not (diff[agree] <= sr[agree] * 1.01).all():
        why.append("a row with an agreeing scale is off by more than one "
                   "of its steps")
    return diff.max().item(), not why, "; ".join(why)


# -- safetensors checkpoints -------------------------------------------------

ST_DTYPES = {torch.bfloat16: "BF16", torch.float16: "F16",
             torch.float32: "F32"}


def save_safetensors(tensors: dict, path: str) -> None:
    """`tensors` ({name: tensor}) as one .safetensors file: an 8-byte
    little-endian header length, a JSON header (padded with spaces to 8
    bytes) giving each tensor's dtype, shape and byte range, then the raw
    row-major tensors in that order."""
    header, blobs, off = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        raw = t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def hf_config(cfg) -> dict:
    """The config.json fields from which `get_config` rebuilds `cfg`."""
    v, t = cfg.vision, cfg.text
    return {
        "vision_config": {
            k: getattr(v, k) for k in (
                "depth", "hidden_size", "intermediate_size", "num_heads",
                "in_channels", "patch_size", "spatial_merge_size",
                "temporal_patch_size", "tokens_per_second", "window_size",
                "fullatt_block_indexes", "out_hidden_size")
        },
        "text_config": {
            **{k: getattr(t, k) for k in (
                "vocab_size", "hidden_size", "intermediate_size",
                "num_hidden_layers", "num_attention_heads",
                "num_key_value_heads", "rope_theta", "rms_norm_eps")},
            "rope_scaling": {"mrope_section": list(t.mrope_section)},
        },
        "tie_word_embeddings": t.tie_word_embeddings,
        **{k: getattr(cfg, k) for k in (
            "image_token_id", "video_token_id", "vision_start_token_id",
            "vision_end_token_id")},
    }


def hf_state_dict(params: dict, cfg, layout: str = "modern") -> dict:
    """The port's float tree as an HF Qwen2.5-VL state dict: matrices back
    in the (out, in) layout, the patch embedding as its Conv3d kernel, keys
    in the `modern` (model.language_model.* / model.visual.*) or `legacy`
    (model.* / visual.*) layout; no lm_head when the config ties it."""
    lang_pre, vis_pre = {"modern": ("model.language_model.", "model.visual."),
                         "legacy": ("model.", "visual.")}[layout]
    lang, vis = params["language"], params["vision"]
    v = cfg.vision
    out = {lang_pre + "embed_tokens.weight": lang["embed"],
           lang_pre + "norm.weight": lang["norm"]}
    if not cfg.text.tie_word_embeddings:
        out["lm_head.weight"] = lang["lm_head"].t()
    for i, lp in enumerate(lang["layers"]):
        pre = f"{lang_pre}layers.{i}."
        out[pre + "input_layernorm.weight"] = lp["ln1"]
        out[pre + "post_attention_layernorm.weight"] = lp["ln2"]
        for n in "qkv":
            out[pre + f"self_attn.{n}_proj.weight"] = lp[f"w{n}"].t()
            out[pre + f"self_attn.{n}_proj.bias"] = lp[f"b{n}"]
        out[pre + "self_attn.o_proj.weight"] = lp["wo"].t()
        for n, hf in (("wg", "gate"), ("wu", "up"), ("wd", "down")):
            out[pre + f"mlp.{hf}_proj.weight"] = lp[n].t()
    out[vis_pre + "patch_embed.proj.weight"] = vis["patch_embed"].t().reshape(
        v.hidden_size, v.in_channels, v.temporal_patch_size, v.patch_size,
        v.patch_size)
    for i, bp in enumerate(vis["blocks"]):
        pre = f"{vis_pre}blocks.{i}."
        out[pre + "norm1.weight"] = bp["ln1"]
        out[pre + "norm2.weight"] = bp["ln2"]
        for n, hf in (("qkv", "attn.qkv"), ("o", "attn.proj"),
                      ("g", "mlp.gate_proj"), ("u", "mlp.up_proj"),
                      ("d", "mlp.down_proj")):
            out[pre + hf + ".weight"] = bp[f"w{n}"].t()
            out[pre + hf + ".bias"] = bp[f"b{n}"]
    m = vis["merger"]
    out[vis_pre + "merger.ln_q.weight"] = m["ln_q"]
    for n, idx in (("1", "0"), ("2", "2")):
        out[vis_pre + f"merger.mlp.{idx}.weight"] = m[f"w{n}"].t()
        out[vis_pre + f"merger.mlp.{idx}.bias"] = m[f"b{n}"]
    return {k: t.contiguous() for k, t in out.items()}


def write_checkpoint(directory: str, params: dict, cfg,
                     layout: str = "modern", dtype=None,
                     shards: int = 2) -> str:
    """A checkpoint directory of the port's float tree: config.json and the
    state dict (`dtype`, default each leaf's own) over `shards`
    .safetensors files. Returns `directory`."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f)
    state = {k: t if dtype is None else t.to(dtype)
             for k, t in hf_state_dict(params, cfg, layout).items()}
    names = list(state)
    per = -(-len(names) // shards)
    for i in range(shards):
        part = names[i * per : (i + 1) * per]
        save_safetensors(
            {k: state[k] for k in part},
            os.path.join(directory,
                         f"model-{i + 1:05d}-of-{shards:05d}.safetensors"),
        )
    return directory
