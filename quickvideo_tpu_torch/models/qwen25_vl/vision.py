"""Qwen2.5-VL vision tower (ViT) in PyTorch.

Counterpart of quickvideo_tpu/models/qwen25_vl/vision.py. `build_layout` is
the numpy window/rotary plan copied from there (that module imports jax;
tests pin copy == original). The forward takes the decoded frames as they
arrive on the device (packed yuv420 or RGB uint8, or patchified floats),
converts and patchifies on the device, runs the 32 blocks in a Python loop
and merges.

Each block takes one of the JAX package's two attention routes, chosen as
vision.py:373-388 chooses them (`_use_2d`): the 2D route (kernel B2, rotary
inside the kernel) when `QV_VISION_2D` is not "0" and the JAX package's
tiling rule (`kernel_applicable`) takes every span the block needs, else
the head-major route: the rotary pass (`vision_rotary`, in the activation
dtype), then kernel B5 (ops/vision_attention.py) once per window-size
bucket, or once over the frame-grouped rows in full-attention blocks. The
rotary tables are cast to the activation dtype once per forward, as the
JAX package casts them before either route rotates. B5 takes every span of the
route, also those the JAX package sends to its XLA `_block_attention`
(same function, same rounding points). The rule is applied on every
device: the CPU path stands in for the JAX package's kernel route.

Weights keep the JAX layout (in, out) and are applied as `x @ w`. With
int8 weights (ops/quantization.py) the tower follows the JAX package's
`qdot_vision` default (QV_INT8_ACT_VISION=0): only the MLP quantizes its
activations. A block on the 2D route runs kernel B3 for ln1 + QKV (act-
quantized, as the JAX package's fused QKV); the MLP runs kernel B4 for
ln2 + gate/up + SwiGLU when the block carries the one-time
`fuse_vision_mlp_weights` prep (`wgu_p`), else the unfused act-quantized
chain (vision.py:534-540). Every other product (the head-major route's
QKV, the attention output, the patch embed, the merger) is weight-only
(`act_quant=False`). Frames decoded at the source size are resized to the
model grid on the device (`native_hw`, ops/resize.py::lanczos3_resize).
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from quickvideo_tpu_torch.models.qwen25_vl.config import VisionConfig
from quickvideo_tpu_torch.utils import timing
from quickvideo_tpu_torch.video.preprocess import patch_norm_scale_bias
from quickvideo_tpu_torch.ops.fused_vision_mlp import (
    ln_dual_gemm_silu_quant,
    ln_gemm_bias,
)
from quickvideo_tpu_torch.ops.resize import lanczos3_resize
from quickvideo_tpu_torch.ops.quantization import (
    is_quantized,
    linear,
    linear_multi,
    qdot,
    qdot_pre,
)
from quickvideo_tpu_torch.ops.vision_attention import (
    block_diag_attention,
    block_diag_attention_2d,
    kernel_applicable,
    vision_rotary,
)


class VisionLayout(NamedTuple):
    """Static index plan for one (t, h, w) patch grid."""

    grid_thw: Tuple[int, int, int]
    perm: np.ndarray  # (S,) patch-level window-order permutation
    inv_perm_units: np.ndarray  # (S/merge_unit,) undo for merger output
    cos: np.ndarray  # (S, head_dim) rotary table, window order
    sin: np.ndarray
    nw: int  # number of windows
    mw: int  # max window length in patches (uniform grids: THE length)
    win_uniform: bool  # True -> plain reshape works (no padding)
    frame_len: int  # h*w patches per temporal frame (full-attn block)
    seq_len: int
    # ragged grids: windows size-bucketed in the permutation;
    # ((span_patches, start_row, end_row), ...)
    buckets: Tuple[Tuple[int, int, int], ...] = ()
    frame_perm: Optional[np.ndarray] = None  # bucket order -> frame-grouped
    frame_inv: Optional[np.ndarray] = None  # and back


@functools.lru_cache(maxsize=64)
def build_layout(
    grid_thw: Tuple[int, int, int],
    patch_size: int,
    spatial_merge_size: int,
    window_size: int,
    head_dim: int,
    theta: float = 10000.0,
) -> VisionLayout:
    t, h, w = grid_thw
    sm = spatial_merge_size
    unit = sm * sm
    lh, lw = h // sm, w // sm  # merged-unit grid
    s = t * h * w

    # --- window permutation over merge units (HF get_window_index) ---
    vit_win = window_size // sm // patch_size  # units per window edge
    pad_h = (-lh) % vit_win
    pad_w = (-lw) % vit_win
    nwh, nww = (lh + pad_h) // vit_win, (lw + pad_w) // vit_win
    idx = np.arange(t * lh * lw).reshape(t, lh, lw)
    idxp = np.full((t, lh + pad_h, lw + pad_w), -100, np.int64)
    idxp[:, :lh, :lw] = idx
    idxp = (
        idxp.reshape(t, nwh, vit_win, nww, vit_win)
        .transpose(0, 1, 3, 2, 4)
        .reshape(t, nwh * nww, vit_win, vit_win)
    )
    seqlens_units = (idxp != -100).sum(axis=(2, 3)).reshape(-1)  # per window
    buckets: Tuple[Tuple[int, int, int], ...] = ()
    frame_perm = frame_inv = None
    if (seqlens_units == seqlens_units[0]).all():
        flat = idxp.reshape(-1)
        window_index = flat[flat != -100]  # (t*lh*lw,) unit-level perm
    else:
        # ragged windows: size-bucket them (stable sort, largest first) so
        # attention runs uniform per bucket (see VisionLayout docstring)
        rows = idxp.reshape(t * nwh * nww, vit_win * vit_win)
        order = np.argsort(-seqlens_units, kind="stable")
        window_index = np.concatenate(
            [rows[i][rows[i] != -100] for i in order]
        )
        sizes_sorted = seqlens_units[order]
        blist = []
        start = 0
        for size in sorted(set(sizes_sorted.tolist()), reverse=True):
            n_here = int((sizes_sorted == size).sum())
            span = size * unit
            blist.append((span, start, start + n_here * span))
            start += n_here * span
        buckets = tuple(blist)
        # full-attention layers need rows grouped by temporal slice
        units_per_slice = lh * lw
        slice_of_unit = window_index // units_per_slice
        slice_of_patch = np.repeat(slice_of_unit, unit)
        frame_perm = np.argsort(slice_of_patch, kind="stable")
        frame_inv = np.argsort(frame_perm, kind="stable")

    # patch-level permutation: each unit is `unit` consecutive patches
    perm = (window_index[:, None] * unit + np.arange(unit)[None, :]).reshape(-1)
    inv_perm_units = np.argsort(window_index, kind="stable")

    # --- rotary tables (HF rot_pos_emb), then reorder to window order ---
    hp = np.arange(h).reshape(h, 1).repeat(w, 1)
    hp = (
        hp.reshape(lh, sm, lw, sm).transpose(0, 2, 1, 3).reshape(-1)
    )
    wp = np.arange(w).reshape(1, w).repeat(h, 0)
    wp = (
        wp.reshape(lh, sm, lw, sm).transpose(0, 2, 1, 3).reshape(-1)
    )
    pos_hw = np.stack([hp, wp], axis=-1)  # (h*w, 2)
    pos_hw = np.tile(pos_hw, (t, 1))  # (S, 2)
    half = head_dim // 2  # rotary dim per (h, w) axis pair
    inv_freq = 1.0 / (theta ** (np.arange(0, half, 2, dtype=np.float64) / half))
    freqs = pos_hw[:, :, None].astype(np.float64) * inv_freq[None, None, :]
    rot = freqs.reshape(s, -1)  # (S, head_dim/2): [h-freqs | w-freqs]
    emb = np.concatenate([rot, rot], axis=-1)  # (S, head_dim)
    cos = np.cos(emb)[perm].astype(np.float32)
    sin = np.sin(emb)[perm].astype(np.float32)

    nw = len(seqlens_units)
    mw = int(seqlens_units.max()) * unit if nw else 0
    win_uniform = not buckets

    return VisionLayout(
        grid_thw=grid_thw,
        perm=perm,
        inv_perm_units=inv_perm_units,
        cos=cos,
        sin=sin,
        nw=nw,
        mw=mw,
        win_uniform=win_uniform,
        frame_len=h * w,
        seq_len=s,
        buckets=buckets,
        frame_perm=frame_perm,
        frame_inv=frame_inv,
    )


def layout_tensors(layout: VisionLayout, device) -> dict:
    """The layout's index and rotary tables as tensors on `device`."""
    with timing.host_wait():  # copies from pageable host memory
        out = {
            "perm": torch.as_tensor(layout.perm, device=device),
            "inv_perm_units": torch.as_tensor(layout.inv_perm_units,
                                              device=device),
            "cos": torch.as_tensor(layout.cos, device=device),
            "sin": torch.as_tensor(layout.sin, device=device),
        }
        if layout.frame_perm is not None:
            out["frame_perm"] = torch.as_tensor(layout.frame_perm,
                                                device=device)
            out["frame_inv"] = torch.as_tensor(layout.frame_inv,
                                               device=device)
    return out


def _rms_norm(x, w, eps):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _vision_mlp(bp: dict, x: torch.Tensor, cfg: VisionConfig) -> torch.Tensor:
    """ln2 + gated MLP. int8 with the one-time prep: kernel B4 (ln2,
    gate/up, silu * mul, per-row requantize), then the down projection from
    its int8 output. int8 without it: the unfused act-quantized chain of
    vision.py:534-540."""
    if "wgu_p" in bp:
        mq8, ms = ln_dual_gemm_silu_quant(
            x, bp["ln2"], bp["wgu_p"], bp["bgu_p"], cfg.rms_norm_eps
        )
        return x + (qdot_pre(mq8, ms, bp["wd_p"]).to(x.dtype) + bp["bd"])
    h2 = _rms_norm(x, bp["ln2"], cfg.rms_norm_eps)
    if is_quantized(bp["wg"]):
        g, u = linear_multi(h2, (bp["wg"], bp["wu"]))
        mlp = F.silu(g + bp["bg"]) * (u + bp["bu"])
        return x + (linear(mlp, bp["wd"]) + bp["bd"])
    g = h2 @ bp["wg"] + bp["bg"]
    u = h2 @ bp["wu"] + bp["bu"]
    return x + (F.silu(g) * u) @ bp["wd"] + bp["bd"]


def _use_2d(s_len: int, layout: VisionLayout, cfg: VisionConfig,
            full_attn: bool) -> bool:
    """The JAX package's route choice (vision.py:374-388): the 2D route
    unless QV_VISION_2D=0 (read at call time) or its tiling rule rejects a
    span the block needs."""
    spans_needed = (
        [(s_len, layout.frame_len)] if full_attn
        else [(s_len, layout.mw)] if layout.win_uniform
        else [(b - a, span) for span, a, b in layout.buckets]
    )
    return (
        os.environ.get("QV_VISION_2D", "1") != "0"
        and cfg.head_dim % 2 == 0
        and all(n > 0 and kernel_applicable(n, span)
                for n, span in spans_needed)
    )


def vision_block(
    bp: dict,
    x: torch.Tensor,  # (S, C) window order
    lt: dict,  # layout_tensors
    layout: VisionLayout,
    cfg: VisionConfig,
    *,
    full_attn: bool,
) -> torch.Tensor:
    s_len, c = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    scale = hd ** -0.5
    use2d = _use_2d(s_len, layout, cfg, full_attn)
    if use2d and is_quantized(bp["wqkv"]):
        # kernel B3: ln1 + per-row int8 + GEMM + bias, always bf16 out
        qkv = ln_gemm_bias(
            x, bp["ln1"], bp["wqkv"], bp["bqkv"], cfg.rms_norm_eps
        )
    else:
        h = _rms_norm(x, bp["ln1"], cfg.rms_norm_eps)
        qkv = linear(h, bp["wqkv"], act_quant=False) + bp["bqkv"]  # (S, 3C)
    # strided views of the fused projection: the kernels read them in place
    q = qkv[:, :c].view(s_len, nh, hd)
    k = qkv[:, c : 2 * c].view(s_len, nh, hd)
    v = qkv[:, 2 * c :].view(s_len, nh, hd)
    cos, sin = lt["cos"], lt["sin"]
    if not use2d:
        # head-major route: the rotary pass (its plain version,
        # apply_vision_rotary, on the CPU), then kernel B5
        q, k = vision_rotary(q, k, cos, sin)

    def attend(q, k, v, span, rows=slice(None), out=None):
        if use2d:  # kernel B2 rotates the rows' q and k itself
            return block_diag_attention_2d(
                q, k, v, cos[rows], sin[rows], span, scale, out=out
            )
        return block_diag_attention(q, k, v, span, scale=scale, out=out)

    if full_attn and layout.buckets:
        # per-frame attention: bucketed window order interleaves frames, so
        # gather rows frame by frame and scatter back
        fp = lt["frame_perm"]
        out = attend(q[fp], k[fp], v[fp], layout.frame_len, fp)
        out = out[lt["frame_inv"]]
    elif full_attn:
        out = attend(q, k, v, layout.frame_len)
    elif layout.win_uniform:
        out = attend(q, k, v, layout.mw)
    else:
        # one call per window-size bucket, each writing its rows in place
        out = torch.empty(s_len, nh, hd, dtype=q.dtype, device=x.device)
        for span, a, b in layout.buckets:
            attend(q[a:b], k[a:b], v[a:b], span, slice(a, b), out=out[a:b])
    x = x + (linear(out.reshape(s_len, c), bp["wo"], x.dtype,
                    act_quant=False) + bp["bo"])
    return _vision_mlp(bp, x, cfg)


def _yuv420_to_rgb(pixels: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """Packed yuv420p frames (T, H*W*3/2) uint8 -> (T, 3, H, W) f32 in
    0..255: nearest chroma upsample + limited-range BT.601 (vision.py:599-626)."""
    t = pixels.shape[0]
    hw = sh * sw
    y = pixels[:, :hw].reshape(t, sh, sw).float()
    u = pixels[:, hw : hw + hw // 4].reshape(t, sh // 2, sw // 2).float()
    v = pixels[:, hw + hw // 4 :].reshape(t, sh // 2, sw // 2).float()
    u = u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) - 128.0
    v = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) - 128.0
    c = (y - 16.0) * 1.1643835
    r = c + 1.5960268 * v
    g = c - 0.3917623 * u - 0.8129676 * v
    b = c + 2.0172321 * u
    return torch.clamp(torch.stack([r, g, b], dim=1), 0.0, 255.0)


def _patchify(pixels: torch.Tensor, cfg: VisionConfig) -> torch.Tensor:
    """(T, C, H, W) -> (T/tps * H/ps * W/ps, C*tps*ps*ps) in HF's merged-unit
    order (vision.py:643-662)."""
    t_frames, c, fh, fw = pixels.shape
    tps, ps, ms = cfg.temporal_patch_size, cfg.patch_size, cfg.spatial_merge_size
    if t_frames % tps:
        pad = tps - t_frames % tps
        pixels = torch.cat([pixels, pixels[-1:].expand(pad, -1, -1, -1)], dim=0)
        t_frames = pixels.shape[0]
    gt, gh, gw = t_frames // tps, fh // ps, fw // ps
    return (
        pixels.reshape(gt, tps, c, gh // ms, ms, ps, gw // ms, ms, ps)
        .permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
        .reshape(gt * gh * gw, c * tps * ps * ps)
    )


def vision_forward(
    params: dict,
    pixels: torch.Tensor,  # on the device: (T, H*W*3/2) uint8 yuv420,
    # (T, 3, H, W) uint8 RGB, or (S, patch_input_dim) patchified floats
    layout: VisionLayout,
    cfg: VisionConfig,
    lt: Optional[dict] = None,
    native_hw: Optional[Tuple[int, int]] = None,  # the (H, W) frames arrive
    # at when they are resized on the device (LVUConfig.resize_on_device)
) -> torch.Tensor:
    """Patch embed -> window order -> blocks -> merger -> original order.
    Returns (S / merge_unit, out_hidden_size).

    Frames at another size than the model grid (`native_hw`, or RGB frames
    of another shape) are resampled to it on the device by
    `lanczos3_resize`, as the JAX function does with jax.image.resize
    (vision.py:629-642): yuv420 goes to RGB f32 at the source size, then
    the resize, a clamp to [0, 255], and the 0..255 normalize."""
    if lt is None:
        lt = layout_tensors(layout, pixels.device)
    pdtype = params["blocks"][0]["ln1"].dtype
    fh = layout.grid_thw[1] * cfg.patch_size
    fw = layout.grid_thw[2] * cfg.patch_size
    sh, sw = native_hw if native_hw else (fh, fw)
    # float pixels in the 0..255 domain take the normalize branch, as the
    # JAX function's _yuv_float does
    scaled_floats = False
    if (pixels.ndim == 2 and pixels.dtype == torch.uint8
            and pixels.shape[1] == sh * sw * 3 // 2):
        pixels = _yuv420_to_rgb(pixels, sh, sw)
        scaled_floats = True
    if pixels.ndim == 4 and pixels.shape[2:] != (fh, fw):
        if pixels.dtype == torch.uint8:
            scaled_floats = True
        pixels = torch.clamp(lanczos3_resize(pixels, (fh, fw)), 0.0, 255.0)
    if pixels.ndim == 4:
        pixels = _patchify(pixels, cfg)
    if pixels.dtype == torch.uint8 or scaled_floats:
        # 0..255 patches: rescale + CLIP normalize on the device
        scale, bias = patch_norm_scale_bias(
            cfg.patch_size, cfg.temporal_patch_size, cfg.in_channels
        )
        pixels = pixels.float()
        with timing.host_wait():  # copies from pageable host memory
            scale = torch.as_tensor(scale, device=pixels.device)
            bias = torch.as_tensor(bias, device=pixels.device)
        pixels = pixels * scale + bias
    x = linear(pixels.to(pdtype), params["patch_embed"], act_quant=False)
    x = x[lt["perm"]]
    # the rotary tables in the activation dtype, once for all blocks
    lt = dict(lt, cos=lt["cos"].to(x.dtype), sin=lt["sin"].to(x.dtype))
    full = set(cfg.fullatt_block_indexes)
    for bi, bp in enumerate(params["blocks"]):
        x = vision_block(bp, x, lt, layout, cfg, full_attn=bi in full)
    # merger (HF Qwen2_5_VLPatchMerger): RMSNorm -> concat merge_unit
    # patches -> Linear -> GELU (f32) -> Linear
    mp = params["merger"]
    xm = _rms_norm(x, mp["ln_q"], cfg.rms_norm_eps)
    xm = xm.reshape(-1, cfg.spatial_merge_unit * cfg.hidden_size)
    # f32 product, f32 bias and GELU, as vision.py:709-710 of the JAX package
    h1 = qdot(xm, mp["w1"], act_quant=False) + mp["b1"].float()
    h1 = F.gelu(h1).to(x.dtype)
    out = linear(h1, mp["w2"], act_quant=False) + mp["b2"]
    return out[lt["inv_perm_units"]]
