"""Kernels B2 and B5: block-diagonal vision attention.

The vision tower attends within contiguous equal spans of rows (windows in
the window blocks, frames in the full-attention blocks). Two entries, named
as the JAX package's:

- `block_diag_attention_2d` (B2) applies rotary to q and k inside the
  kernel. Replaces quickvideo_tpu/ops/vision_attention.py::_kernel2d
  (entry block_diag_attention_2d).
- `block_diag_attention` (B5) takes q and k already rotated (the head-major
  route of the tower), with an optional per-column validity vector.
  Replaces quickvideo_tpu/ops/vision_attention.py::_kernel (entry
  block_diag_attention).

On a CUDA tensor each launches its hand-written Hopper kernel
(csrc/vision_attention.cu, one template for both) and counts the launch in
its `.launches`; on a CPU tensor it runs its plain version
(`block_diag_attention_2d_plain`, `block_diag_attention_plain`). A CUDA
tensor the kernel does not take raises: there is no fallback. The layout is
the natural one, q/k/v (S, nh, hd) with any row stride and cos/sin (S, hd):
the TPU kernels' 128-lane head padding and (nh, S, hd) transposes do not
carry over.

`kernel_applicable` is the JAX package's tiling rule (copied; the tests pin
the copy). It decides only which route the tower takes, as in the JAX
package: the Hopper kernels themselves take any span that divides S.
"""

from __future__ import annotations

from typing import Optional

import torch

from quickvideo_tpu_torch import _build

HEAD_DIM = 80  # the kernels are compiled for this head dim
NEG = -1e30  # the JAX kernel's column penalty for invalid keys


def _spans_per_tile(nspan: int, span: int) -> int:
    """Largest spans-per-tile <= ~2048 rows such that the tile divides the
    sequence AND is sublane-aligned (tile rows % 8 == 0). Returns 0 when no
    packing satisfies both, or the span exceeds 1536 rows (the JAX package
    then takes its XLA path). Copy of the JAX package's rule."""
    if span > 1536:
        return 0
    for spt in range(max(1, 2048 // span), 0, -1):
        if nspan % spt == 0 and (spt * span) % 8 == 0:
            return spt
    if nspan % 2 == 0 and (2 * span) % 8 == 0:
        return 2
    return 0


def kernel_applicable(s_len: int, span: int, masked: bool = False) -> bool:
    """Would the JAX package's block-diagonal kernels tile this (sequence,
    span)? The masked variant also needs 128-row tiles. Copy of the JAX
    package's rule."""
    if s_len % span:
        return False
    spt = _spans_per_tile(s_len // span, span)
    if spt == 0:
        return False
    return not masked or (spt * span) % 128 == 0


def _check_rows(q: torch.Tensor, named) -> None:
    """Raise unless every tensor is bf16 (S, nh, 80) rows with packed heads,
    16-byte aligned, on q's device."""
    s_len, nh, _ = q.shape
    for name, t in named:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"vision kernel takes bf16, got {name} {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.shape != (s_len, nh, HEAD_DIM) or t.stride()[1:] != (HEAD_DIM, 1):
            raise ValueError(
                f"vision kernel needs (S, nh, {HEAD_DIM}) rows with packed "
                f"heads, got {name} {tuple(t.shape)} strides {t.stride()}"
            )
        if t.stride(0) % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name} rows are not 16-byte aligned")


# -- B2: rotary inside ---------------------------------------------------------


def apply_vision_rotary(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """x (S, nh, hd) -> x*cos + rotate_half(x)*sin, in f32, cast back to
    x's dtype. cos/sin: (S, hd). B2's rotary (the kernel rotates its staged
    tiles in f32)."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    out = xf * cos[:, None, :].float() + rot * sin[:, None, :].float()
    return out.to(x.dtype)


def block_diag_attention_2d_plain(
    q: torch.Tensor,  # (S, nh, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    cos: torch.Tensor,  # (S, hd)
    sin: torch.Tensor,
    span: int,
    scale: float,
) -> torch.Tensor:
    """Rotary on q and k (rounded to the input dtype, as the kernel rounds
    its staged tiles), then f32 attention within each contiguous `span`.
    Returns (S, nh, hd) in q's dtype."""
    s_len, nh, hd = q.shape
    qr = apply_vision_rotary(q, cos, sin).float()
    kr = apply_vision_rotary(k, cos, sin).float()
    n = s_len // span
    qb = qr.reshape(n, span, nh, hd)
    kb = kr.reshape(n, span, nh, hd)
    vb = v.float().reshape(n, span, nh, hd)
    sc = torch.einsum("blhd,bmhd->bhlm", qb, kb) * scale
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhlm,bmhd->blhd", p, vb)
    return out.reshape(s_len, nh, hd).to(q.dtype)


def block_diag_attention_2d(
    q: torch.Tensor,  # (S, nh, hd), last dim contiguous, any row stride
    k: torch.Tensor,
    v: torch.Tensor,
    cos: torch.Tensor,  # (S, hd) f32
    sin: torch.Tensor,
    span: int,
    scale: float,
    out: Optional[torch.Tensor] = None,  # (S, nh, hd) to write into
) -> torch.Tensor:
    """Block-diagonal attention over contiguous equal `span`s with rotary
    applied to q and k inside. Returns `out` (allocated when None)."""
    s_len, nh, hd = q.shape
    if span <= 0 or s_len % span:
        raise ValueError(f"sequence {s_len} is not a multiple of span {span}")
    if out is None:
        out = torch.empty(s_len, nh, hd, dtype=q.dtype, device=q.device)
    if q.device.type == "cpu":
        out.copy_(block_diag_attention_2d_plain(q, k, v, cos, sin, span,
                                                scale))
        return out
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_rows(q, (("q", q), ("k", k), ("v", v), ("out", out)))
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or t.shape != (s_len, HEAD_DIM):
            raise ValueError(f"{name} must be (S, {HEAD_DIM}) f32")
        if t.stride() != cos.stride() or t.stride(1) != 1:
            raise ValueError("cos and sin must share one row-major layout")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    lib = _build.library()
    err = lib.qv_vision_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        cos.data_ptr(), sin.data_ptr(),
        q.stride(0), k.stride(0), v.stride(0), out.stride(0), cos.stride(0),
        s_len, nh, span, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "qv_vision_attention")
    block_diag_attention_2d.launches += 1
    return out


block_diag_attention_2d.launches = 0


# -- B5: rotary outside, optional column validity -----------------------------


def block_diag_attention_plain(
    q: torch.Tensor,  # (S, nh, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    span: int,
    scale: float,
    valid: Optional[torch.Tensor] = None,  # (S,) bool
) -> torch.Tensor:
    """softmax(q k^T * scale + penalty) v within each contiguous `span`, at
    the JAX kernel's rounding points (vision_attention.py:59-99): f32
    scores times scale, -1e30 on invalid key columns, f32 softmax with the
    denominator floored at 1e-30, p rounded to v's dtype, PV accumulated in
    f32 and cast to q's dtype. A row whose span holds no valid key is 0 (the
    JAX kernel leaves it unspecified; its caller drops it)."""
    s_len, nh, hd = q.shape
    n = s_len // span
    qb = q.float().reshape(n, span, nh, hd)
    kb = k.float().reshape(n, span, nh, hd)
    vb = v.float().reshape(n, span, nh, hd)
    sc = torch.einsum("blhd,bmhd->bhlm", qb, kb) * scale
    if valid is not None:
        vb_mask = valid.reshape(n, span)
        pen = torch.where(vb_mask, 0.0, NEG).to(torch.float32)
        sc = sc + pen[:, None, None, :]
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    p = p.to(v.dtype).float()
    out = torch.einsum("bhlm,bmhd->blhd", p, vb)
    if valid is not None:
        out = out * vb_mask.any(dim=1).to(out.dtype)[:, None, None, None]
    return out.reshape(s_len, nh, hd).to(q.dtype)


def block_diag_attention(
    q: torch.Tensor,  # (S, nh, hd), last dim contiguous, any row stride
    k: torch.Tensor,
    v: torch.Tensor,
    span: int,
    *,
    scale: float,
    valid: Optional[torch.Tensor] = None,  # (S,) bool: False = padded key
    out: Optional[torch.Tensor] = None,  # (S, nh, hd) to write into
) -> torch.Tensor:
    """Block-diagonal attention over contiguous equal `span`s, q and k
    already rotated. Returns `out` (allocated when None) in q's dtype."""
    s_len, nh, hd = q.shape
    if span <= 0 or s_len % span:
        raise ValueError(f"seq {s_len} not a multiple of span {span}")
    if out is None:
        out = torch.empty(s_len, nh, hd, dtype=q.dtype, device=q.device)
    if q.device.type == "cpu":
        out.copy_(block_diag_attention_plain(q, k, v, span, scale, valid))
        return out
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_rows(q, (("q", q), ("k", k), ("v", v), ("out", out)))
    valid_ptr = None
    if valid is not None:
        if (valid.dtype != torch.bool or valid.shape != (s_len,)
                or valid.device != q.device):
            raise ValueError(f"valid must be ({s_len},) bool on {q.device}")
        valid = valid.contiguous()
        valid_ptr = valid.data_ptr()
    lib = _build.library()
    err = lib.qv_block_diag_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), valid_ptr,
        q.stride(0), k.stride(0), v.stride(0), out.stride(0),
        s_len, nh, span, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "qv_block_diag_attention")
    block_diag_attention.launches += 1
    return out


block_diag_attention.launches = 0
