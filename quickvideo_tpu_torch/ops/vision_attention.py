"""Kernels B2 and B5: block-diagonal vision attention, and the vision
rotary pass.

The vision tower attends within contiguous equal spans of rows (windows in
the window blocks, frames in the full-attention blocks). Two entries, named
as the JAX package's:

- `block_diag_attention_2d` (B2) applies rotary to q and k inside.
  Replaces quickvideo_tpu/ops/vision_attention.py::_kernel2d (entry
  block_diag_attention_2d).
- `block_diag_attention` (B5) takes q and k already rotated (the head-major
  route of the tower), with an optional per-column validity vector.
  Replaces quickvideo_tpu/ops/vision_attention.py::_kernel (entry
  block_diag_attention).

and the rotary pass `vision_rotary`, which rotates q and k once into new
tensors (the head-major route's rotary, and B2's on spans above
SHORT_SPAN rows).

Rotary follows the JAX package's rounding points: cos/sin are cast to the
activation dtype, each product is rounded to it, then their sum
(`apply_vision_rotary`; in bf16 bit-equal to the JAX package's
`_apply_vision_rotary` on the CPU, which rounds after every operation).
B2's plain version is the rotary's plain version followed by B5's, so one
plain core, at the JAX kernel's rounding points, serves both kernels.

On a CUDA tensor each entry launches its hand-written Hopper kernel
(csrc/vision_attention.cu) and counts the launch in its `.launches`; on a
CPU tensor it runs its plain version (`block_diag_attention_2d_plain`,
`block_diag_attention_plain`, `vision_rotary_plain`). A CUDA tensor the
kernel does not take raises: there is no fallback. The kernel is chosen by
span and nothing else: spans of at most SHORT_SPAN rows run the short-span
kernel (B2 rotates inside it, each row once), longer spans the wgmma
long-span kernel (B2 runs the rotary pass into a scratch buffer first).
No entry writes to its inputs. The layout is the natural one, q/k/v (S, nh,
hd) with any row stride and cos/sin (S, hd): the TPU kernels' 128-lane
head padding and (nh, S, hd) transposes do not carry over.

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


def _check_tables(q: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """cos/sin cast to q's dtype (the JAX package's rounding point; a no-op
    when they already are); raise unless they are (S, 80) rows of one
    layout, 16-byte aligned, on q's device."""
    s_len = q.shape[0]
    cos, sin = cos.to(q.dtype), sin.to(q.dtype)
    for name, t in (("cos", cos), ("sin", sin)):
        if t.shape != (s_len, HEAD_DIM) or t.stride(1) != 1:
            raise ValueError(f"{name} must be (S, {HEAD_DIM}) rows")
        if t.stride() != cos.stride():
            raise ValueError("cos and sin must share one row layout")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.stride(0) % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name} rows are not 16-byte aligned")
    return cos, sin


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# -- the rotary pass -------------------------------------------------------------


def apply_vision_rotary(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """x (S, nh, hd) -> x*cos + rotate_half(x)*sin in x's dtype, cos/sin
    (S, hd) cast to it first: the JAX package's `_apply_vision_rotary`
    (vision.py:231-241) at its rounding points (each product, then the
    sum, rounded to x's dtype, as eager PyTorch and XLA both round)."""
    c = cos.to(x.dtype)[:, None, :]
    s = sin.to(x.dtype)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return x * c + torch.cat([-x2, x1], dim=-1) * s


def vision_rotary_plain(q, k, cos, sin):
    """(rotary(q), rotary(k)): the rotary pass's plain version."""
    return apply_vision_rotary(q, cos, sin), apply_vision_rotary(k, cos, sin)


def vision_rotary(
    q: torch.Tensor,  # (S, nh, hd), last dim contiguous, any row stride
    k: torch.Tensor,
    cos: torch.Tensor,  # (S, hd)
    sin: torch.Tensor,
):
    """q and k rotated once, into new (S, nh, hd) tensors (q and k are not
    written). Returns (q_rotated, k_rotated)."""
    if q.device.type == "cpu":
        return vision_rotary_plain(q, k, cos, sin)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_rows(q, (("q", q), ("k", k)))
    cos, sin = _check_tables(q, cos, sin)
    s_len, nh, hd = q.shape
    out = torch.empty(2, s_len, nh, hd, dtype=q.dtype, device=q.device)
    if s_len == 0:
        return out[0], out[1]
    err = _build.library().qv_vision_rotary(
        q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), q.stride(0), k.stride(0),
        cos.stride(0), out.stride(1), out.stride(1), s_len, nh, _stream(q),
    )
    _build.check(err, "qv_vision_rotary")
    vision_rotary.launches += 1
    return out[0], out[1]


vision_rotary.launches = 0


# -- B2: rotary inside ---------------------------------------------------------

SHORT_SPAN = 64  # spans up to this many rows run the short-span kernel


def block_diag_attention_2d_plain(
    q: torch.Tensor,  # (S, nh, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    cos: torch.Tensor,  # (S, hd)
    sin: torch.Tensor,
    span: int,
    scale: float,
) -> torch.Tensor:
    """The rotary pass's plain version on q and k, then B5's plain version:
    the JAX kernel's rotary (tables in the activation dtype) and attention
    rounding points. Returns (S, nh, hd) in q's dtype."""
    qr, kr = vision_rotary_plain(q, k, cos, sin)
    return block_diag_attention_plain(qr, kr, v, span, scale)


def block_diag_attention_2d(
    q: torch.Tensor,  # (S, nh, hd), last dim contiguous, any row stride
    k: torch.Tensor,
    v: torch.Tensor,
    cos: torch.Tensor,  # (S, hd), cast to q's dtype
    sin: torch.Tensor,
    span: int,
    scale: float,
    out: Optional[torch.Tensor] = None,  # (S, nh, hd) to write into
) -> torch.Tensor:
    """Block-diagonal attention over contiguous equal `span`s with rotary
    applied to q and k, each row once. Returns `out` (allocated when
    None)."""
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
    cos, sin = _check_tables(q, cos, sin)
    if s_len == 0:
        return out
    lib = _build.library()
    if span <= SHORT_SPAN:
        err = lib.qv_vision_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            cos.data_ptr(), sin.data_ptr(),
            q.stride(0), k.stride(0), v.stride(0), out.stride(0),
            cos.stride(0), s_len, nh, span, float(scale), _stream(q),
        )
        _build.check(err, "qv_vision_attention")
    else:
        qr, kr = vision_rotary(q, k, cos, sin)
        err = lib.qv_block_diag_attention(
            qr.data_ptr(), kr.data_ptr(), v.data_ptr(), out.data_ptr(), None,
            qr.stride(0), kr.stride(0), v.stride(0), out.stride(0),
            s_len, nh, span, float(scale), _stream(q),
        )
        _build.check(err, "qv_block_diag_attention")
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
    already rotated. Returns `out` (allocated when None) in q's dtype. The
    C entry runs the short-span kernel up to SHORT_SPAN rows, else the
    long-span one."""
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
    if s_len == 0:
        return out
    err = _build.library().qv_block_diag_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), valid_ptr,
        q.stride(0), k.stride(0), v.stride(0), out.stride(0),
        s_len, nh, span, float(scale), _stream(q),
    )
    _build.check(err, "qv_block_diag_attention")
    block_diag_attention.launches += 1
    return out


block_diag_attention.launches = 0
