"""Checks of the int8 vision kernels (B3, B4, B6) against their plain
versions, shared by `chip_smoke.py` and `tests/test_torch_cuda.py`.

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
