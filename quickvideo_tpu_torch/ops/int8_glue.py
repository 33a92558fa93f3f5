"""The language model's int8 glue around `torch._int_mm`: the passes
between one act-quantized product and the next, one kernel each.

The decoder's int8 products (ops/quantization.py) quantize their input per
row, multiply s8 x s8 -> s32 in `torch._int_mm`, and rescale the s32 result
to the model dtype. In plain PyTorch the glue around each product is a
dozen full-tensor f32 passes; these entries run it in one pass each
(csrc/int8_glue.cu, which replaces no TPU kernel: the JAX package left the
products and their glue to XLA):

  rms_quantize(x, ln_w, eps)   rms_norm, then quantize_act: the int8 rows
      and their scales of the q/k/v and gate/up products' input
  quantize_rows(x)             quantize_act: the attention output ahead of
      the o-projection
  rescale(acc, xs, sc, bias=None, residual=None)
                               (acc * xs) * sc rounded to bf16, then
      + bias (q/k/v) or residual + (o and down projections), each rounded
  swiglu_quantize(g, u, xs, sc_g, sc_u)
                               gate and up rescaled and rounded, silu(g) *
      u as torch's bf16 ops round it, then quantize_act: the down
      projection's int8 input

Each entry runs its plain version (`*_plain`: the op sequence the language
model ran before these kernels, so a CPU tensor gives the same bits) on a
CPU tensor, and on a CUDA tensor launches its kernel, counts the launch in
`<entry>.launches`, and raises on an input the kernel does not take: there
is no fallback. No entry reads anything back to the host.

`chain_applies` is the route rule models/qwen25_vl/language.py follows.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from quickvideo_tpu_torch import _build
from quickvideo_tpu_torch.ops.quantization import (
    act_gate,
    is_quantized,
    quantize_act,
)

MAX_ROW_WIDTH = 8192  # the row quantize holds a row in registers (the 72B)
SMEM_MAX = 232_448  # shared memory one block can opt into on sm_90


def chain_applies(x: torch.Tensor, ws: Sequence, min_rows: Optional[int],
                  tp=None) -> bool:
    """Whether the products of the weights `ws` on x's rows take the chain:
    every weight quantized, no tp group, the act-quant gate passing on x,
    and rows the kernels take on a card (bf16; the CPU runs the plain
    versions in any dtype). Under tp the row-parallel products (wo, wd)
    quantize with the max over the ranks' slices of a row and sum f32
    partials before rounding, which a fused requantize cannot see; the
    layer then keeps its plain route whole."""
    return (tp is None and x.ndim == 2
            and all(is_quantized(w) for w in ws)
            and (x.device.type == "cpu" or x.dtype == torch.bfloat16)
            and act_gate(x.shape[0], x.shape[1], min_rows))


# -- plain versions ----------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """The language model's RMSNorm: f32 mean of squares, rsqrt, rounded to
    x's dtype, times w."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rms_quantize_plain(x: torch.Tensor, ln_w: torch.Tensor, eps: float):
    return quantize_act(rms_norm(x, ln_w, eps))


def quantize_rows_plain(x: torch.Tensor):
    return quantize_act(x)


def rescale_plain(acc: torch.Tensor, xs: torch.Tensor, sc: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  residual: Optional[torch.Tensor] = None,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """qdot_pre's (acc * xs) * sc, linear's cast to `dtype`, then the bias
    add and the residual add."""
    y = (acc.float() * xs * sc).to(dtype)
    if bias is not None:
        y = y + bias
    if residual is not None:
        y = residual + y
    return y


def swiglu_quantize_plain(g: torch.Tensor, u: torch.Tensor, xs: torch.Tensor,
                          sc_g: torch.Tensor, sc_u: torch.Tensor,
                          dtype=torch.bfloat16):
    gb = rescale_plain(g, xs, sc_g, dtype=dtype)
    ub = rescale_plain(u, xs, sc_u, dtype=dtype)
    return quantize_act(F.silu(gb) * ub)


# -- kernel launches ---------------------------------------------------------


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _matrix(name: str, t: torch.Tensor, dtype, dev, vec: int) -> int:
    """The row stride of a 2-D view whose rows the kernels read `vec`
    elements (16 or 8 bytes) at a time; raises on any other view."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    if t.ndim != 2 or (t.shape[1] > 1 and t.stride(1) != 1):
        raise ValueError(f"{name} must be 2-D with unit column stride, got "
                         f"{tuple(t.shape)} strides {t.stride()}")
    if t.shape[1] % vec or t.stride(0) % vec or (
            t.data_ptr() % (vec * t.element_size())):
        raise ValueError(
            f"{name} needs columns and a row stride that are multiples of "
            f"{vec} and aligned rows, got {tuple(t.shape)} strides "
            f"{t.stride()}"
        )
    return t.stride(0)


def _vector(name: str, t: torch.Tensor, dtype, n: int, dev) -> torch.Tensor:
    if t.dtype != dtype or t.numel() != n or not t.is_contiguous():
        raise ValueError(f"{name} must be ({n},) contiguous {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    # read 8 or 16 bytes at a time
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def _row_outputs(m: int, c: int, dev):
    return (torch.empty(m, c, dtype=torch.int8, device=dev),
            torch.empty(m, 1, dtype=torch.float32, device=dev))


def _check_row_width(c: int):
    if c <= 0 or c > MAX_ROW_WIDTH:
        raise ValueError(f"the row quantize takes 0 < C <= {MAX_ROW_WIDTH}, "
                         f"got {c}")


def rms_quantize(x: torch.Tensor, ln_w: torch.Tensor, eps: float):
    """rms_norm(x, ln_w, eps) quantized per row: (xq (M, C) int8, xs (M, 1)
    f32). x (M, C) bf16, C a multiple of 8 up to 8,192; ln_w (C,) bf16."""
    if not _on_card(x):
        return rms_quantize_plain(x, ln_w, eps)
    dev = x.device
    ld = _matrix("x", x, torch.bfloat16, dev, 8)
    m, c = x.shape
    _check_row_width(c)
    ln_w = _vector("ln_w", ln_w, torch.bfloat16, c, dev)
    xq, xs = _row_outputs(m, c, dev)
    if m:
        _build.check(_build.library().qv_rms_quantize(
            x.data_ptr(), ld, ln_w.data_ptr(), xq.data_ptr(), xs.data_ptr(),
            m, c, float(eps), _stream(dev),
        ), "qv_rms_quantize")
        rms_quantize.launches += 1
    return xq, xs


def quantize_rows(x: torch.Tensor):
    """quantize_act(x): (xq (M, C) int8, xs (M, 1) f32). x (M, C) bf16, C a
    multiple of 8 up to 8,192."""
    if not _on_card(x):
        return quantize_rows_plain(x)
    dev = x.device
    ld = _matrix("x", x, torch.bfloat16, dev, 8)
    m, c = x.shape
    _check_row_width(c)
    xq, xs = _row_outputs(m, c, dev)
    if m:
        _build.check(_build.library().qv_quantize_rows(
            x.data_ptr(), ld, xq.data_ptr(), xs.data_ptr(), m, c,
            _stream(dev),
        ), "qv_quantize_rows")
        quantize_rows.launches += 1
    return xq, xs


def rescale(acc: torch.Tensor, xs: torch.Tensor, sc: torch.Tensor,
            bias: Optional[torch.Tensor] = None,
            residual: Optional[torch.Tensor] = None,
            dtype=torch.bfloat16) -> torch.Tensor:
    """bf16((acc * xs) * sc), then + bias and residual + where given, each
    rounded: (M, N) in `dtype` (bf16 on a card). acc (M, N) int32 (a row
    slice of a padded product too: any row stride that is a multiple of
    4), xs (M, 1) f32, sc (N,) f32, bias (N,), residual (M, N)."""
    if not _on_card(acc):
        return rescale_plain(acc, xs, sc, bias, residual, dtype)
    dev = acc.device
    if dtype != torch.bfloat16:
        raise TypeError(f"the rescale kernel returns bf16, asked {dtype}")
    lda = _matrix("acc", acc, torch.int32, dev, 4)
    m, n = acc.shape
    xs = _vector("xs", xs, torch.float32, m, dev)
    sc = _vector("sc", sc, torch.float32, n, dev)
    if bias is not None:
        bias = _vector("bias", bias, torch.bfloat16, n, dev)
    ldr = 0
    if residual is not None:
        ldr = _matrix("residual", residual, torch.bfloat16, dev, 4)
        if residual.shape != acc.shape:
            raise ValueError(f"residual {tuple(residual.shape)} against acc "
                             f"{tuple(acc.shape)}")
    out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
    if m:
        _build.check(_build.library().qv_rescale(
            acc.data_ptr(), lda, xs.data_ptr(), sc.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if residual is None else residual.data_ptr(), ldr,
            out.data_ptr(), m, n, _stream(dev),
        ), "qv_rescale")
        rescale.launches += 1
    return out


def swiglu_quantize(g: torch.Tensor, u: torch.Tensor, xs: torch.Tensor,
                    sc_g: torch.Tensor, sc_u: torch.Tensor,
                    dtype=torch.bfloat16):
    """silu(g) * u of the rescaled, rounded gate and up products, quantized
    per row: (mq (M, I) int8, ms (M, 1) f32). g, u (M, I) int32 (I a
    multiple of 4, its bf16 row within shared memory), xs (M, 1) f32,
    sc_g, sc_u (I,) f32; `dtype` the rounding of g, u and the product (bf16
    on a card)."""
    if not _on_card(g):
        return swiglu_quantize_plain(g, u, xs, sc_g, sc_u, dtype)
    dev = g.device
    if dtype != torch.bfloat16:
        raise TypeError(f"the SwiGLU kernel rounds to bf16, asked {dtype}")
    ldg = _matrix("g", g, torch.int32, dev, 4)
    ldu = _matrix("u", u, torch.int32, dev, 4)
    if u.shape != g.shape:
        raise ValueError(f"u {tuple(u.shape)} against g {tuple(g.shape)}")
    m, n = g.shape
    if n <= 0 or 2 * n > SMEM_MAX - 1024:
        raise ValueError(f"the SwiGLU kernel holds a row of I bf16 in shared "
                         f"memory: 0 < I <= {(SMEM_MAX - 1024) // 2}, got {n}")
    xs = _vector("xs", xs, torch.float32, m, dev)
    sc_g = _vector("sc_g", sc_g, torch.float32, n, dev)
    sc_u = _vector("sc_u", sc_u, torch.float32, n, dev)
    mq, ms = _row_outputs(m, n, dev)
    if m:
        _build.check(_build.library().qv_swiglu_quantize(
            g.data_ptr(), ldg, u.data_ptr(), ldu, xs.data_ptr(),
            sc_g.data_ptr(), sc_u.data_ptr(), mq.data_ptr(), ms.data_ptr(),
            m, n, _stream(dev),
        ), "qv_swiglu_quantize")
        swiglu_quantize.launches += 1
    return mq, ms


rms_quantize.launches = 0
quantize_rows.launches = 0
rescale.launches = 0
swiglu_quantize.launches = 0
