"""Antialiased 3-lobe Lanczos resize on the device.

The port's counterpart of `jax.image.resize(x, shape, "lanczos3",
antialias=True)`, which the JAX package's vision tower runs on frames
decoded at the source size (quickvideo_tpu/models/qwen25_vl/vision.py:
629-642). That resize is separable: along each axis whose size changes it
multiplies by an (out, in) weight matrix, which
jax/_src/image/scale.py::compute_weight_mat defines as follows (kept here
step for step, in f32):

- inv = in / out, kernel_scale = max(inv, 1) (the kernel widens when
  downscaling, which is the antialias);
- sample_f = (arange(out) + 0.5) * inv - 0.5;
- w[o, i] = lanczos3(|sample_f[o] - i| / kernel_scale), where lanczos3(x)
  = 3 sin(pi x) sin(pi x / 3) / (pi^2 x^2), 1 for x <= 1e-3, 0 for x > 3;
- each row is divided by its sum, and set to zero where that sum is
  within 1000 f32 epsilons of zero;
- rows whose sample_f falls outside [-0.5, in - 0.5] are zero.

An axis whose size does not change is left alone, as jax.image.resize
skips it. The matrices are built once per (in, out, device) and the two
products run in f32 through torch.matmul: XLA runs them as plain dot
products too, so no kernel is written for them. TF32 must stay off (torch's
default) for the products to be f32.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

_WEIGHTS: Dict[Tuple[int, int, str], torch.Tensor] = {}


def _lanczos3(x: torch.Tensor) -> torch.Tensor:
    radius = 3.0
    y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
    den = torch.where(x != 0, (math.pi ** 2) * x ** 2, torch.ones_like(x))
    out = torch.where(x > 1e-3, y / den, torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(x), out)


def lanczos3_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) f32 resampling matrix on the CPU."""
    f32 = torch.float32
    inv = torch.tensor(1.0 / (n_out / n_in), dtype=f32)
    kernel_scale = torch.clamp(inv, min=1.0)
    sample_f = (torch.arange(n_out, dtype=f32) + 0.5) * inv - 0.5
    x = (sample_f[:, None] - torch.arange(n_in, dtype=f32)[None, :]).abs()
    w = _lanczos3(x / kernel_scale)
    total = w.sum(dim=1, keepdim=True)
    eps = 1000.0 * torch.finfo(f32).eps
    w = torch.where(
        total.abs() > eps,
        w / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(w),
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w))


def _weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    key = (n_in, n_out, str(device))
    w = _WEIGHTS.get(key)
    if w is None:
        w = _WEIGHTS[key] = lanczos3_weights(n_in, n_out).to(device)
    return w


def lanczos3_resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Resize the last two axes of `x` (..., H, W) to `out_hw`, in f32."""
    x = x.float()
    h, w = x.shape[-2:]
    oh, ow = out_hw
    if oh != h:
        x = torch.matmul(_weights(h, oh, x.device), x)
    if ow != w:
        x = torch.matmul(x, _weights(w, ow, x.device).t())
    return x
