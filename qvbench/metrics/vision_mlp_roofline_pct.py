"""Kernels B3 and B4's share of their roofline: the bound of the vision
QKV product (B3) and of the gate and up products (B4) at the tower's
widths and each launch's rows, over the device time of those kernels and
their row prologues. None where the run launched neither (a bf16 tower)."""

from qvbench.counts import vision_mlp_bounds_s

B3, B4, PROLOGUE = "gemm_bias_kernel", "gemm_silu_quant_kernel", "ln_quantize"


def read(ctx):
    tr = ctx.trace
    n3, n4 = tr.launches(B3), tr.launches(B4)
    t = tr.kernel_seconds("vision", names=(B3, B4, PROLOGUE))
    rows = ctx.mix.patches_per_group(ctx.spec)
    if not (n3 or n4) or t <= 0 or rows is None:
        return None
    b3, b4 = vision_mlp_bounds_s(ctx.spec, rows)
    return 100.0 * (n3 * b3 + n4 * b4) / t
