"""Kernel B1's share of its roofline in the group steps: the benchmark's
own bound of every group step's attention (G rows over the retained past,
per layer; the family's `b1_group_bound_s`, for Qwen2.5-VL
qvbench/counts.py, flash_bound) over the device time of the `flash_`
kernels launched inside the "prefill" spans. None where the family has no
such bound."""


def read(ctx):
    b1_group_bound_s = getattr(ctx.family, "b1_group_bound_s", None)
    t = ctx.trace.kernel_seconds("prefill", names=("flash_",))
    if b1_group_bound_s is None or t <= 0 or not ctx.requests:
        return None
    b = sum(b1_group_bound_s(ctx.spec, ctx.mix, r.question, ctx.kv_variant)
            for r in ctx.requests)
    return 100.0 * b / t
