"""The whole request's share of the card's peak: the model's operations
for every request traced (the family's `request_ops`, for Qwen2.5-VL
qvbench/counts.py, each product at the peak of the precision the
configuration states for it) over the traced window."""

from qvbench.roofline import peak_seconds


def read(ctx):
    if not ctx.requests or ctx.trace.window_s <= 0:
        return None
    need = sum(peak_seconds(ctx.family.request_ops(
        ctx.spec, ctx.mix, r.question, len(r.tokens)))
               for r in ctx.requests)
    return 100.0 * need / ctx.trace.window_s
