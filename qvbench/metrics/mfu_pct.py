"""The whole request's share of the card's peak: the model's operations
for every request traced (qvbench/counts.py::request_ops, each product at
the peak of the precision the configuration states for it) over the
traced window."""

from qvbench.counts import peak_seconds, request_ops


def read(ctx):
    if not ctx.requests or ctx.trace.window_s <= 0:
        return None
    need = sum(peak_seconds(request_ops(ctx.spec, ctx.mix, r.question,
                                        len(r.tokens)))
               for r in ctx.requests)
    return 100.0 * need / ctx.trace.window_s
