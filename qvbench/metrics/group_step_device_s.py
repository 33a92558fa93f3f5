"""Device seconds a request spends in its group steps and their pruning:
the kernels launched inside the program's "prefill" spans, per request
traced."""


def read(ctx):
    if not ctx.requests:
        return None
    s = ctx.trace.kernel_seconds("prefill")
    return s / len(ctx.requests) if s > 0 else None
