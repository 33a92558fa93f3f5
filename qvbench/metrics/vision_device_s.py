"""Device seconds a request spends in the vision tower: the kernels
launched inside the program's "vision" spans, per request traced."""


def read(ctx):
    if not ctx.requests:
        return None
    s = ctx.trace.kernel_seconds("vision")
    return s / len(ctx.requests) if s > 0 else None
