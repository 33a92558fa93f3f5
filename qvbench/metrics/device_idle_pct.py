"""The share of the traced window in which no device operation ran (the
union of their intervals)."""


def read(ctx):
    w = ctx.trace.window_s
    return 100.0 * (1.0 - ctx.trace.busy_s / w) if w > 0 else None
