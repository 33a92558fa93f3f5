"""The share of the program's "decode" spans' wall in which a device
operation ran."""


def read(ctx):
    busy, wall = ctx.trace.busy_within("decode")
    return 100.0 * busy / wall if wall > 0 else None
