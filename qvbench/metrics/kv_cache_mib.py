"""The retained KV cache of a request: the program's `kv_cache_bytes`
counter (retained slots times bytes a slot), mean over the requests
traced, in MiB."""


def read(ctx):
    if not ctx.requests:
        return None
    return sum(r.kv_bytes for r in ctx.requests) / len(ctx.requests) / 2**20
