"""Host milliseconds the decode loop takes to enqueue one token's step:
the mean over the traced requests' "decode_step" spans (one a token after
the first) of each span outside the "host_wait" within it (the read of
the token)."""

from qvbench.spans import by_request, outside_waits


def read(ctx):
    reqs = by_request(ctx) or []
    steps = [outside_waits(s, r.get("host_wait", []))
             for r in reqs for s in r.get("decode_step", [])]
    return 1e3 * sum(steps) / len(steps) if steps else None
