"""Host milliseconds a request spends launching its final prefill: its
"final_prefill" spans outside the "host_wait" spans within them, per
request traced."""

from qvbench.spans import by_request, outside_waits


def read(ctx):
    reqs = by_request(ctx)
    if not reqs or not any("final_prefill" in r for r in reqs):
        return None
    s = sum(outside_waits(f, r.get("host_wait", []))
            for r in reqs for f in r.get("final_prefill", []))
    return 1e3 * s / len(reqs)
