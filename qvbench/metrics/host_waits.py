"""Points a request's host waits for the card before its first token: the
program's "host_wait" spans outside its "decode" spans, per request
traced."""

from qvbench.spans import by_request, inside


def read(ctx):
    reqs = by_request(ctx)
    if not reqs or not any("host_wait" in r for r in reqs):
        return None
    n = sum(1 for r in reqs for w in r.get("host_wait", [])
            if not any(inside(w, d) for d in r.get("decode", [])))
    return n / len(reqs)
