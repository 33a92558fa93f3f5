"""Host seconds a request's group loop waits for its next pixel group: the
program's "frame_wait" spans (the stream's decode and upload threads
behind the loop), per request traced."""

from qvbench.spans import by_request, seconds


def read(ctx):
    reqs = by_request(ctx)
    if not reqs or not any("frame_wait" in r for r in reqs):
        return None
    return sum(seconds(r.get("frame_wait", [])) for r in reqs) / len(reqs)
