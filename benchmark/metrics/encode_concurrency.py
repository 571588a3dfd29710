"""encode_concurrency: the mean number of PNG encodes in flight while any
is in flight: the program's own ``host_encode`` span seconds (on any
thread) over the seconds that their union covers, over the window's
requests of calls that returned (``harness.spans``). 1.0 where a call's
encodes run one after another."""

from benchmark.harness import spans


def _is_encode(name: str) -> bool:
    return name == "host_encode"


def read(run):
    reqs = spans.requests(run)
    if not reqs:
        return None
    busy = sum(s.t1 - s.t0 for r in reqs for s in r.spans
               if _is_encode(s.name))
    covered = sum(r.seconds(_is_encode) for r in reqs)
    return busy / covered if covered else None
