"""encode_s_per_mp: the program's own ``host_encode`` span seconds (the
PNG encode, on any thread) per input megapixel, over the window's
requests of calls that returned (``harness.spans``)."""

from benchmark.harness import spans


def read(run):
    reqs = spans.requests(run)
    if not reqs:
        return None
    enc = sum(s.t1 - s.t0 for r in reqs for s in r.spans
              if s.name == "host_encode")
    mp = sum(r.call["mp"] for r in reqs)
    return enc / mp if mp else None
