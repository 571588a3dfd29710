"""report_s_per_mp: the suite runner's own ``suite.report`` span seconds
(per job, after the card: the input's and the output's decode, their
PSNR) per input megapixel, over the window's requests of calls that
returned (``harness.spans``); None where the program has no such span."""

from benchmark.harness import spans


def read(run):
    reqs = spans.requests(run)
    if not reqs:
        return None
    report = [s.t1 - s.t0 for r in reqs for s in r.spans
              if s.name == "suite.report"]
    mp = sum(r.call["mp"] for r in reqs)
    return sum(report) / mp if report and mp else None
