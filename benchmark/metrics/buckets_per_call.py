"""buckets_per_call: the shape buckets a request dispatched, the
program's ``pipeline.buckets`` counter (one launch sequence and one stream
slot each) over the window's requests of calls that returned
(``harness.spans``); None where the program keeps no such counter."""

from benchmark.harness import spans


def read(run):
    reqs = spans.requests(run)
    if not reqs:
        return None
    counts = [c.n for r in reqs for c in r.counts
              if c.name == "pipeline.buckets"]
    return sum(counts) / len(reqs) if counts else None
