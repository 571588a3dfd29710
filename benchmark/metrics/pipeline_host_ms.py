"""pipeline_host_ms: the median request's milliseconds outside the
``ops.*`` spans and ``device_fetch`` (the wait for the card): reduce,
pack, gather, restore and what no span names, on the program's own spans
(``harness.spans``)."""

import statistics

from benchmark.harness import spans


def read(run):
    reqs = spans.requests(run)
    if not reqs:
        return None
    return 1e3 * statistics.median(
        r.root.t1 - r.root.t0 - r.seconds(
            lambda n: spans.is_ops(n) or n == "device_fetch")
        for r in reqs)
