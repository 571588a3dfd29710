"""ops_host_ms: the median request's milliseconds in the optimizer's
host steps, the ``ops.*`` spans (upload, prepare, hist, row 0, image:
uploads, the memory query and the kernels' launches), on the program's
own spans (``harness.spans``)."""

import statistics

from benchmark.harness import spans


def read(run):
    reqs = spans.requests(run)
    if not reqs:
        return None
    return 1e3 * statistics.median(r.seconds(spans.is_ops) for r in reqs)
