"""The program's own spans and counters in a traced run, for the readers
in ``benchmark/metrics/`` that read them.

The program keeps them in memory while a torch profiler records
(``pngloss_tpu_torch.tracing.records()``): spans with their request, parent
and ``time.perf_counter()`` start and end, the benchmark's clock for its
calls, and counters added to a request. A program without that record
gives nothing to read, and each reader then returns None.
"""

from __future__ import annotations

import bisect


class Request:
    """One request of the window: its root span, every span and counter
    that carries its id, and the call it ran in."""

    def __init__(self, root, call):
        self.root, self.call = root, call
        self.spans, self.counts = [], []

    def seconds(self, keep) -> float:
        """Seconds of the root's time that the spans whose name ``keep``
        accepts cover (their union, clipped to the root)."""
        t0, t1 = self.root.t0, self.root.t1
        return covered([(max(s.t0, t0), min(s.t1, t1)) for s in self.spans
                        if s is not self.root and keep(s.name)])

    def total(self, name: str) -> int:
        return sum(c.n for c in self.counts if c.name == name)


def requests(run) -> list[Request] | None:
    """The requests that started inside the window, from the first call's
    start to the last call's end, inside a call that returned its outputs;
    None where the program keeps no record."""
    try:
        from pngloss_tpu_torch import tracing

        rec = tracing.records()
    except (ImportError, AttributeError):
        return None
    calls = run.calls
    starts = [c["t0"] for c in calls]
    lo, hi = calls[0]["t0"], calls[-1]["t1"]
    by_id = {}
    for s in rec["spans"]:
        if s.parent is None and s.request == s.id and lo <= s.t0 <= hi:
            k = bisect.bisect_right(starts, s.t0) - 1
            if k >= 0 and s.t1 <= calls[k]["t1"] and calls[k]["ok"]:
                by_id[s.id] = Request(s, calls[k])
    for s in rec["spans"]:
        if s.request in by_id:
            by_id[s.request].spans.append(s)
    for c in rec["counts"]:
        if c.request in by_id:
            by_id[c.request].counts.append(c)
    return sorted(by_id.values(), key=lambda r: r.root.t0)


def covered(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


def is_ops(name: str) -> bool:
    return name.startswith("ops.")


def per_row(run, counter: str) -> float | None:
    """``counter`` over the ladder's real rows (``ladder.rows``), summed
    over the window's requests."""
    reqs = requests(run)
    if not reqs:
        return None
    rows = sum(r.total("ladder.rows") for r in reqs)
    return sum(r.total(counter) for r in reqs) / rows if rows else None
