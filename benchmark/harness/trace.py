"""The traced run's device timeline, from a ``torch.profiler`` Chrome
trace: device operations (kernels, copies, sets), each kernel's grid, and
the host spans the benchmark opened with ``record_function`` (its own
``bench.window`` and ``bench.call``, the program's stages, the codec).

Times are in seconds from the start of ``bench.window``; everything is
clipped to the window.
"""

from __future__ import annotations

import json
import re

WINDOW = "bench.window"
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    def __init__(self, path: str, sms: int):
        with open(path) as fh:
            data = json.load(fh)
        events = data["traceEvents"] if isinstance(data, dict) else data
        win = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
        if len(win) != 1:
            raise ValueError(f"{len(win)} {WINDOW} spans in the trace")
        t0 = float(win[0]["ts"])
        self.window_s = float(win[0]["dur"]) * 1e-6
        self.sms = sms

        def clip(e):
            a = max(0.0, (float(e["ts"]) - t0) * 1e-6)
            b = min(self.window_s,
                    (float(e["ts"]) + float(e.get("dur", 0)) - t0) * 1e-6)
            return (a, b) if b > a else None

        self.ops, self.kernels, self.spans = [], [], []
        for e in events:
            cat = e.get("cat")
            if cat in _DEVICE or cat == "user_annotation":
                span = clip(e)
                if span is None:
                    continue
                name = short_name(e.get("name", ""))
                if cat == "user_annotation":
                    if e.get("name") != WINDOW:
                        self.spans.append((name, *span))
                    continue
                self.ops.append((name, *span))
                if cat == "kernel":
                    grid = (e.get("args") or {}).get("grid") or [1, 1, 1]
                    blocks = 1
                    for g in grid:
                        blocks *= int(g)
                    self.kernels.append((name, *span, blocks))

    def kernel_seconds(self, pattern: str) -> float:
        """Summed time of the kernels whose name matches ``pattern`` as a
        whole word (``ladder_kernel`` does not match
        ``row_ladder_kernel``)."""
        rx = re.compile(r"(?<!\w)" + pattern + r"(?!\w)")
        return sum(b - a for n, a, b, _ in self.kernels if rx.search(n))

    def busy_s(self, kernels_only: bool = False) -> float:
        src = self.kernels if kernels_only else self.ops
        return sum(b - a for a, b in union([(a, b) for _, a, b, *_ in src]))

    def sm_share(self) -> float:
        """Time-weighted share of the SMs that running kernels' blocks
        take over the window, one SM a block, at most every SM."""
        edges = []
        for _, a, b, blocks in self.kernels:
            edges += [(a, blocks), (b, -blocks)]
        edges.sort()
        used, last, area = 0, 0.0, 0.0
        for t, d in edges:
            area += min(used, self.sms) * (t - last)
            used, last = used + d, t
        return area / (self.sms * self.window_s)

    def idle_gaps(self) -> list[tuple[str, float, float]]:
        """The window's stretches with no kernel running, each named by
        the innermost host span open at its middle (``host`` where none
        is)."""
        gaps, last = [], 0.0
        for a, b in union([(a, b) for _, a, b, _ in self.kernels]):
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        if last < self.window_s:
            gaps.append((last, self.window_s))
        out = []
        for a, b in gaps:
            mid = (a + b) / 2
            open_ = [(s1 - s0, n) for n, s0, s1 in self.spans
                     if s0 <= mid <= s1]
            out.append((min(open_)[1] if open_ else "host", a, b))
        return out

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time
        summed by the host span that was open, 10 of each."""
        ops, idle = {}, {}
        for n, a, b, *_ in self.ops:
            ops[n] = ops.get(n, 0.0) + b - a
        for n, a, b in self.idle_gaps():
            idle[n] = idle.get(n, 0.0) + b - a
        top = lambda d: [[k, v] for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments:
    ``void (anonymous namespace)::image_kernel<3, false>(int const*, ...)``
    -> ``image_kernel<3, false>``; a long template's arguments as ``...``."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    name = name.strip()
    if len(name) > 80 and "<" in name:        # a library's template
        name = name[:name.index("<")] + "<...>"
    return name
