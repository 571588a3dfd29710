"""embed_host_ms: the median embedding call's host milliseconds: its wall
time less its device_fetch stage seconds (reduce, pack, upload, launch
and restore)."""

import statistics


def read(run):
    host = [c["t1"] - c["t0"] - c["stages"].get("device_fetch", 0.0)
            for c in run.calls if c["ok"]]
    return statistics.median(host) * 1e3 if host else None
