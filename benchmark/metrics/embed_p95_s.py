"""embed_p95_s: the 95th percentile of the embedding calls' latency over
the window, a failed call counting as one that never returned."""

import math

import numpy as np


def read(run):
    lat = [c["t1"] - c["t0"] if c["ok"] else math.inf for c in run.calls]
    p95 = float(np.percentile(lat, 95))
    return p95 if math.isfinite(p95) else None
