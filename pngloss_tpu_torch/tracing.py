"""Stage tracing and device traces for the port.

Counterpart of ``pngloss_tpu/tracing.py``:

  * ``stage(name)`` accumulates wall time per stage into a process-wide
    trace (lock-protected: the pipeline's decode and encode pools run
    stages on worker threads), read back with ``snapshot()``. Both are the
    port's own copies of ``pngloss_tpu.tracing``'s, with their own
    accumulators: the port imports nothing of the JAX package;
  * ``device_trace(path)`` records a ``torch.profiler`` trace (CPU
    activity, and CUDA activity where CUDA is available) when a dump
    directory is given or ``PNGLOSS_PROFILE_DIR`` is set, and writes it
    there as a Chrome trace (``*.pt.trace.json``) on exit; a no-op
    otherwise. Like the JAX package's, the pipeline does not call it:
    wrap the calls to trace.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

_lock = threading.Lock()
_times: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def stage(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _times[name] += dt
            _counts[name] += 1


def snapshot(reset: bool = False) -> dict[str, dict[str, float]]:
    """Per-stage {'seconds', 'calls'} accumulated across all threads.
    Stage seconds are summed per thread, so pooled stages (host_encode on N
    workers) can total more than wall time — that is the intended reading:
    total CPU-seconds spent in the stage."""
    with _lock:
        out = {k: {"seconds": round(v, 6), "calls": _counts[k]}
               for k, v in _times.items()}
        if reset:
            _times.clear()
            _counts.clear()
    return out


@contextlib.contextmanager
def device_trace(path: str | None = None):
    """torch.profiler trace of the enclosed calls into ``path`` (default
    ``$PNGLOSS_PROFILE_DIR``); no-op unless a dump directory is set."""
    path = path or os.environ.get("PNGLOSS_PROFILE_DIR")
    if not path:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        path, f"pngloss_tpu_torch.{os.getpid()}.{time.time_ns()}"
              ".pt.trace.json"))


__all__ = ["device_trace", "snapshot", "stage"]
