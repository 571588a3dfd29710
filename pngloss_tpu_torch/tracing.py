"""Stage tracing and device traces for the port.

Counterpart of ``pngloss_tpu/tracing.py``:

  * ``stage(name)`` and ``snapshot()`` are ``pngloss_tpu.tracing``'s own
    (that module imports no JAX), so the port's pipeline and the JAX
    package write into one set of per-stage accumulators;
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
import time

from pngloss_tpu.tracing import snapshot, stage


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
