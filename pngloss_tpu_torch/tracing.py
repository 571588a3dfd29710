"""Stage tracing, spans and device traces for the port.

Counterpart of ``pngloss_tpu/tracing.py``:

  * ``stage(name)`` accumulates wall time per stage into a process-wide
    trace (lock-protected: the pipeline's decode and encode pools run
    stages on worker threads), read back with ``snapshot()``. Both are the
    port's own copies of ``pngloss_tpu.tracing``'s, with their own
    accumulators: the port imports nothing of the JAX package;
  * while tracing is on (``on()``: a ``torch.profiler`` records in this
    process, as inside ``device_trace`` or a benchmark's traced window),
    every stage is also a span: it opens a ``record_function`` of its
    name, so it sits in the profiler's trace beside the kernels (the
    profiler shows those of the thread that started it), and it is
    kept in memory (``records()``) with its ``time.perf_counter()`` start
    and end, its thread, its parent (the innermost span open in the same
    context, ``contextvars``) and its request. ``request(name)`` is a stage
    that starts a request where none is open (a public entry point; nested
    entry points are plain child spans), ``count(name, n)`` adds a counter
    to the open request, and ``carry(fn)`` runs ``fn`` on a pool thread
    inside the caller's open span. While tracing is off a stage costs its
    accumulator and one look at the profiler's flag: no
    ``record_function``, no record;
  * ``device_counts()`` collects counters that live on the card (the
    ladder's attempts and rounds) for the dispatch to copy back with its
    outputs and ``count`` when they land, so counting waits for nothing;
  * ``device_trace(path)`` records a ``torch.profiler`` trace (CPU
    activity, and CUDA activity where CUDA is available) when a dump
    directory is given or ``PNGLOSS_PROFILE_DIR`` is set, and writes it
    there as a Chrome trace (``*.pt.trace.json``) on exit; a no-op
    otherwise. ``cli.run`` runs under it.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import os
import sys
import threading
import time
from collections import defaultdict
from typing import NamedTuple

_lock = threading.Lock()
_times: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)

# the most spans, and the most counters, kept in memory; older ones are
# dropped first and counted in records()["dropped"]
RECORD_LIMIT = 1 << 20


class Span(NamedTuple):
    """A stage run while tracing was on. ``request`` is the id of the
    request's root span (None outside any request); ``parent`` the id of
    the span open around it (None for a root)."""
    id: int
    parent: int | None
    request: int | None
    name: str
    t0: float                   # time.perf_counter()
    t1: float
    thread: int


class Count(NamedTuple):
    """``n`` added to counter ``name`` of ``request`` at ``t``."""
    request: int | None
    name: str
    n: int
    t: float


_spans: collections.deque = collections.deque()
_tallies: collections.deque = collections.deque()
_dropped = 0
_ids = itertools.count(1)
# (span id, request id) of the innermost open span
_open: contextvars.ContextVar = contextvars.ContextVar(
    "pngloss_tpu_torch.tracing.open", default=None)
# the device counters of the dispatch open around this context
_device: contextvars.ContextVar = contextvars.ContextVar(
    "pngloss_tpu_torch.tracing.device", default=None)


def on() -> bool:
    """Whether tracing is on: a torch profiler records in this process
    (no profiler can run before torch is imported)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def _keep(store: collections.deque, item) -> None:
    """Appends ``item``, dropping the oldest past RECORD_LIMIT; under
    ``_lock``."""
    global _dropped
    while len(store) >= RECORD_LIMIT:
        store.popleft()
        _dropped += 1
    store.append(item)


@contextlib.contextmanager
def _stage(name: str, request: bool):
    if not on():
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with _lock:
                _times[name] += dt
                _counts[name] += 1
        return
    import torch

    outer = _open.get()
    sid = next(_ids)
    if outer is not None:
        parent, rid = outer
    else:
        parent, rid = None, sid if request else None
    token = _open.set((sid, rid))
    span = torch.profiler.record_function(name)
    span.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        span.__exit__(None, None, None)
        _open.reset(token)
        with _lock:
            _times[name] += t1 - t0
            _counts[name] += 1
            _keep(_spans, Span(sid, parent, rid, name, t0, t1,
                               threading.get_ident()))


def stage(name: str):
    """A stage: its wall time added to ``name``'s accumulator; while
    tracing is on also a span (module docstring)."""
    return _stage(name, False)


def request(name: str):
    """A stage that, while tracing is on and no request is open, starts a
    request: it and every span inside it carry its id. Inside an open
    request it is a plain child span."""
    return _stage(name, True)


def count(name: str, n) -> None:
    """Adds ``n`` to counter ``name`` of the open request while tracing is
    on; nothing while it is off."""
    if not on():
        return
    outer = _open.get()
    with _lock:
        _keep(_tallies, Count(None if outer is None else outer[1], name,
                              int(n), time.perf_counter()))


def carry(fn):
    """``fn`` to run on another thread inside the caller's open span and
    device counters (each call in a copy of the caller's context); ``fn``
    itself while tracing is off."""
    if not on():
        return fn
    ctx = contextvars.copy_context()
    return lambda *a, **kw: ctx.copy().run(fn, *a, **kw)


@contextlib.contextmanager
def device_counts():
    """While tracing is on: a list that collects the (name, (B,) tensor)
    pairs appended to ``device_tally()`` inside the block, for the caller
    to copy back with its outputs and ``count`` once they land; None while
    tracing is off."""
    if not on():
        yield None
        return
    box: list = []
    token = _device.set(box)
    try:
        yield box
    finally:
        _device.reset(token)


def device_tally() -> list | None:
    """The list of the ``device_counts`` block open around this context,
    to append (name, (B,) tensor of per-image counts) to; None where none
    is open."""
    return _device.get()


def snapshot(reset: bool = False) -> dict[str, dict[str, float]]:
    """Per-stage {'seconds', 'calls'} accumulated across all threads.
    Stage seconds are summed per thread, so pooled stages (host_encode on N
    workers) can total more than wall time — that is the intended reading:
    total CPU-seconds spent in the stage. ``reset`` clears the
    accumulators, not ``records()``."""
    with _lock:
        out = {k: {"seconds": round(v, 6), "calls": _counts[k]}
               for k, v in _times.items()}
        if reset:
            _times.clear()
            _counts.clear()
    return out


def records() -> dict:
    """The spans and counters kept while tracing was on, oldest first:
    {'spans': [Span], 'counts': [Count], 'dropped': the number of either
    dropped past RECORD_LIMIT}. Reading clears nothing."""
    with _lock:
        return {"spans": list(_spans), "counts": list(_tallies),
                "dropped": _dropped}


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


__all__ = ["Count", "Span", "carry", "count", "device_counts",
           "device_tally", "device_trace", "on", "records", "request",
           "snapshot", "stage"]
