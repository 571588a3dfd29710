"""Data parallelism over several devices.

Counterpart of ``pngloss_tpu/parallel/mesh.py``. Every image's row
recurrence is independent, so a batch splits into contiguous shards, one
per mesh entry, with no communication between devices: each shard runs
through ``optimize_batch_auto`` on its own device, and the results are
gathered in batch order.

A mesh is a tuple of ``torch.device``s (``data_mesh``). Each distinct
device gets its own host thread. A shard only queues work on its device
and returns without waiting for it. Repeated entries, such as
``("cpu",) * 3`` or ``("cuda:0", "cuda:0")``, are allowed; they run as
separate shards, in order, in their device's thread.

Each CUDA device keeps a small pool of streams (``STREAMS``) for the
pipeline's shape buckets: a call given a ``slot`` runs its whole device
work on stream ``slot % STREAMS`` of each shard's device
(``bucket_stream``), so the buckets of a corpus run side by side on the
card's SMs, and a bucket queues behind the one ``STREAMS`` slots before
it, which bounds the device memory in flight without a host wait.

Not ported, because they exist only for the TPU: padding the batch to a
multiple of the mesh size, the bleed==1 reroute to XLA, the ``interpret``
switch, and ``band_pad`` / ``wmax``.
"""

from __future__ import annotations

import concurrent.futures as _futures
import contextlib
import threading

import numpy as np
import torch

from pngloss_tpu_torch import tracing
from pngloss_tpu_torch.ops import (
    CudaUnavailableError,
    optimize_batch_auto,
    resolve_device,
)


# streams a CUDA device keeps for the buckets in flight: a bucket runs one
# block per image, so several buckets share the SMs. The value is the
# measured knee of chip_smoke.py phase 13's sweep over a ragged corpus
# (PERF.md)
STREAMS = 16
_streams: dict = {}
_copy_streams: dict = {}
_streams_lock = threading.Lock()


def bucket_stream(device, slot):
    """The context the work of bucket ``slot`` runs in on ``device``: on
    a CUDA device, stream ``slot % STREAMS`` of the device's pool (made at
    first use); on the CPU, or for a slot of None, the current stream."""
    device = torch.device(device)
    if slot is None or device.type != "cuda":
        return contextlib.nullcontext()
    device = _indexed(device)
    with _streams_lock:
        pool = _streams.setdefault(device, [])
        while len(pool) < STREAMS:
            pool.append(torch.cuda.Stream(device))
        return torch.cuda.stream(pool[slot % STREAMS])


def copy_stream(device) -> torch.cuda.Stream:
    """A CUDA device's stream for copies that wait on events of the
    bucket streams (made at first use): a one-image call's bands go to
    the host on it, so that the bucket's stream runs the next band's
    kernel without waiting for the copy."""
    device = _indexed(torch.device(device))
    with _streams_lock:
        if device not in _copy_streams:
            _copy_streams[device] = torch.cuda.Stream(device)
        return _copy_streams[device]


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` without an index names the current CUDA device."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def data_mesh(devices=None) -> tuple[torch.device, ...]:
    """A 1-D data-parallel mesh: the given devices (names or
    torch.devices), default every CUDA device. Raises
    ``CudaUnavailableError`` when a CUDA device is asked for, or none is
    given, on a machine without CUDA."""
    if devices is None:
        if not torch.cuda.is_available():
            raise CudaUnavailableError(
                "data_mesh: CUDA is not available, so there are no devices "
                "to default to")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = tuple(_indexed(resolve_device(d)) for d in devices)
    if not mesh:
        raise ValueError("data_mesh: no devices")
    return mesh


def resolve_mesh(device="cuda", mesh=None) -> tuple[torch.device, ...]:
    """The devices a call runs on: ``mesh`` when given, else ``device``
    alone; by default the current CUDA device. Without CUDA that raises
    ``CudaUnavailableError``: nothing runs on the CPU unless asked."""
    if mesh is not None:
        return data_mesh(mesh)
    return data_mesh((device,))


def shard_bounds(b: int, n: int) -> list[tuple[int, int]]:
    """``n`` contiguous [lo, hi) slices of ``b`` items whose sizes differ by
    at most one (the first ``b % n`` are one longer)."""
    q, r = divmod(b, n)
    bounds, lo = [], 0
    for k in range(n):
        hi = lo + q + (k < r)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def optimize_batch_sharded(rows, strength, bleed: int = 2, *, bpp: int,
                           use_row_filters: bool = True, mesh,
                           fetch: bool = True, w_real=None, h_real=None,
                           slot=None, in_flight=None):
    """Batch optimize with the batch axis split over ``mesh``.

    rows: (B, H, W*bpp) uint8, numpy or tensor. strength and the real
    sizes w_real/h_real (ragged batching): one value, or one per image;
    per-image values travel with their images. Returns host numpy arrays
    ((B, H, W*bpp) uint8, (B, H) int8).

    fetch=False returns the still-on-device shards and the batch size,
    ``(qs, fs, B)``: lists of per-shard tensors in batch order, each on its
    shard's device (empty shards, where B < len(mesh), are left out), so
    the caller can overlap the device-to-host copies with other work.
    slot: run each shard on its device's stream for that bucket slot
    (``bucket_stream``); None runs on the current stream. in_flight: the
    images the caller has on the card at once, these among them (None:
    these alone), which pick CLI mode's layout on each device
    (``ops.image.pick_split``)."""
    mesh = data_mesh(mesh)
    b = rows.shape[0]

    def per_image(v):
        if v is None:
            return None
        return np.array(np.broadcast_to(np.asarray(v, np.int32), (b,)))

    s, wr, hr = per_image(strength), per_image(w_real), per_image(h_real)

    def cut(a, lo, hi):
        return None if a is None else a[lo:hi]

    shards = [(dev, lo, hi) for dev, (lo, hi)
              in zip(mesh, shard_bounds(b, len(mesh))) if hi > lo]
    out: list = [None] * len(shards)

    def run_device(dev):
        for k, (d, lo, hi) in enumerate(shards):
            if d == dev:
                with bucket_stream(d, slot):
                    out[k] = optimize_batch_auto(
                        rows[lo:hi], s[lo:hi], bleed, bpp=bpp, device=d,
                        use_row_filters=use_row_filters,
                        w_real=cut(wr, lo, hi), h_real=cut(hr, lo, hi),
                        in_flight=in_flight)

    devices = list(dict.fromkeys(d for d, _, _ in shards))
    if len(devices) == 1:
        run_device(devices[0])
    else:
        run = tracing.carry(run_device)
        with _futures.ThreadPoolExecutor(len(devices)) as pool:
            for fut in [pool.submit(run, d) for d in devices]:
                fut.result()
    qs = [q for q, _ in out]
    fs = [f for _, f in out]
    if not fetch:
        return qs, fs, b
    return (np.concatenate([q.cpu().numpy() for q in qs]),
            np.concatenate([f.cpu().numpy() for f in fs]))
