"""Image-level pipeline: decode -> colorspace reduce -> optimize -> encode.

Counterpart of ``pngloss_tpu/pipeline.py``: CLI mode (row filters
recorded) and the embedding API (``optimize_for_average_filter``,
``optimize_with_stride``: every row passes libpng's MSAD self-check).
Images are bucketed by padded working shape (H, W, bpp) on the
pad ladder, each bucket is optimized in one call on ``device`` (default
``"cuda"``; nothing runs on the CPU unless ``device="cpu"``), or split
over the devices of ``mesh`` (``parallel.data_mesh``), with the real sizes
as per-image masks, and host DEFLATE drains finished buckets on a thread
pool. On CUDA the dispatch never waits for the card, in either mode: each
bucket's upload (from pinned memory), kernels and copies back into pinned
host memory are queued on one stream of its device's small pool
(``parallel.mesh.bucket_stream``), the buckets longest chain first, so
the short buckets run on the SMs beside the long ones. Every call from
PNG bytes to PNG bytes, ``compress_many`` and the command for one file or
many, takes one path: ``prepare`` each input on the ``HostPool``,
``dispatch_buckets``, then ``finish`` each image on the pool as its
bucket's copy lands (``HostPool.drain``). Each shard chunks itself by its
own device's free memory. Output bytes equal ``pngloss_tpu.pipeline``'s,
whatever the pool size and the order.

The host helpers below are copies of ``pngloss_tpu.pipeline``'s: the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import concurrent.futures as _futures
import dataclasses
import os
import time

import numpy as np
import torch

from pngloss_tpu_torch import codec, tracing
from pngloss_tpu_torch.parallel import optimize_batch_sharded, resolve_mesh
from pngloss_tpu_torch.parallel.mesh import bucket_stream


def working_bpp(rgba: np.ndarray) -> int:
    """Bytes-per-pixel of the working format the optimizer would use for
    this image (pngloss_image.c:64-80 colorspace detection)."""
    grayscale, strip_alpha = codec.detect_colorspace(rgba)
    return {(True, True): 1, (True, False): 2,
            (False, True): 3, (False, False): 4}[(grayscale, strip_alpha)]


def pack_work(rgba: np.ndarray, bpp: int) -> np.ndarray:
    """Repack RGBA into the given working format (grayscale keeps the green
    channel, pngloss_image.c:111-120). Returns (H, W*bpp) uint8."""
    h, w = rgba.shape[0], rgba.shape[1]
    if bpp == 1:
        work = rgba[:, :, 1:2]
    elif bpp == 2:
        work = rgba[:, :, (1, 3)]
    elif bpp == 3:
        work = rgba[:, :, :3]
    else:
        work = rgba
    return np.ascontiguousarray(work).reshape(h, w * bpp)


def reduce_colorspace(rgba: np.ndarray) -> tuple[np.ndarray, int]:
    """Repack RGBA into the 1/2/3/4-byte working format
    (optimize_with_rows, pngloss_image.c:64-121; grayscale keeps the green
    channel). Returns ((H, W*bpp) uint8, bpp)."""
    bpp = working_bpp(rgba)
    return pack_work(rgba, bpp), bpp


def restore_colorspace(work: np.ndarray, bpp: int, w: int) -> np.ndarray:
    """Working format back to RGBA (pngloss_image.c:126-147)."""
    h = work.shape[0]
    px = work.reshape(h, w, bpp)
    out = np.empty((h, w, 4), dtype=np.uint8)
    if bpp == 1:
        out[:, :, 0] = out[:, :, 1] = out[:, :, 2] = px[:, :, 0]
        out[:, :, 3] = 255
    elif bpp == 2:
        out[:, :, 0] = out[:, :, 1] = out[:, :, 2] = px[:, :, 0]
        out[:, :, 3] = px[:, :, 1]
    elif bpp == 3:
        out[:, :, :3] = px
        out[:, :, 3] = 255
    else:
        out[:] = px
    return out


_SIZE_LADDER = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)


def pad_dim(n: int) -> int:
    """Ragged-batching pad ladder: ~1.5x geometric steps below 512,
    multiples of 128 above (compute waste <= ~25%), so a corpus of
    arbitrary sizes falls into a few buckets per bpp."""
    for v in _SIZE_LADDER:
        if n <= v:
            return v
    return -(-n // 128) * 128


def _warn_abort_fallbacks(qs, fs, bpp: int) -> None:
    """Where the C tool abort()s ("no good row" at strength 0,
    pngloss_image.c:268), the optimizer emits the min-cost row instead —
    a documented byte-parity deviation in a case the reference considers
    impossible. Detect it post-hoc (row 0 is the only adaptive row in CLI
    mode) so any real-world occurrence is visible."""
    import warnings

    from pngloss_tpu_torch.reference import adaptive_filter_for_row

    hit = sum(1 for q, f in zip(qs, fs)
              if adaptive_filter_for_row(
                  None, q[0], bpp, q.shape[1] // bpp) != int(f[0]))
    if hit:
        warnings.warn(
            f"pngloss divergence: {hit} image(s) had no adaptive-consistent "
            "row 0 at strength 0 (the C tool would abort); emitted the "
            "min-cost row instead", RuntimeWarning, stacklevel=3)


@dataclasses.dataclass
class _PendingBucket:
    """One dispatched shape bucket; its host copies may still be landing."""
    idxs: list[int]              # image indices covered by this bucket
    bpp: int
    q: torch.Tensor              # host (B, H_pad, W_pad*bpp) uint8
    f: torch.Tensor              # host (B, H_pad) int8
    dims: list[tuple[int, int]]  # per-image real (H, W*bpp) to slice out
    # CUDA events, one per CUDA shard, recorded after its copies
    done: list = dataclasses.field(default_factory=list)
    # while tracing: (counter name, host (B,) tensor) copied back before
    # the events, counted when the bucket lands
    counts: list = dataclasses.field(default_factory=list)


def _gather_to_host(qs, fs, slot=None):
    """The shards' results as one host tensor each, in batch order. CUDA
    shards copy into pinned memory without blocking, on their device's
    stream for the bucket ``slot``, which ran their kernels; returns (q, f,
    events), one event per CUDA shard, recorded on that stream after its
    copies."""
    if all(q.device.type != "cuda" for q in qs):
        return torch.cat(qs), torch.cat(fs), []
    b = sum(len(q) for q in qs)
    qh = torch.empty((b, *qs[0].shape[1:]), dtype=qs[0].dtype,
                     pin_memory=True)
    fh = torch.empty((b, *fs[0].shape[1:]), dtype=fs[0].dtype,
                     pin_memory=True)
    done, lo = [], 0
    for q, f in zip(qs, fs):
        hi = lo + len(q)
        with bucket_stream(q.device, slot):
            qh[lo:hi].copy_(q, non_blocking=True)
            fh[lo:hi].copy_(f, non_blocking=True)
            if q.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(q.device))
                done.append(event)
        lo = hi
    return qh, fh, done


def _counts_to_host(tally, slot):
    """The device counters of a bucket (``tracing.device_counts``) as
    (name, host tensor), each CUDA one copied into pinned memory without
    blocking on its device's stream for the bucket ``slot``, before
    ``_gather_to_host`` records that stream's events."""
    out = []
    for name, t in tally or ():
        if t.device.type == "cuda":
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            with bucket_stream(t.device, slot):
                h.copy_(t, non_blocking=True)
            t = h
        out.append((name, t))
    return out


def dispatch_order(keys):
    """Bucket keys (h_pad, wb_pad, bpp) in the order they are dispatched:
    longest chain first. A bucket's device time is its image kernel's
    chain, h_pad * w_pad * bpp channel steps, almost whatever its batch,
    so the short buckets fill the SMs around the long ones. Ties keep
    their order."""
    return sorted(keys, key=lambda k: -k[0] * k[1])


def dispatch_buckets(works, bpps, strength, bleed: int = 2, *,
                     use_row_filters: bool = True, device="cuda",
                     mesh=None) -> list[_PendingBucket]:
    """Bucket working-format planes and optimize each bucket on ``device``,
    or split over the devices of ``mesh`` (which, when given, replaces
    ``device``), starting its device-to-host copies without waiting for
    them.

    Ragged batching: each plane is zero-padded up to the pad_dim ladder and
    bucketed by PADDED shape, with the real (H, W) passed to the kernels as
    per-image masks, so mixed sizes batch together while outputs stay
    byte-identical to unpadded runs. strength: scalar or per-image sequence
    (mixed strengths share one launch). use_row_filters=False runs
    embedding mode.

    The buckets are dispatched in ``dispatch_order``, the k-th on the
    stream for slot k of its devices' pools (``bucket_stream``): upload,
    kernels and copies back on that stream, so in either mode nothing
    waits for the card and this returns once the work is queued. The pending
    buckets come back in the order their shapes first appear, as
    ``pngloss_tpu.pipeline`` returns them. Every bucket's launches are
    told that all the call's images are in flight at once, which picks CLI
    mode's layout (``ops.image.pick_split``): buckets that each fit the
    split layout alone but not together would queue behind each other.
    While tracing, the number of buckets is counted to the open request
    (``pipeline.buckets``)."""
    mesh = resolve_mesh(device, mesh)
    per_image = not np.isscalar(strength)
    buckets: dict[tuple[int, int, int], list[int]] = {}
    for i, (wk, bpp) in enumerate(zip(works, bpps)):
        h, wb = wk.shape
        key = (pad_dim(h), pad_dim(wb // bpp) * bpp, bpp)
        buckets.setdefault(key, []).append(i)
    tracing.count("pipeline.buckets", len(buckets))

    pending = {}
    for slot, key in enumerate(dispatch_order(list(buckets))):
        h_pad, wb_pad, bpp = key
        idxs = buckets[key]
        dims = [works[i].shape for i in idxs]
        with tracing.stage("host_pack"):
            batch = np.zeros((len(idxs), h_pad, wb_pad), np.uint8)
            for k, i in enumerate(idxs):
                hh, ww = works[i].shape
                batch[k, :hh, :ww] = works[i]
            w_real = np.asarray([d[1] // bpp for d in dims], np.int32)
            h_real = np.asarray([d[0] for d in dims], np.int32)
            s = (np.asarray([strength[i] for i in idxs], np.int32)
                 if per_image else strength)
        with tracing.stage(f"device_dispatch_{h_pad}x{wb_pad // bpp}x{bpp}"), \
                tracing.device_counts() as tally:
            qs, fs, _ = optimize_batch_sharded(
                batch, s, bleed, bpp=bpp, use_row_filters=use_row_filters,
                mesh=mesh, fetch=False, w_real=w_real, h_real=h_real,
                slot=slot, in_flight=len(works))
            with tracing.stage("host_gather"):
                counts = _counts_to_host(tally, slot)
                qh, fh, done = _gather_to_host(qs, fs, slot)
        pending[key] = _PendingBucket(idxs, bpp, qh, fh, dims, done, counts)
    return [pending[key] for key in buckets]


# seconds between two looks at the pending buckets' events
POLL_S = 0.0005


def landed(pending):
    """The pending buckets in the order their host copies land: each time
    the first one whose events have all completed, looked for every
    POLL_S seconds; the waiting is the stage device_fetch. A bucket with
    no event (the CPU's) has landed."""
    left = list(pending)
    while left:
        with tracing.stage("device_fetch"):
            while True:
                ready = next((k for k, p in enumerate(left)
                              if all(e.query() for e in p.done)), None)
                if ready is not None:
                    break
                time.sleep(POLL_S)
        yield left.pop(ready)


def _bucket_arrays(p: _PendingBucket):
    """A landed bucket's (qs, fs): per-image lists sliced to each image's
    real (H, W*bpp). Its device counters are counted here."""
    for name, t in p.counts:
        tracing.count(name, int(t.sum()))
    q = p.q.numpy()
    f = p.f.numpy()
    qs = [q[k, :h, :wb] for k, (h, wb) in enumerate(p.dims)]
    fs = [f[k, :h] for k, (h, _) in enumerate(p.dims)]
    _warn_abort_fallbacks(qs, fs, p.bpp)
    return qs, fs


def collect_bucket(p: _PendingBucket):
    """Wait for all of one bucket's host copies; returns (qs, fs) —
    per-image lists sliced to each image's real (H, W*bpp)."""
    with tracing.stage("device_fetch"):
        for event in p.done:
            event.synchronize()
    return _bucket_arrays(p)


def optimize_rgba_batch(rgbas, strength=19, bleed: int = 2, *,
                        use_row_filters: bool = True, device="cuda",
                        mesh=None):
    """Optimize a list of RGBA images on ``device`` or over ``mesh``,
    bucketing by working shape. strength: one int for all images, or a
    per-image sequence. use_row_filters=False runs embedding mode.
    Returns (list of quantized RGBA, list of row_filters)."""
    if not np.isscalar(strength):
        strength = list(strength)
        if len(strength) != len(rgbas):
            raise ValueError("one strength per image expected")
    with tracing.request("pipeline.optimize_rgba_batch"):
        with tracing.stage("host_reduce"):
            works, bpps = [], []
            for rgba in rgbas:
                work, bpp = reduce_colorspace(rgba)
                works.append(work)
                bpps.append(bpp)
        q_out: list = [None] * len(rgbas)
        f_out: list = [None] * len(rgbas)
        for p in dispatch_buckets(works, bpps, strength, bleed,
                                  use_row_filters=use_row_filters,
                                  device=device, mesh=mesh):
            qb, fb = collect_bucket(p)
            with tracing.stage("host_restore"):
                for j, i in enumerate(p.idxs):
                    q_out[i] = restore_colorspace(qb[j], p.bpp,
                                                  rgbas[i].shape[1])
                    f_out[i] = np.ascontiguousarray(fb[j])
    return q_out, f_out


def optimize_rgba(rgba: np.ndarray, strength: int = 19, bleed: int = 2,
                  use_row_filters: bool = True, *, device="cuda",
                  mesh=None) -> tuple[np.ndarray, np.ndarray]:
    """Optimize one RGBA image on ``device`` or ``mesh``; the single-image
    counterpart of the reference's optimize_with_rows (pngloss_image.c:52).
    Returns (quantized RGBA (H,W,4) uint8, row_filters (H,) int8)."""
    q, f = optimize_rgba_batch([rgba], strength, bleed,
                               use_row_filters=use_row_filters,
                               device=device, mesh=mesh)
    return q[0], f[0]


def unique_symbol_count(q_rgba: np.ndarray, row_filters: np.ndarray,
                        bpp: int | None = None) -> int:
    """Number of distinct residual symbols the optimizer emitted
    (the reference's verbose 'used N unique symbols', pngloss_image.c:315-325).
    Recomputed from the quantized image: the emitted byte equals the
    recomputed residual byte under each row's winning filter.

    bpp: the working format the OPTIMIZER used (from the original image's
    colorspace detection). Pass it whenever available — re-detecting on the
    quantized pixels can differ when quantization collapses the image to
    grayscale or fully-opaque, and the count would diverge from the C tool's
    histogram-based one."""
    if bpp is None:
        work, bpp = reduce_colorspace(q_rgba)
    else:
        work = pack_work(q_rgba, bpp)
    return symbol_count(work, row_filters, bpp)


def symbol_count(work: np.ndarray, row_filters: np.ndarray, bpp: int) -> int:
    """``unique_symbol_count`` of an optimized working plane (H, W*bpp),
    as the optimizer returns it."""
    h = work.shape[0]
    rows = work.astype(np.int32)
    # no sequential dependency: row y's predictor reads only the known
    # quantized row y-1, so the five predictor planes vectorize over the
    # whole image and the winning one is a per-row select
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    diag = np.zeros_like(rows)
    diag[1:, bpp:] = rows[:-1, :-bpp]
    p = up - diag
    pd = left - diag
    paeth = np.where((np.abs(p) <= np.abs(pd)) & (np.abs(p) <= np.abs(p + pd)),
                     left, np.where(np.abs(pd) <= np.abs(p + pd), up, diag))
    preds = np.stack([np.zeros_like(rows), left, up,
                      (left + up) // 2, paeth])
    pred = preds[np.asarray(row_filters, np.intp), np.arange(h)]
    seen = np.zeros(256, bool)
    seen[(rows - pred) & 0xFF] = True
    return int(seen.sum())


def optimize_for_average_filter(rgba: np.ndarray, strength: int = 19, *,
                                device="cuda") -> np.ndarray:
    """The embedding API (optimizeForAverageFilter, pngloss_image.c:29):
    fixed bleed=2, no row-filter output, every row must self-consistently
    pass libpng's adaptive heuristic. Returns the quantized RGBA array."""
    with tracing.request("pipeline.optimize_for_average_filter"):
        q, _ = optimize_rgba(rgba, strength, bleed=2, use_row_filters=False,
                             device=device)
    return q


def optimize_with_stride(buffer: np.ndarray, width: int, height: int,
                         stride: int, strength: int = 19, bleed: int = 2,
                         use_row_filters: bool = True, *, device="cuda"):
    """Stride-buffer embedding entry (optimize_with_stride,
    pngloss_image.c:40-50): ``buffer`` is a flat uint8 array holding RGBA
    rows ``stride`` bytes apart; pixels are modified IN PLACE, and the
    per-row filter choices are returned."""
    buf = buffer.reshape(-1)
    rgba = np.stack([
        buf[y * stride: y * stride + width * 4].reshape(width, 4)
        for y in range(height)
    ])
    q, filters = optimize_rgba(rgba, strength, bleed,
                               use_row_filters=use_row_filters,
                               device=device)
    for y in range(height):
        buf[y * stride: y * stride + width * 4] = q[y].reshape(-1)
    return filters


@dataclasses.dataclass
class Prepared:
    """An input PNG as the optimizer takes it (``prepare``)."""
    data: bytes                  # the input file's bytes
    img: codec.DecodedImage
    work: np.ndarray             # (H, W*bpp) uint8 working plane
    bpp: int


def prepare(data: bytes, strip: bool = False) -> Prepared:
    """Decode an input PNG and reduce it to its working plane (the
    colorspace detection of optimize_with_rows, pngloss_image.c:64-121).
    Raises ``codec.PngDecodeError``."""
    with tracing.stage("host_decode"):
        img = codec.decode(data, strip=strip)
    with tracing.stage("host_reduce"):
        work, bpp = reduce_colorspace(img.rgba)
    return Prepared(data, img, work, bpp)


def finish(prep: Prepared, q_work: np.ndarray, f_row: np.ndarray,
           skip_if_larger: bool = False) -> bytes:
    """The output PNG of ``prep``'s optimized plane and row filters: its
    colorspace restored, encoded with the input's gamma, colour transform
    and chunks. Raises ``codec.TooLargeFile`` where ``skip_if_larger`` is
    set and the output would not be smaller than the input."""
    img = prep.img
    with tracing.stage("host_restore"):
        rgba = restore_colorspace(q_work, prep.bpp, img.rgba.shape[1])
    with tracing.stage("host_encode"):
        return codec.encode(
            rgba, row_filters=f_row, gamma=img.gamma,
            color_transform=img.color_transform, chunks=img.chunks,
            maximum_file_size=len(prep.data) - 1 if skip_if_larger else 0)


@dataclasses.dataclass
class CompressResult:
    """Per-file outcome of a batch compression run."""
    data: bytes | None = None          # compressed PNG, or None on error/skip
    error: Exception | None = None
    input_size: int = 0
    output_size: int = 0
    metadata_size: int = 0

    def unwrap(self) -> bytes:
        if self.error is not None:
            raise self.error
        if self.data is None:
            raise RuntimeError("no output and no error recorded")
        return self.data


def compress_bytes(data: bytes, strength: int = 19, bleed: int = 2, *,
                   strip: bool = False, skip_if_larger: bool = False,
                   device="cuda", mesh=None) -> bytes:
    """Compress one PNG file's bytes (pngloss_file_internal, pngloss.c:226).
    Raises codec.TooLargeFile when skip_if_larger is set and the output
    would not be smaller than the input."""
    return compress_many([data], strength, bleed, strip=strip,
                         skip_if_larger=skip_if_larger,
                         device=device, mesh=mesh)[0].unwrap()


def compress_many(files, strength=19, bleed: int = 2, *,
                  strip: bool = False, skip_if_larger: bool = False,
                  device="cuda", mesh=None) -> list[CompressResult]:
    """Compress many PNG byte strings on ``device`` (default "cuda": the
    kernels; "cpu" runs their plain PyTorch versions; "cuda" without CUDA
    raises ``CudaUnavailableError``), or split over the devices of ``mesh``
    (``parallel.data_mesh``), which, when given, replaces ``device``.

    ``prepare`` on the host pool -> queue each shape bucket on the device
      -> per bucket, as its host copy lands: ``finish`` on the host pool
      (``HostPool``)

    strength: one int, or one per file.
    """
    with tracing.request("pipeline.compress_many"):
        return _compress_many(files, strength, bleed, strip, skip_if_larger,
                              resolve_mesh(device, mesh))


def _compress_many(files, strength, bleed, strip, skip_if_larger, mesh):
    results = [CompressResult(input_size=len(d)) for d in files]
    per_image_strength = not np.isscalar(strength)
    if per_image_strength:
        strength = list(strength)
        if len(strength) != len(files):
            raise ValueError("one strength per file expected")

    with HostPool() as pool:
        # identical inputs (the suite's same-file-many-strengths pattern)
        # are prepared once
        distinct = list(dict.fromkeys(files))
        prepared = dict(zip(distinct, pool.map(
            lambda d: prepare(d, strip), distinct)))
        ok_idx = []
        for i, d in enumerate(files):
            results[i].error = prepared[d][1]
            if results[i].error is None:
                ok_idx.append(i)

        ok = [prepared[files[i]][0] for i in ok_idx]
        s_ok = ([strength[i] for i in ok_idx] if per_image_strength
                else strength)
        pending = dispatch_buckets([p.work for p in ok], [p.bpp for p in ok],
                                   s_ok, bleed, mesh=mesh)
        for j, out, err in pool.drain(pending, lambda j, q, f: finish(
                ok[j], q, f, skip_if_larger)):
            r = results[ok_idx[j]]
            r.error = err            # TooLargeFile and friends
            if err is None:
                r.data, r.output_size = out, len(out)
                r.metadata_size = sum(len(c.data) + 12
                                      for c in ok[j].img.chunks)
    return results


def host_workers() -> int:
    """The threads of a ``HostPool``: the cores this process may run on."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:              # a platform without affinity
        return os.cpu_count() or 1


class HostPool:
    """The host side of a batch, on one pool of ``host_workers()`` threads:
    ``map`` decodes the inputs, then ``drain`` encodes each dispatched
    bucket's images as its host copy lands, while later buckets are still
    on the card. The native codec's inflate and deflate release the GIL,
    so the pool scales with real cores. Work submitted runs inside the
    caller's open span (``tracing.carry``); a call of one item or one
    image runs in the calling thread. ``compress_many`` and the command
    run on it; use it as a context manager."""

    def __init__(self):
        self.workers = host_workers()
        self._pool = _futures.ThreadPoolExecutor(self.workers)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._pool.shutdown(wait=True, cancel_futures=True)

    def map(self, fn, items) -> list:
        """``fn(item)`` of each item, in order: (result, None), or (None,
        the exception it raised). One item, or a pool of one, runs in the
        calling thread."""
        if len(items) < 2 or self.workers < 2:
            return [_try(fn, x) for x in items]
        return list(self._pool.map(tracing.carry(lambda x: _try(fn, x)),
                                   items))

    def drain(self, pending, encode):
        """As each of the ``pending`` buckets lands (``landed``), submits
        ``encode(j, q_work, f_row)`` for each of its images ``j``
        (``_PendingBucket.idxs``) to the pool, or runs it in the calling
        thread where there is one image. Yields (j, result, None) or (j,
        None, the exception it raised), in the order of ``j``, each once
        its encode is done: the ones already done after each landing, the
        rest once every bucket has landed."""
        run = tracing.carry(lambda *a: _try(encode, *a))
        futs = [None] * sum(len(p.idxs) for p in pending)
        submit = self._pool.submit if len(futs) > 1 else _now
        nxt = 0
        for p in landed(pending):
            qb, fb = _bucket_arrays(p)
            for k, j in enumerate(p.idxs):
                futs[j] = submit(run, j, qb[k], fb[k])
            while nxt < len(futs) and futs[nxt] is not None \
                    and futs[nxt].done():
                yield nxt, *futs[nxt].result()
                nxt += 1
        for j in range(nxt, len(futs)):
            yield j, *futs[j].result()


def _now(fn, *args):
    """``fn(*args)`` run in the calling thread, as a done future."""
    fut = _futures.Future()
    fut.set_result(fn(*args))
    return fut


def _try(fn, *args):
    try:
        return fn(*args), None
    except Exception as e:
        return None, e
