"""The optimizer around the three kernels, in CLI mode and embedding mode.

Counterpart of ``pngloss_tpu/ops/optimize_pallas.py``. For a batch of
same-shaped (possibly padded) working-format planes:

  1. the whole-image pre-pass (``hist``), always over the whole image;
  2. row 0 through ``row.row_retry``: the histogram-delta cost, the
     derivative error, libpng's MSAD self-check and the first-minimum
     winner. Images with no passing filter retry at strength s-1; at s <= 0
     the min-cost row is accepted (where the C tool would abort). On CUDA
     tensors the strength loop runs inside one launch of the row kernel, as
     the JAX package runs it inside its device program: a ladder, a
     thread-block cluster per image that tries k strengths at once
     (``row.ladder_size`` picks k from the batch size and bpp, so choosing
     it reads nothing from the card);
  3. rows 1..H-1 through ``image`` in one launch. In CLI mode
     (``use_row_filters=True``) only row 0 can fail, so one attempt a row
     is final. In embedding mode every row must pass the MSAD self-check:
     the image stage's retry variant runs every row's strength loop over
     the whole batch (on the card a ladder: a thread-block cluster per
     image tries k strengths of a row at once). The JAX package speculates
     at full strength instead and re-runs the images with a failing row
     through its per-row path; on an H100 the ladder over the whole batch
     took less time than the speculation alone, on batches with and
     without failing images (PERF.md), so the port runs no speculation.
     ``optimize_rows`` is that per-row path from any row.

Nothing here reads a device value, so a call on CUDA tensors only queues
work on the current stream: the host never waits for the card.

An image one row high runs step 2 alone. The kernels compare the adaptive
frequency alone in 32 bits and then a key built from the rank of the
original frequency (csrc/quantize.cuh), exact at every image size. Large
batches are cut into chunks sized by free device memory.
"""

from __future__ import annotations

import numpy as np
import torch

from pngloss_tpu_torch import tracing
from pngloss_tpu_torch.convert import Carry
from pngloss_tpu_torch.ops import hist as hist_op
from pngloss_tpu_torch.ops import image as image_op
from pngloss_tpu_torch.ops import row as row_op
from pngloss_tpu_torch.ops.row import zero_carry

# share of free device memory one chunk may take
_MEMORY_SHARE = 0.25
# every kernel's grid is one-dimensional, at least one block per image;
# far below its 2^31 - 1, and a chunk this large is cut by memory first
_MAX_CHUNK = 1 << 20


def to_device(a, device) -> torch.Tensor:
    """``a`` (a tensor or numpy-convertible host data) on ``device``. Host
    data goes to a CUDA device through pinned memory without blocking, so
    the host does not wait for the work queued on the stream before the
    copy."""
    t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a, order="C"))
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def bytes_per_image(h: int, w: int, bpp: int) -> int:
    """Device bytes one image of a CUDA batch holds at once: the uint8
    plane, the int32 winner rows, the uint8 output, 9 bytes a sample to
    spare (the per-row path's int32 originals and rows and its uint8
    originals, where a caller runs it), and the 5 candidates' rows and
    dither rows (a row attempt's outputs, and the image kernel's two sets
    of scratch). The two ladders' further rungs (row 0's and the image
    stage's) take scratch rows of their own only while the batch leaves
    SMs idle (batch x rungs <= SMs), at most that many rows' worth in all,
    which the memory share leaves room for."""
    wb = w * bpp
    return (h * wb * (1 + 4 + 1 + 4 + 4 + 1)
            + 4 * 5 * 3 * (wb + 2 * 4 * (w + 5)) + 8192)


def max_batch(h: int, w: int, bpp: int, device) -> int:
    """Largest batch one chunk takes on ``device`` (unbounded on CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return 1 << 30
    free, _ = torch.cuda.mem_get_info(device)
    fit = int(free * _MEMORY_SHARE) // bytes_per_image(h, w, bpp)
    return max(1, min(_MAX_CHUNK, fit))


def row_step(s, bleed: int, orow, carry: Carry, ofreq, w_real):
    """One row with the MSAD self-check and the strength fallback
    (``row.row_retry``: on CUDA tensors one launch of the row ladder at the
    k it picks, no host sync), from the state ``carry`` the previous row
    left. Returns
    the winner's state as the next row's Carry, its filter id (B,) int64
    and the attempts each image took (B,) int32."""
    (q, h, e0n, e1n), best, tries = row_op.row_retry(s, bleed, orow, carry,
                                                     ofreq, w_real)
    return Carry(q, orow, e0n, e1n, h), best, tries


def row0(s, bleed: int, orig0, ofreq, w_real):
    """Row 0: ``row_step`` from the zero state, without its attempts."""
    b, w, bpp = orig0.shape
    return row_step(s, bleed, orig0,
                    zero_carry(b, w, bpp, orig0.device), ofreq, w_real)[:2]


def optimize_rows(s, bleed: int, orig, ofreq, w_real, carry=None):
    """The per-row path of embedding mode (every row adaptive), the
    counterpart of ``optimize_batch_pallas_t(use_row_filters=False)``.

    orig (B, R, W, bpp) int32 originals of the rows to run; carry: the
    state the row before them left (None: they start at row 0, which runs
    through ``row_step``). The rows after it run in one call of the image
    stage's retry variant: on CUDA tensors one kernel launch with no host
    round trip per attempt, each image retrying alone. Returns the winner
    rows (B, R, W, bpp) int32 and filter ids (B, R) int64."""
    b, r, w, bpp = orig.shape
    q = torch.empty_like(orig)
    f = torch.empty((b, r), dtype=torch.int64, device=orig.device)
    done = 0
    if carry is None:
        carry, f[:, 0] = row0(s, bleed, orig[:, 0].contiguous(), ofreq,
                              w_real)
        q[:, 0] = carry.qprev
        done = 1
    if r > done:
        # the kernel reads originals as bytes, the row before them first
        rows = torch.cat([carry.oprev[:, None], orig[:, done:]], 1)
        rows = rows.to(torch.uint8).view(b, -1, w * bpp)
        q[:, done:], f[:, done:], _ = image_op.image_rows(
            s, bleed, w_real, ofreq, rows, carry.qprev, carry.e0, carry.e1,
            carry.hist, adaptive=True, retry=True)
    return q, f


def _optimize_chunk(rows, strength, bleed: int, bpp: int, w_real, h_real,
                    use_row_filters: bool, in_flight=None):
    """One chunk through the three steps, each a span of its own; CLI
    mode's image stage is told the images in flight (``in_flight``, as for
    ``image.image_rows``). Inside a ``tracing.device_counts`` block,
    embedding mode also reports the ladder's real rows, attempts and
    rounds (``ladder.*``) of each image as device tensors."""
    b, h, wb = rows.shape
    w = wb // bpp
    with tracing.stage("ops.hist"):
        ofreq = hist_op.original_frequencies(rows, bpp, w_real, h_real)
    with tracing.stage("ops.row0"):
        orig0 = rows[:, 0].reshape(b, w, bpp).to(torch.int32)
        c0, f0 = row0(strength, bleed, orig0, ofreq, w_real)
        q = torch.empty((b, h, w, bpp), dtype=torch.uint8,
                        device=rows.device)
        f = torch.empty((b, h), dtype=torch.int8, device=rows.device)
        q[:, 0] = c0.qprev.to(torch.uint8)
        f[:, 0] = f0.to(torch.int8)
    if h > 1:
        with tracing.stage("ops.image"):
            embed = not use_row_filters
            tally = tracing.device_tally() if embed else None
            rounds = (None if tally is None else
                      torch.empty(b, dtype=torch.int32, device=rows.device))
            qrows, filt, *rest = image_op.image_rows(
                strength, bleed, w_real, ofreq, rows, c0.qprev, c0.e0,
                c0.e1, c0.hist, adaptive=embed, retry=embed, h_real=h_real,
                rounds=rounds, in_flight=None if embed else in_flight)
            q[:, 1:] = qrows.to(torch.uint8)
            f[:, 1:] = filt.to(torch.int8)
            if tally is not None:
                tally += [("ladder.rows", (h_real - 1).clamp(min=0)),
                          ("ladder.attempts", rest[0]),
                          ("ladder.rounds", rounds)]
    return q.view(b, h, wb), f


def optimize_bands(rows, strength: int, bleed: int, *, bpp: int, device,
                   h_real: int, w_real: int, band: int):
    """CLI mode for one image whose rows run in bands, or None where they
    cannot: on a CUDA device only the split layout carries a band's state
    out, and there it must take one image at ``bpp``
    (``image.takes_split``); the caller then runs the image in one launch.
    rows (1, H, W*bpp) uint8, numpy or tensor, goes to ``device`` as in
    ``ops.optimize_batch_auto``; strength, its real height h_real and
    width w_real are ints. The pre-pass and row 0 as in ``optimize_batch``,
    then rows 1..h_real-1 in bands of ``band`` rows (the first holds row
    0), each one ``image.image_rows`` launch from the state the band before
    it left (``carry_out``). Returns a generator whose every step queues
    a band's work on the current stream, then yields (y1, q, f), the
    image's output q (1, H, W*bpp) uint8 and f (1, H) int8, whose rows
    before y1 are final once that work has run; rows at and after h_real
    are not written. Nothing
    here waits for the card, and a band queues three launches: the image
    kernel and the copies of its rows and filters into q and f. The image
    is counted once to the open request, as ``image_rows`` counts a
    launch's images."""
    dev = torch.device(device)
    if dev.type == "cuda" and not image_op.takes_split(1, bpp, dev):
        return None
    return _bands(rows, strength, bleed, bpp, dev, h_real, w_real, band)


def _bands(rows, strength, bleed, bpp, device, h_real, w_real, band):
    """``optimize_bands``' generator."""
    with tracing.stage("ops.upload"):
        rows = to_device(rows, device)
        dev = rows.device
        # h_t, the image's real height, is each band's too: the kernel
        # and its plain version take every row of a band as real
        strength, w_real, h_t = (
            torch.full((1,), int(v), dtype=torch.int32, device=dev)
            for v in (strength, w_real, h_real))
    _, h, wb = rows.shape
    w = wb // bpp
    if dev.type == "cuda":
        tracing.count("image.images", 1)
        tracing.count("image.split", 1)
    with tracing.stage("ops.hist"):
        ofreq = hist_op.original_frequencies(rows, bpp, w_real, h_t)
    with tracing.stage("ops.row0"):
        orig0 = rows[:, 0].reshape(1, w, bpp).to(torch.int32)
        c0, f0 = row0(strength, bleed, orig0, ofreq, w_real)
        q = torch.empty((1, h, wb), dtype=torch.uint8, device=dev)
        f = torch.empty((1, h), dtype=torch.int8, device=dev)
        q[:, 0].copy_(c0.qprev.reshape(1, wb))
        f[:, 0].copy_(f0)
    carry = (c0.qprev, c0.e0, c0.e1, c0.hist)
    for y0 in range(0, h_real, band):
        y1 = min(y0 + band, h_real)
        lo = max(y0, 1)
        if y1 > lo:
            with tracing.stage("ops.image"):
                # the band's originals, the row before them first
                qrows, filt, carry = image_op.image_rows(
                    strength, bleed, w_real, ofreq, rows[:, lo - 1:y1],
                    *carry, h_real=h_t, in_flight=1, carry_out=True)
                q[:, lo:y1].copy_(qrows.view(1, y1 - lo, wb))
                f[:, lo:y1].copy_(filt)
        yield y1, q, f


def optimize_batch(rows, strength, bleed: int = 2, *, bpp: int,
                   use_row_filters: bool = True, w_real=None, h_real=None,
                   in_flight=None):
    """rows (B, H, W*bpp) uint8 tensor; strength int or (B,) values;
    use_row_filters: CLI mode (True) or embedding mode (False, every row
    passes libpng's MSAD self-check); w_real/h_real (B,) real sizes of
    padded planes; in_flight: the images the caller has on the card at
    once, these among them (None: these alone), which pick CLI mode's
    layout (``image.pick_split``). Runs on rows' device. Returns (q (B, H,
    W*bpp) uint8, filters (B, H) int8) on that device."""
    b, h, wb = rows.shape
    w = wb // bpp
    dev = rows.device
    rows = rows.contiguous()

    def per_image(v, fill):
        if v is None:
            v = fill
        if not torch.is_tensor(v) and np.ndim(v) == 0:
            return torch.full((b,), int(v), dtype=torch.int32, device=dev)
        t = to_device(v, dev).to(torch.int32)
        return t.expand(b).contiguous() if t.dim() == 0 else t.contiguous()

    with tracing.stage("ops.prepare"):
        strength = per_image(strength, 0)
        w_real = per_image(w_real, w)
        h_real = per_image(h_real, h)
        chunk = max_batch(h, w, bpp, dev)
    if b <= chunk:
        return _optimize_chunk(rows, strength, int(bleed), bpp, w_real,
                               h_real, use_row_filters, in_flight)
    qs, fs = [], []
    for lo in range(0, b, chunk):
        sl = slice(lo, lo + chunk)
        q, f = _optimize_chunk(rows[sl], strength[sl], int(bleed), bpp,
                               w_real[sl], h_real[sl], use_row_filters,
                               in_flight)
        qs.append(q)
        fs.append(f)
    return torch.cat(qs), torch.cat(fs)
