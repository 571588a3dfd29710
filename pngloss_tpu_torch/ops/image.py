"""Rows 1..H-1 of every image in one launch.

Counterpart of ``pngloss_tpu/ops/pallas_image.py`` (``_image_kernel``).
Each row is one attempt under the 5 filters, the row cost (histogram-delta
bits plus derivative error / 128), the first-minimum winner, and the
winner's row, histogram and dither rows carried to the next row. Rows >= 1
never fall back to a lower strength here:

  * CLI mode (``adaptive=False``): only row 0 runs the MSAD self-check, so
    every row's attempt is final;
  * embedding mode (``adaptive=True``, the speculation): every row runs the
    MSAD self-check at full strength, a failing candidate costs
    ``FAIL_COST``, and ``ok`` flags each image where some row had no
    passing filter. Such a row carries on with filter 0, as the TPU kernel
    does; its image needs the per-row fallback (``optimize_gpu``).

On a CUDA tensor ``image_rows`` launches ``csrc/image.cu``; on a CPU tensor
it runs ``image_rows_ref``.
"""

from __future__ import annotations

import torch

from pngloss_tpu_torch.ops import _build
from pngloss_tpu_torch.ops.optimize import (
    NUM_FILTERS,
    adaptive_cost,
    first_min,
    msad_valid,
    pick,
    quantize_row,
    row_cost,
)

# launches of the kernel's CLI variant and of its adaptive variant
LAUNCHES = 0
ADAPTIVE_LAUNCHES = 0


def image_rows_ref(s, bleed: int, w_real, ofreq, rows, qprev0, e00, e10,
                   hist0, adaptive: bool = False):
    """Plain version; arguments as for ``image_rows``.

    The row step (the 5 candidates, and with ``adaptive`` their MSAD
    self-check) reads and writes fixed buffers. On a CUDA tensor it is
    captured once in a CUDA graph and replayed for every row: the same
    kernels on the same data, without the ~80k host launches per 512-px RGB
    row of an eager run."""
    b, h, wb = rows.shape
    w, bpp = qprev0.shape[1], qprev0.shape[2]
    dev = rows.device
    qrows = torch.empty((b, h - 1, w, bpp), dtype=torch.int32, device=dev)
    filts = torch.empty((b, h - 1), dtype=torch.int32, device=dev)
    ok = torch.ones(b, dtype=torch.int32, device=dev)
    if h >= 2:
        orig = rows.view(b, h, w, bpp).to(torch.int32)
        orow, qprev, e0, e1, hist = (t.clone() for t in
                                     (orig[:, 1], qprev0, e00, e10, hist0))

        def row_step():
            q5, h5, e0n, e1n = quantize_row(s, bleed, orow, qprev, e0, e1,
                                            hist, ofreq, w_real)
            passing = msad_valid(q5, qprev, w_real) if adaptive else None
            return q5, h5, e0n, e1n, passing

        step = _replayable(row_step, dev)
        for y in range(1, h):
            orow.copy_(orig[:, y])
            q5, h5, e0n, e1n, passing = step()
            cost = row_cost(q5, hist, h5, qprev, orow, orig[:, y - 1],
                            w_real)
            if adaptive:
                cost = adaptive_cost(cost, passing)
                ok &= passing.any(1).to(torch.int32)
            best = first_min(cost)
            for buf, cand in ((qprev, q5), (hist, h5), (e0, e0n),
                              (e1, e1n)):
                buf.copy_(pick(cand, best))
            qrows[:, y - 1] = qprev
            filts[:, y - 1] = best
    return (qrows, filts, ok) if adaptive else (qrows, filts)


def _replayable(fn, device):
    """``fn`` itself on the CPU. On CUDA, ``fn`` captured once in a CUDA
    graph: each call replays its kernels and returns the same output
    tensors, refilled. ``fn`` must not write its inputs."""
    if device.type != "cuda":
        return fn
    with torch.cuda.device(device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn()                # warm-up: lazy initialisation off the graph
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()

    def replay():
        with torch.cuda.device(device):
            graph.replay()
        return out
    return replay


def image_rows(s, bleed: int, w_real, ofreq, rows, qprev0, e00, e10, hist0,
               adaptive: bool = False):
    """s, w_real (B,) int32; ofreq (B, 5, 256) int32; rows (B, H, W*bpp)
    uint8 originals of the whole images; the row-0 winner state: qprev0
    (B, W, bpp), e00, e10 (B, W+5, 4), hist0 (B, 256), all int32.
    Returns the winner rows 1..H-1 (B, H-1, W, bpp) int32 and their filter
    ids (B, H-1) int32; with ``adaptive`` also ok (B,) int32, 0 for an
    image where some row had no filter passing the MSAD self-check. A CUDA
    tensor launches the kernel; a CPU tensor runs the plain version."""
    global LAUNCHES, ADAPTIVE_LAUNCHES
    if _build.route(rows) == "cpu":
        return image_rows_ref(s, bleed, w_real, ofreq, rows, qprev0, e00,
                              e10, hist0, adaptive)
    b, h, wb = rows.shape
    w, bpp = qprev0.shape[1], qprev0.shape[2]
    if h < 2 or w * bpp != wb or not 1 <= bpp <= 4 or bleed < 1:
        raise ValueError(f"bad shape {tuple(rows.shape)}, bpp {bpp} or "
                         f"bleed {bleed}")
    i32 = torch.int32
    _build.require(rows, "rows", torch.uint8, (b, h, wb))
    for t, name, shape in ((s, "s", (b,)), (w_real, "w_real", (b,)),
                           (ofreq, "ofreq", (b, NUM_FILTERS, 256)),
                           (qprev0, "qprev0", (b, w, bpp)),
                           (e00, "e00", (b, w + 5, 4)),
                           (e10, "e10", (b, w + 5, 4)),
                           (hist0, "hist0", (b, 256))):
        _build.require(t, name, i32, shape)
    dev = rows.device
    qrows = torch.empty((b, h - 1, w, bpp), dtype=i32, device=dev)
    filt = torch.empty((b, h - 1), dtype=i32, device=dev)
    # scratch: the 5 candidates' rows and next dither rows, and the
    # winner's dither rows carried from row to row
    cand = torch.empty((b, NUM_FILTERS, w, bpp), dtype=i32, device=dev)
    e0n5 = torch.empty((b, NUM_FILTERS, w + 5, 4), dtype=i32, device=dev)
    e1n5 = torch.empty_like(e0n5)
    e0w = torch.empty((b, w + 5, 4), dtype=i32, device=dev)
    e1w = torch.empty_like(e0w)
    ok = torch.empty(b, dtype=i32, device=dev) if adaptive else None
    lib = _build.library()
    with torch.cuda.device(dev):
        _build.check(lib.plk_image_rows(
            s.data_ptr(), bleed, w_real.data_ptr(), ofreq.data_ptr(),
            rows.data_ptr(), qprev0.data_ptr(), e00.data_ptr(),
            e10.data_ptr(), hist0.data_ptr(), qrows.data_ptr(),
            filt.data_ptr(), None if ok is None else ok.data_ptr(),
            cand.data_ptr(), e0n5.data_ptr(), e1n5.data_ptr(),
            e0w.data_ptr(), e1w.data_ptr(), b, h, w, bpp,
            _build.stream_ptr(rows)), "plk_image_rows")
    if adaptive:
        ADAPTIVE_LAUNCHES += 1
        return qrows, filt, ok
    LAUNCHES += 1
    return qrows, filt
