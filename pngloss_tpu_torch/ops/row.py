"""One strength attempt on one row of B images under all 5 filters.

Counterpart of ``pngloss_tpu/ops/pallas_row.py`` (``_row_kernel``). It
carries row 0 of every image (where the MSAD self-check and the strength
fallback live) and all of an image one row high. On a CUDA tensor
``row_attempt`` launches ``csrc/row.cu``; on a CPU tensor it runs
``row_attempt_ref``.
"""

from __future__ import annotations

import torch

from pngloss_tpu_torch.ops import _build
from pngloss_tpu_torch.ops.optimize import NUM_FILTERS
from pngloss_tpu_torch.ops.optimize import quantize_row as row_attempt_ref

LAUNCHES = 0


def row_attempt(s, bleed: int, orig, qprev, e0, e1, hist, ofreq, w_real):
    """s (B,) strengths; orig, qprev (B, W, bpp) int32; e0, e1 (B, W+5, 4)
    int32; hist (B, 256) int32; ofreq (B, 5, 256) int32; w_real (B,) int32.
    Returns qrow (B, 5, W, bpp), hist (B, 5, 256), e0n, e1n (B, 5, W+5, 4),
    all int32. A CUDA tensor launches the kernel; a CPU tensor runs the
    plain version."""
    global LAUNCHES
    if _build.route(orig) == "cpu":
        return row_attempt_ref(s, bleed, orig, qprev, e0, e1, hist, ofreq,
                               w_real)
    b, w, bpp = orig.shape
    i32 = torch.int32
    for t, name, shape in ((s, "s", (b,)), (orig, "orig", (b, w, bpp)),
                           (qprev, "qprev", (b, w, bpp)),
                           (e0, "e0", (b, w + 5, 4)), (e1, "e1", (b, w + 5, 4)),
                           (hist, "hist", (b, 256)),
                           (ofreq, "ofreq", (b, NUM_FILTERS, 256)),
                           (w_real, "w_real", (b,))):
        _build.require(t, name, i32, shape)
    if not 1 <= bpp <= 4 or bleed < 1:
        raise ValueError(f"bad bpp {bpp} or bleed {bleed}")
    dev = orig.device
    qrow = torch.empty((b, NUM_FILTERS, w, bpp), dtype=i32, device=dev)
    hist5 = torch.empty((b, NUM_FILTERS, 256), dtype=i32, device=dev)
    e0n = torch.empty((b, NUM_FILTERS, w + 5, 4), dtype=i32, device=dev)
    e1n = torch.empty_like(e0n)
    lib = _build.library()
    with torch.cuda.device(dev):
        _build.check(lib.plk_row_attempt(
            s.data_ptr(), bleed, w_real.data_ptr(), orig.data_ptr(),
            qprev.data_ptr(), e0.data_ptr(), e1.data_ptr(), hist.data_ptr(),
            ofreq.data_ptr(), qrow.data_ptr(), hist5.data_ptr(),
            e0n.data_ptr(), e1n.data_ptr(), b, w, bpp,
            _build.stream_ptr(orig)), "plk_row_attempt")
    LAUNCHES += 1
    return qrow, hist5, e0n, e1n
