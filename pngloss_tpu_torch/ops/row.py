"""One row of B images under all 5 filters.

Counterpart of ``pngloss_tpu/ops/pallas_row.py`` (``_row_kernel``) and of
the ``lax.while_loop`` over the strength that
``pngloss_tpu/ops/optimize_pallas.py:optimize_batch_pallas_t`` runs around
it for row 0, where the MSAD self-check and the strength fallback live:

  * ``row_attempt``: one strength attempt, the 5 candidates returned;
  * ``row_retry``: the row with its strength loop, the winner returned
    (``row0_retry`` from the zero state before row 0). It carries row 0 of
    every image in both modes and all of an image one row high.

On a CUDA tensor each launches ``csrc/row.cu`` (``row_retry`` once, the
loop on the device, no host sync); on a CPU tensor each runs its plain
version, ``row_attempt_ref`` or ``row_retry_ref`` (``strength_loop``
around ``row_attempt_ref``).
"""

from __future__ import annotations

import torch

from pngloss_tpu_torch.convert import Carry
from pngloss_tpu_torch.ops import _build
from pngloss_tpu_torch.ops.optimize import NUM_FILTERS, strength_loop
from pngloss_tpu_torch.ops.optimize import quantize_row as row_attempt_ref

# launches of the one-attempt and the strength-loop variant
LAUNCHES = 0
RETRY_LAUNCHES = 0


def zero_carry(b: int, w: int, bpp: int, device) -> Carry:
    """The state before row 0: zero rows, dither rows and histogram."""
    zrow = torch.zeros((b, w, bpp), dtype=torch.int32, device=device)
    zerr = torch.zeros((b, w + 5, 4), dtype=torch.int32, device=device)
    zhist = torch.zeros((b, 256), dtype=torch.int32, device=device)
    return Carry(zrow, zrow, zerr, zerr, zhist)


def _require_row(s, orig, qprev, e0, e1, hist, ofreq, w_real, bleed):
    b, w, bpp = orig.shape
    i32 = torch.int32
    for t, name, shape in ((s, "s", (b,)), (orig, "orig", (b, w, bpp)),
                           (qprev, "qprev", (b, w, bpp)),
                           (e0, "e0", (b, w + 5, 4)), (e1, "e1", (b, w + 5, 4)),
                           (hist, "hist", (b, 256)),
                           (ofreq, "ofreq", (b, NUM_FILTERS, 256)),
                           (w_real, "w_real", (b,))):
        _build.require(t, name, i32, shape)
    for t, name in ((e0, "e0"), (e1, "e1")):
        _build.require_aligned(t, name)
    if not 1 <= bpp <= 4 or bleed < 1:
        raise ValueError(f"bad bpp {bpp} or bleed {bleed}")


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
    _require_row(s, orig, qprev, e0, e1, hist, ofreq, w_real, bleed)
    b, w, bpp = orig.shape
    i32 = torch.int32
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


def row_retry_ref(s, bleed: int, orow, carry: Carry, ofreq, w_real,
                  never_pass=None):
    """Plain version of ``row_retry``: ``strength_loop`` around
    ``row_attempt_ref``, one host sync per attempt."""
    qprev, oprev, e0, e1, hist = carry

    def attempt(s_try):
        return row_attempt_ref(s_try, bleed, orow, qprev, e0, e1, hist,
                               ofreq, w_real)

    return strength_loop(attempt, s, orow, qprev, oprev, e0, e1, hist,
                         w_real, never_pass)


def row_retry(s, bleed: int, orow, carry: Carry, ofreq, w_real,
              never_pass=None):
    """One row that must pass the MSAD self-check, from the state ``carry``
    the previous row left: s (B,) strengths, orow (B, W, bpp) int32
    originals, the rest as for ``row_attempt``; never_pass (B,) int32,
    test-only (None in every production call): every filter fails the
    self-check in the images where it is not 0. Returns the winner's
    (q (B, W, bpp), hist (B, 256), e0n, e1n (B, W+5, 4)) int32, its filter
    id (B,) int64 and the attempts each image took (B,) int32, as
    ``strength_loop``. A CUDA tensor launches the kernel once; a CPU tensor
    runs the plain version."""
    global RETRY_LAUNCHES
    if _build.route(orow) == "cpu":
        return row_retry_ref(s, bleed, orow, carry, ofreq, w_real,
                             never_pass)
    qprev, oprev, e0, e1, hist = carry
    _require_row(s, orow, qprev, e0, e1, hist, ofreq, w_real, bleed)
    b, w, bpp = orow.shape
    _build.require(oprev, "oprev", torch.int32, (b, w, bpp))
    if never_pass is not None:
        _build.require(never_pass, "never_pass", torch.int32, (b,))
    i32 = torch.int32
    dev = orow.device
    # scratch: the 5 candidates' rows and next dither rows
    cand = torch.empty((b, NUM_FILTERS, w, bpp), dtype=i32, device=dev)
    e0n5 = torch.empty((b, NUM_FILTERS, w + 5, 4), dtype=i32, device=dev)
    e1n5 = torch.empty_like(e0n5)
    q = torch.empty((b, w, bpp), dtype=i32, device=dev)
    hist_out = torch.empty((b, 256), dtype=i32, device=dev)
    e0n = torch.empty((b, w + 5, 4), dtype=i32, device=dev)
    e1n = torch.empty_like(e0n)
    filt = torch.empty(b, dtype=torch.int64, device=dev)
    attempts = torch.empty(b, dtype=i32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        _build.check(lib.plk_row_retry(
            s.data_ptr(), bleed, w_real.data_ptr(), orow.data_ptr(),
            qprev.data_ptr(), oprev.data_ptr(), e0.data_ptr(), e1.data_ptr(),
            hist.data_ptr(), ofreq.data_ptr(),
            None if never_pass is None else never_pass.data_ptr(),
            cand.data_ptr(), e0n5.data_ptr(), e1n5.data_ptr(), q.data_ptr(),
            hist_out.data_ptr(), e0n.data_ptr(), e1n.data_ptr(),
            filt.data_ptr(), attempts.data_ptr(), b, w, bpp,
            _build.stream_ptr(orow)), "plk_row_retry")
    RETRY_LAUNCHES += 1
    return (q, hist_out, e0n, e1n), filt, attempts


def row0_retry(s, bleed: int, orig0, ofreq, w_real, never_pass=None):
    """``row_retry`` on row 0, from the zero state (``zero_carry``)."""
    b, w, bpp = orig0.shape
    return row_retry(s, bleed, orig0, zero_carry(b, w, bpp, orig0.device),
                     ofreq, w_real, never_pass)
