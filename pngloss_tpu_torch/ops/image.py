"""Rows 1..H-1 of every image in one launch.

Counterpart of ``pngloss_tpu/ops/pallas_image.py`` (``_image_kernel``).
Each row is one attempt under the 5 filters, the row cost (histogram-delta
bits plus derivative error / 128), the first-minimum winner, and the
winner's row, histogram and dither rows carried to the next row. Three
variants:

  * CLI mode (``adaptive=False``): only row 0 runs the MSAD self-check, so
    every row's attempt is final;
  * embedding mode's speculation (``adaptive=True``): every row runs the
    MSAD self-check at full strength, a failing candidate costs
    ``FAIL_COST``, and ``ok`` flags each image where some row had no
    passing filter. Such a row carries on with filter 0, as the TPU kernel
    does;
  * embedding mode's per-row path (``adaptive=True, retry=True``), the
    counterpart of the scan over rows with a while_loop over the strength
    in ``pngloss_tpu/ops/optimize_pallas.py:optimize_batch_pallas_t``:
    every row starts at the image's full strength and runs again one
    strength lower while no filter passes; at strength 0 the minimum true
    cost wins. It never fails, and reports the row attempts of each image
    as that sequential loop counts them. On the card it runs as a ladder:
    a cluster of k blocks per image tries k strengths of a row at once
    (``ladder_size`` picks k), and keeps the highest that passes.

On the card CLI mode has two layouts: one block of 5 warps per image, one
warp per filter, or, where every image the caller has in flight fits
(``pick_split``), the split layout: a cluster of ``SPLIT_SMS`` blocks per
image, each on an SM of its own, filters 0-3 on the first and filter 4 on
the second, so that no two filters share a scheduler.

Every variant stops at each image's last real row (``h_real``): padded
rows neither clear ``ok`` nor retry, and come out as 0.

At strength 0 a real row always has a passing filter (the 5 candidates are
then one row, and the MSAD choice is one of them); the test-only
``never_pass`` fails every filter of the images it flags, in the adaptive
and the retry variant alike, so that the give-up rule runs.

On a CUDA tensor ``image_rows`` launches ``csrc/image.cu``; on a CPU tensor
it runs ``image_rows_ref`` or ``image_rows_ladder_ref``.
``image_rows_retry_ref`` is the retry variant's sequential plain version,
``strength_loop`` one strength at a time, which the ladder is held to.
"""

from __future__ import annotations

import ctypes

import torch

from pngloss_tpu_torch import tracing
from pngloss_tpu_torch.ops import _build, ladder
from pngloss_tpu_torch.ops.ladder import check_rungs, ladder_round
from pngloss_tpu_torch.ops.optimize import (
    NUM_FILTERS,
    adaptive_cost,
    first_min,
    pick,
    quantize_row,
    replayable,
    row_cost,
    self_check,
    strength_loop,
)

# launches of the kernel's CLI, adaptive and retry (ladder) variants, and
# of the CLI variant's launches those that took the split layout
LAUNCHES = 0
ADAPTIVE_LAUNCHES = 0
RETRY_LAUNCHES = 0
SPLIT_LAUNCHES = 0
# SMs an image takes in the split layout (split::kBlocks in csrc/image.cu)
SPLIT_SMS = 2
# (device index, bpp) -> clusters of the split layout the card keeps
# resident at once
_SPLIT_RESIDENT: dict = {}


def _heights(h_real, b: int, h: int, device) -> torch.Tensor:
    """(B,) int32 real heights within 1..H; every row real where None."""
    if h_real is None:
        return torch.full((b,), h, dtype=torch.int32, device=device)
    return h_real.to(device=device, dtype=torch.int32).clamp(1, h)


def image_rows_ref(s, bleed: int, w_real, ofreq, rows, qprev0, e00, e10,
                   hist0, adaptive: bool = False, count=None,
                   never_pass=None, h_real=None, carry_out: bool = False):
    """Plain version; arguments as for ``image_rows``; ``count`` as for
    ``quantize_row``, over rows 1..H-1 (padded rows too). With
    ``carry_out`` (CLI mode) it also returns the state each image's last
    real row leaves, as ``image_rows`` does.

    The row step (the 5 candidates, and with ``adaptive`` their MSAD
    self-check) reads and writes fixed buffers. On a CUDA tensor it is
    captured once in a CUDA graph and replayed for every row after the
    first few (``replayable``): the same kernels on the same data, without
    the ~80k host launches per 512-px RGB row of an eager run."""
    b, h, wb = rows.shape
    w, bpp = qprev0.shape[1], qprev0.shape[2]
    dev = rows.device
    qrows = torch.zeros((b, h - 1, w, bpp), dtype=torch.int32, device=dev)
    filts = torch.zeros((b, h - 1), dtype=torch.int32, device=dev)
    ok = torch.ones(b, dtype=torch.int32, device=dev)
    hr = _heights(h_real, b, h, dev)
    # the state after each image's last real row (qprev, e0, e1, hist)
    carry = [t.clone() for t in (qprev0, e00, e10, hist0)]
    if h >= 2:
        orig = rows.view(b, h, w, bpp).to(torch.int32)
        orow, qprev, e0, e1, hist = (t.clone() for t in
                                     (orig[:, 1], qprev0, e00, e10, hist0))

        def row_step():
            q5, h5, e0n, e1n = quantize_row(s, bleed, orow, qprev, e0, e1,
                                            hist, ofreq, w_real, count)
            passing = (self_check(q5, qprev, w_real, never_pass)
                       if adaptive else None)
            return q5, h5, e0n, e1n, passing

        step = replayable(row_step, dev)
        for y in range(1, h):
            orow.copy_(orig[:, y])
            q5, h5, e0n, e1n, passing = step()
            cost = row_cost(q5, hist, h5, qprev, orow, orig[:, y - 1],
                            w_real)
            live = hr > y
            if adaptive:
                cost = adaptive_cost(cost, passing)
                ok &= (passing.any(1) | ~live).to(torch.int32)
            best = first_min(cost)
            for buf, cand in ((qprev, q5), (hist, h5), (e0, e0n),
                              (e1, e1n)):
                buf.copy_(pick(cand, best))
            qrows[:, y - 1] = torch.where(live[:, None, None], qprev, 0)
            filts[:, y - 1] = torch.where(live, best, 0)
            if carry_out:
                last = hr - 1 == y
                for kept, buf in zip(carry, (qprev, e0, e1, hist)):
                    at = last.view(-1, *([1] * (buf.dim() - 1)))
                    kept.copy_(torch.where(at, buf, kept))
    if adaptive:
        return qrows, filts, ok
    return (qrows, filts, tuple(carry)) if carry_out else (qrows, filts)


def image_rows_retry_ref(s, bleed: int, w_real, ofreq, rows, qprev0, e00,
                         e10, hist0, count=None, never_pass=None,
                         h_real=None):
    """Sequential plain version of the retry variant, one strength at a
    time; arguments as for ``image_rows``; ``count`` as for
    ``quantize_row``, over every attempt of rows 1..H-1. Returns the winner
    rows, their filter ids and the row attempts each image took (B,) int32.

    One attempt (the 5 candidates at the strengths in a fixed buffer) is
    captured once in a CUDA graph on a CUDA tensor, as in
    ``image_rows_ref``; the strength loop around it is ``strength_loop``."""
    b, h, wb = rows.shape
    w, bpp = qprev0.shape[1], qprev0.shape[2]
    dev = rows.device
    qrows = torch.zeros((b, h - 1, w, bpp), dtype=torch.int32, device=dev)
    filts = torch.zeros((b, h - 1), dtype=torch.int32, device=dev)
    tries = torch.zeros(b, dtype=torch.int32, device=dev)
    hr = _heights(h_real, b, h, dev)
    if h >= 2:
        orig = rows.view(b, h, w, bpp).to(torch.int32)
        orow, qprev, e0, e1, hist, s_now = (
            t.clone() for t in (orig[:, 1], qprev0, e00, e10, hist0, s))

        def quantize():
            return quantize_row(s_now, bleed, orow, qprev, e0, e1, hist,
                                ofreq, w_real, count)

        step = replayable(quantize, dev)

        def attempt(s_try):
            s_now.copy_(s_try)
            return step()

        for y in range(1, h):
            live = hr > y
            if not bool(live.any()):
                break
            orow.copy_(orig[:, y])
            state, best, n = strength_loop(attempt, s, orow, qprev,
                                           orig[:, y - 1], e0, e1, hist,
                                           w_real, never_pass, live)
            for buf, won in zip((qprev, hist, e0, e1), state):
                buf.copy_(won)
            qrows[:, y - 1] = torch.where(live[:, None, None], qprev, 0)
            filts[:, y - 1] = torch.where(live, best, 0)
            tries += n
    return qrows, filts, tries


def image_rows_ladder_ref(s, bleed: int, w_real, ofreq, rows, qprev0, e00,
                          e10, hist0, k: int = 1, never_pass=None,
                          h_real=None, rounds=None, count=None):
    """Plain version of the ladder (the retry variant on the card);
    arguments as for ``image_rows``. Each row runs in rounds: round j tries
    the k strengths s - j*k - r (r < k) from the same state, a strength
    below 0 passing nothing, and keeps the highest that passes; where none
    does and the round reached strength 0, the strength-0 attempt with its
    minimum true cost. Returns the winner rows, their filter ids and the
    attempts the sequential loop would take (s - s_win + 1 a row), which
    equal ``image_rows_retry_ref``'s for every k; ``rounds`` (B,) int32,
    where given, gets the rounds each image took. Strengths below 0 count
    as 0. ``count`` as for ``quantize_row``, over the attempts the
    sequential loop takes (the rungs below a round's winner are not
    counted), so it equals ``image_rows_retry_ref``'s.

    One round (the k attempts of every image as one batch of B*k, and
    their self-check) is captured once in a CUDA graph on a CUDA tensor,
    as in ``image_rows_ref``."""
    check_rungs(k)
    b, h, wb = rows.shape
    w, bpp = qprev0.shape[1], qprev0.shape[2]
    dev = rows.device
    i32 = torch.int32
    qrows = torch.zeros((b, h - 1, w, bpp), dtype=i32, device=dev)
    filts = torch.zeros((b, h - 1), dtype=i32, device=dev)
    tries = torch.zeros(b, dtype=i32, device=dev)
    taken = torch.zeros(b, dtype=i32, device=dev)
    hr = _heights(h_real, b, h, dev)
    s = s.to(i32).clamp(min=0)
    if h >= 2:
        orig = rows.view(b, h, w, bpp).to(i32)

        def rungs(t):
            """(B, ...) -> (B*k, ...): each image's row k times."""
            return t.repeat_interleave(k, 0)

        orow, oprev, qprev, e0, e1, hist, s_now = (
            rungs(t) for t in (orig[:, 1], orig[:, 0], qprev0, e00, e10,
                               hist0, s))
        ofreq_k, w_k = rungs(ofreq), rungs(w_real)
        flags_k = None if never_pass is None else rungs(never_pass)

        # each rung's band candidates in the round (count)
        scanned = torch.zeros(b * k, dtype=torch.int64, device=dev)

        def attempt():
            q5, h5, e0n, e1n = quantize_row(
                s_now, bleed, orow, qprev, e0, e1, hist, ofreq_k, w_k,
                None if count is None else scanned)
            return q5, h5, e0n, e1n, self_check(q5, qprev, w_k, flags_k)

        step = replayable(attempt, dev)
        rung = torch.arange(k, dtype=i32, device=dev)
        for y in range(1, h):
            done = hr <= y
            if bool(done.all()):
                break
            orow.copy_(rungs(orig[:, y]))
            oprev.copy_(rungs(orig[:, y - 1]))
            j = 0
            while True:
                strengths = s[:, None] - j * k - rung[None]          # (B, k)
                s_now.copy_(strengths.clamp(min=0).reshape(-1))
                scanned.zero_()
                q5, h5, e0n, e1n, passing = step()
                cost = row_cost(q5, hist, h5, qprev, orow, oprev, w_k)
                passing = passing & (strengths >= 0).reshape(-1, 1)
                decided, win, lane, best = ladder_round(
                    passing, cost, s, j, k)
                if count is not None:
                    # the rungs up to the winner (all, if none won) of the
                    # images still running, at strengths 0 and up
                    last = torch.where(decided, win, k - 1)
                    needed = ((rung[None] <= last[:, None]) & ~done[:, None]
                              & (strengths >= 0))
                    count += (scanned.view(b, k) * needed).sum()
                new = ~done & decided
                won = [pick(t[lane], best) for t in (q5, h5, e0n, e1n)]
                for buf, new_t in zip((qprev, hist, e0, e1), won):
                    keep = rungs(new).view(-1, *([1] * (buf.dim() - 1)))
                    buf.copy_(torch.where(keep, rungs(new_t), buf))
                qrows[:, y - 1] = torch.where(new[:, None, None], won[0],
                                              qrows[:, y - 1])
                filts[:, y - 1] = torch.where(new, best.to(i32),
                                              filts[:, y - 1])
                tries += torch.where(new, j * k + win + 1, 0).to(i32)
                taken += torch.where(new, j + 1, 0).to(i32)
                done = done | new
                if bool(done.all()):
                    break
                j += 1
    if rounds is not None:
        rounds.copy_(taken)
    return qrows, filts, tries


def clusters(k: int, bpp: int) -> int:
    """The most clusters of k blocks of the ladder at ``bpp`` that the
    current device keeps resident at once (``plk_ladder_clusters``)."""
    n = ctypes.c_int(0)
    _build.check(_build.library().plk_ladder_clusters(
        k, bpp, ctypes.addressof(n)), "plk_ladder_clusters")
    return n.value


def ladder_size(b: int, bpp: int, device) -> int:
    """The ladder's cluster size for ``b`` images at ``bpp`` on a CUDA
    ``device``: ``ladder.pick_ladder`` over this kernel's ``clusters``."""
    return ladder.ladder_size(clusters, b, bpp, device)


def pick_split(n: int, resident: int, sms: int) -> bool:
    """Whether CLI mode takes the split layout while ``n`` images are in
    flight on the card at once: each image on a cluster of SPLIT_SMS SMs,
    so the n clusters must all be resident at once (``resident`` of them,
    cudaOccupancyMaxActiveClusters) on SMs of their own (``SPLIT_SMS`` * n
    <= ``sms``). Otherwise an image's 5 chains share one SM, and images that
    queued behind each other would take longer than that."""
    return 0 < n and n * SPLIT_SMS <= sms and n <= resident


def split_clusters(bpp: int) -> int:
    """The most clusters of the split layout at ``bpp`` that the current
    device keeps resident at once (``plk_split_clusters``)."""
    n = ctypes.c_int(0)
    _build.check(_build.library().plk_split_clusters(
        bpp, ctypes.addressof(n)), "plk_split_clusters")
    return n.value


def takes_split(n: int, bpp: int, device) -> bool:
    """``pick_split`` for ``n`` images in flight at ``bpp`` on a CUDA
    ``device``, over the split kernel's own occupancy query, made once per
    device and bpp."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if (idx, bpp) not in _SPLIT_RESIDENT:
        with torch.cuda.device(idx):
            _SPLIT_RESIDENT[idx, bpp] = split_clusters(bpp)
    sms = torch.cuda.get_device_properties(idx).multi_processor_count
    return pick_split(n, _SPLIT_RESIDENT[idx, bpp], sms)


def image_rows(s, bleed: int, w_real, ofreq, rows, qprev0, e00, e10, hist0,
               adaptive: bool = False, retry: bool = False, never_pass=None,
               h_real=None, k=None, rounds=None, in_flight=None,
               carry_out: bool = False):
    """s, w_real (B,) int32; ofreq (B, 5, 256) int32; rows (B, H, W*bpp)
    uint8 originals of the whole images; the row-0 winner state: qprev0
    (B, W, bpp), e00, e10 (B, W+5, 4), hist0 (B, 256), all int32.
    Returns the winner rows 1..H-1 (B, H-1, W, bpp) int32 and their filter
    ids (B, H-1) int32; with ``adaptive`` also ok (B,) int32, 0 for an
    image where some row had no filter passing the MSAD self-check; with
    ``adaptive`` and ``retry`` instead attempts (B,) int32, the row
    attempts each image took (rows, when every row passed at full
    strength). h_real (B,) int32, where given: each image's real height;
    rows at and after it are not run and come out as 0 (None: every row
    is real). never_pass (B,) int32, test-only (None in every production
    call), with ``adaptive``: every filter fails the self-check on every
    row of the images where it is not 0. With ``retry``: ``k``, the
    ladder's strengths tried at once (None: ``ladder_size`` on the card, 1
    on the CPU), and ``rounds`` (B,) int32, where given, gets the rounds
    each image took. In CLI mode: ``in_flight``, the images the caller
    has on the card at once, this launch's among them (None: this launch's
    B), which pick the layout (``takes_split``); while tracing, the
    launch's images and those of them that took the split layout are
    counted to the open request (``image.images``, ``image.split``). With
    ``carry_out`` (CLI mode; on the card the split layout) it returns,
    third, the state each image's last real row leaves (row 0's where it
    has no other), (qprev (B, W, bpp), e0, e1 (B, W+5, 4), hist (B, 256)),
    which a call on the rows after it takes as its row-0 state: the rows of
    one image in bands, band by band, give one call's rows. Such a launch
    is a band, not an image: its caller counts the image. A CUDA tensor
    launches the kernel; a CPU tensor runs the plain version."""
    global LAUNCHES, ADAPTIVE_LAUNCHES, RETRY_LAUNCHES, SPLIT_LAUNCHES
    if retry and not adaptive:
        raise ValueError("retry needs adaptive: only the MSAD self-check "
                         "can fail a row")
    if never_pass is not None and not adaptive:
        raise ValueError("never_pass needs adaptive: only the MSAD "
                         "self-check can fail a row")
    if (k is not None or rounds is not None) and not retry:
        raise ValueError("k and rounds are the retry variant's")
    if (in_flight is not None or carry_out) and adaptive:
        raise ValueError("in_flight and carry_out are CLI mode's")
    if _build.route(rows) == "cpu":
        if retry:
            return image_rows_ladder_ref(s, bleed, w_real, ofreq, rows,
                                         qprev0, e00, e10, hist0,
                                         1 if k is None else k, never_pass,
                                         h_real, rounds)
        return image_rows_ref(s, bleed, w_real, ofreq, rows, qprev0, e00,
                              e10, hist0, adaptive, never_pass=never_pass,
                              h_real=h_real, carry_out=carry_out)
    b, h, wb = rows.shape
    w, bpp = qprev0.shape[1], qprev0.shape[2]
    if h < 2 or w * bpp != wb or not 1 <= bpp <= 4 or bleed < 1:
        raise ValueError(f"bad shape {tuple(rows.shape)}, bpp {bpp} or "
                         f"bleed {bleed}")
    i32 = torch.int32
    dev = rows.device
    if h_real is None:
        h_real = torch.full((b,), h, dtype=i32, device=dev)
    _build.require(rows, "rows", torch.uint8, (b, h, wb))
    for t, name, shape in ((s, "s", (b,)), (w_real, "w_real", (b,)),
                           (h_real, "h_real", (b,)),
                           (ofreq, "ofreq", (b, NUM_FILTERS, 256)),
                           (qprev0, "qprev0", (b, w, bpp)),
                           (e00, "e00", (b, w + 5, 4)),
                           (e10, "e10", (b, w + 5, 4)),
                           (hist0, "hist0", (b, 256))):
        _build.require(t, name, i32, shape)
    if never_pass is not None:
        _build.require(never_pass, "never_pass", i32, (b,))
    if rounds is not None:
        _build.require(rounds, "rounds", i32, (b,))
    for t, name in ((e00, "e00"), (e10, "e10")):
        _build.require_aligned(t, name)
    if not retry:
        k = 1
    elif k is None:
        k = ladder_size(b, bpp, dev)
    else:
        check_rungs(k)
    qrows = torch.empty((b, h - 1, w, bpp), dtype=i32, device=dev)
    filt = torch.empty((b, h - 1), dtype=i32, device=dev)
    # scratch: two sets of the k rungs' 5 candidates' rows and next dither
    # rows; each row writes one set and reads the winner's from the other
    cand = torch.empty((2, b, k, NUM_FILTERS, w, bpp), dtype=i32, device=dev)
    e0n5 = torch.empty((2, b, k, NUM_FILTERS, w + 5, 4), dtype=i32,
                       device=dev)
    e1n5 = torch.empty_like(e0n5)
    ok = (torch.empty(b, dtype=i32, device=dev)
          if adaptive and not retry else None)
    attempts = torch.empty(b, dtype=i32, device=dev) if retry else None
    lib = _build.library()
    split = not adaptive and takes_split(max(b, in_flight or 0), bpp, dev)
    if carry_out and not split:
        raise ValueError("carry_out needs the split layout")
    we = (w + 5) * 4
    carry = (torch.empty(b * (256 + 2 * we + w * bpp), dtype=i32,
                         device=dev) if carry_out else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    inputs = (s.data_ptr(), bleed, w_real.data_ptr(), h_real.data_ptr(),
              ofreq.data_ptr(), rows.data_ptr(), qprev0.data_ptr(),
              e00.data_ptr(), e10.data_ptr(), hist0.data_ptr(),
              qrows.data_ptr(), filt.data_ptr())
    scratch = (cand.data_ptr(), e0n5.data_ptr(), e1n5.data_ptr(), b, h, w,
               bpp)
    with torch.cuda.device(dev):
        if split:
            _build.check(lib.plk_image_split(
                *inputs, ptr(carry), *scratch, _build.stream_ptr(rows)),
                "plk_image_split")
        else:
            _build.check(lib.plk_image_rows(
                *inputs, ptr(ok), ptr(attempts), ptr(rounds),
                ptr(never_pass), *scratch, k, _build.stream_ptr(rows)),
                "plk_image_rows")
    if retry:
        RETRY_LAUNCHES += 1
        return qrows, filt, attempts
    if adaptive:
        ADAPTIVE_LAUNCHES += 1
        return qrows, filt, ok
    LAUNCHES += 1
    SPLIT_LAUNCHES += split
    if not carry_out:
        tracing.count("image.images", b)
        tracing.count("image.split", b if split else 0)
        return qrows, filt
    hist, e0, e1, qprev = carry.split([b * 256, b * we, b * we, b * w * bpp])
    return qrows, filt, (qprev.view(b, w, bpp), e0.view(b, w + 5, 4),
                         e1.view(b, w + 5, 4), hist.view(b, 256))
