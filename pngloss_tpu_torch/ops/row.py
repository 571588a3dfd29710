"""One row of B images under all 5 filters.

Counterpart of ``pngloss_tpu/ops/pallas_row.py`` (``_row_kernel``) and of
the ``lax.while_loop`` over the strength that
``pngloss_tpu/ops/optimize_pallas.py:optimize_batch_pallas_t`` runs around
it for row 0, where the MSAD self-check and the strength fallback live:

  * ``row_attempt``: one strength attempt, the 5 candidates returned;
  * ``row_retry``: the row with its strength loop, the winner returned
    (``row0_retry`` from the zero state before row 0). It carries row 0 of
    every image in both modes and all of an image one row high. On the
    card it runs as a ladder: a thread-block cluster of k blocks per image
    tries k strengths at once (``ladder_size`` picks k from the batch size
    and bpp alone) and keeps the highest that passes.

On a CUDA tensor each launches ``csrc/row.cu`` (``row_retry`` once, the
loop on the device, no host sync); on a CPU tensor each runs its plain
version, ``row_attempt_ref`` or ``row_retry_ladder_ref`` (k strengths a
round, k = 1 unless given). ``row_retry_ref`` is the sequential plain
version, ``strength_loop`` around ``row_attempt_ref``, which the ladder is
held to.
"""

from __future__ import annotations

import ctypes

import torch

from pngloss_tpu_torch.convert import Carry
from pngloss_tpu_torch.ops import _build, ladder
from pngloss_tpu_torch.ops.ladder import check_rungs, ladder_round
from pngloss_tpu_torch.ops.optimize import (
    NUM_FILTERS,
    pick,
    replayable,
    row_cost,
    self_check,
    strength_loop,
)
from pngloss_tpu_torch.ops.optimize import quantize_row as row_attempt_ref

# launches of the one-attempt kernel and of the ladder (the strength loop)
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
                  never_pass=None, count=None):
    """Sequential plain version of ``row_retry``: ``strength_loop`` around
    ``row_attempt_ref``, one strength an attempt, one host sync per
    attempt; ``count`` as for ``quantize_row``, over every attempt. One
    attempt (the 5 candidates at the strengths in a fixed buffer) is
    captured once in a CUDA graph on a CUDA tensor, as in
    ``image.image_rows_retry_ref``."""
    qprev, oprev, e0, e1, hist = carry
    s_now = s.clone()
    step = replayable(
        lambda: row_attempt_ref(s_now, bleed, orow, qprev, e0, e1, hist,
                                ofreq, w_real, count), orow.device)

    def attempt(s_try):
        s_now.copy_(s_try)
        return step()

    return strength_loop(attempt, s, orow, qprev, oprev, e0, e1, hist,
                         w_real, never_pass)


def row_retry_ladder_ref(s, bleed: int, orow, carry: Carry, ofreq, w_real,
                         never_pass=None, k: int = 1, rounds=None):
    """Plain version of the ladder (``row_retry`` on the card); arguments
    as for ``row_retry``. The row runs in rounds: round j tries the k
    strengths s - j*k - r (r < k) from the same state, a strength below 0
    passing nothing, and keeps the highest that passes; where none does
    and the round reached strength 0, the strength-0 attempt with its
    minimum true cost. Returns what ``row_retry_ref`` returns, equal for
    every k: the attempts are the sequential loop's (s - s_win + 1);
    ``rounds`` (B,) int32, where given, gets the rounds each image took
    (ceil(attempts / k)). Strengths below 0 count as 0."""
    check_rungs(k)
    qprev, oprev, e0, e1, hist = carry
    b = orow.shape[0]
    dev = orow.device
    i32 = torch.int32
    s = s.to(i32).clamp(min=0)

    def rungs(t):
        """(B, ...) -> (B*k, ...): each image's row k times."""
        return t.repeat_interleave(k, 0)

    orow_k, qprev_k, oprev_k, e0_k, e1_k, hist_k, ofreq_k, w_k = (
        rungs(t) for t in (orow, qprev, oprev, e0, e1, hist, ofreq, w_real))
    flags_k = None if never_pass is None else rungs(never_pass)
    state = [t.clone() for t in (qprev, hist, e0, e1)]
    best = torch.zeros(b, dtype=torch.int64, device=dev)
    tries = torch.zeros(b, dtype=i32, device=dev)
    taken = torch.zeros(b, dtype=i32, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    rung = torch.arange(k, dtype=i32, device=dev)
    j = 0
    while True:
        strengths = s[:, None] - j * k - rung[None]                  # (B, k)
        q5, h5, e0n, e1n = row_attempt_ref(
            strengths.clamp(min=0).reshape(-1), bleed, orow_k, qprev_k,
            e0_k, e1_k, hist_k, ofreq_k, w_k)
        cost = row_cost(q5, hist_k, h5, qprev_k, orow_k, oprev_k, w_k)
        passing = (self_check(q5, qprev_k, w_k, flags_k)
                   & (strengths >= 0).reshape(-1, 1))
        decided, win, lane, bf = ladder_round(passing, cost, s, j, k)
        new = ~done & decided
        for old, cand in zip(state, (q5, h5, e0n, e1n)):
            keep = new.view(-1, *([1] * (old.dim() - 1)))
            old.copy_(torch.where(keep, pick(cand[lane], bf), old))
        best = torch.where(new, bf, best)
        tries += torch.where(new, j * k + win + 1, 0).to(i32)
        taken += torch.where(new, j + 1, 0).to(i32)
        done = done | new
        if bool(done.all()):
            break
        j += 1
    if rounds is not None:
        rounds.copy_(taken)
    return tuple(state), best, tries


def clusters(k: int, bpp: int) -> int:
    """The most clusters of k blocks of the row ladder at ``bpp`` that the
    current device keeps resident at once (``plk_row_ladder_clusters``)."""
    n = ctypes.c_int(0)
    _build.check(_build.library().plk_row_ladder_clusters(
        k, bpp, ctypes.addressof(n)), "plk_row_ladder_clusters")
    return n.value


def ladder_size(b: int, bpp: int, device) -> int:
    """The row ladder's cluster size for ``b`` images at ``bpp`` on a CUDA
    ``device``: ``ladder.pick_ladder`` over this kernel's ``clusters``.
    It depends on b and bpp alone, never on the data, so choosing it reads
    nothing from the card."""
    return ladder.ladder_size(clusters, b, bpp, device)


def row_retry(s, bleed: int, orow, carry: Carry, ofreq, w_real,
              never_pass=None, k=None, rounds=None):
    """One row that must pass the MSAD self-check, from the state ``carry``
    the previous row left: s (B,) strengths, orow (B, W, bpp) int32
    originals, the rest as for ``row_attempt``; never_pass (B,) int32,
    test-only (None in every production call): every filter fails the
    self-check in the images where it is not 0. ``k``: the ladder's
    strengths tried at once (None: ``ladder_size`` on the card, 1 on the
    CPU); ``rounds`` (B,) int32, where given, gets the rounds each image
    took. Returns the winner's (q (B, W, bpp), hist (B, 256), e0n, e1n
    (B, W+5, 4)) int32, its filter id (B,) int64 and the attempts each
    image took (B,) int32, as ``strength_loop``. A CUDA tensor launches the
    kernel once; a CPU tensor runs the plain ladder."""
    global RETRY_LAUNCHES
    if _build.route(orow) == "cpu":
        return row_retry_ladder_ref(s, bleed, orow, carry, ofreq, w_real,
                                    never_pass, 1 if k is None else k,
                                    rounds)
    qprev, oprev, e0, e1, hist = carry
    _require_row(s, orow, qprev, e0, e1, hist, ofreq, w_real, bleed)
    b, w, bpp = orow.shape
    i32 = torch.int32
    _build.require(oprev, "oprev", i32, (b, w, bpp))
    if never_pass is not None:
        _build.require(never_pass, "never_pass", i32, (b,))
    if rounds is not None:
        _build.require(rounds, "rounds", i32, (b,))
    dev = orow.device
    if k is None:
        k = ladder_size(b, bpp, dev)
    else:
        check_rungs(k)
    # scratch: each rung's 5 candidates' rows and next dither rows
    cand = torch.empty((b, k, NUM_FILTERS, w, bpp), dtype=i32, device=dev)
    e0n5 = torch.empty((b, k, NUM_FILTERS, w + 5, 4), dtype=i32, device=dev)
    e1n5 = torch.empty_like(e0n5)
    q = torch.empty((b, w, bpp), dtype=i32, device=dev)
    hist_out = torch.empty((b, 256), dtype=i32, device=dev)
    e0n = torch.empty((b, w + 5, 4), dtype=i32, device=dev)
    e1n = torch.empty_like(e0n)
    filt = torch.empty(b, dtype=torch.int64, device=dev)
    attempts = torch.empty(b, dtype=i32, device=dev)
    lib = _build.library()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        _build.check(lib.plk_row_retry(
            s.data_ptr(), bleed, w_real.data_ptr(), orow.data_ptr(),
            qprev.data_ptr(), oprev.data_ptr(), e0.data_ptr(), e1.data_ptr(),
            hist.data_ptr(), ofreq.data_ptr(), ptr(never_pass),
            cand.data_ptr(), e0n5.data_ptr(), e1n5.data_ptr(), q.data_ptr(),
            hist_out.data_ptr(), e0n.data_ptr(), e1n.data_ptr(),
            filt.data_ptr(), attempts.data_ptr(), ptr(rounds), b, w, bpp, k,
            _build.stream_ptr(orow)), "plk_row_retry")
    RETRY_LAUNCHES += 1
    return (q, hist_out, e0n, e1n), filt, attempts


def row0_retry(s, bleed: int, orig0, ofreq, w_real, never_pass=None,
               k=None, rounds=None):
    """``row_retry`` on row 0, from the zero state (``zero_carry``)."""
    b, w, bpp = orig0.shape
    return row_retry(s, bleed, orig0, zero_carry(b, w, bpp, orig0.device),
                     ofreq, w_real, never_pass, k, rounds)
