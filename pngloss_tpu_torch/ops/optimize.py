"""Plain PyTorch core of the pngloss row optimizer (CLI and embedding modes).

The counterpart of ``pngloss_tpu/ops/optimize.py``. It holds the exact
integer semantics of the reference C tool (optimize_state.c,
pngloss_image.c, color_delta.c) as tensor code that runs on any device,
and it is the plain version every CUDA kernel of the port is checked
against:

  * the five PNG predictors with the +-256 wrap of the original residual;
  * the band of candidate symbols (truncating division by s+1, clamp,
    exact-saturation fallback) and the three-level selection over the
    modular band u = (t - start) & 0xFF: adaptive frequency, then original
    frequency, then the original symbol, then the lowest u;
  * the transparent-pixel rule (alpha of bpp 2 and 4; the emitted symbol
    uses the unwrapped predictor);
  * Sierra-lite diffusion with C truncating division into three dither
    rows of W+5 columns (the carried error of pixel x sits at column x+2);
  * the row cost: histogram-delta bits plus the derivative error / 128;
  * libpng's MSAD self-check and the first-minimum winner;
  * the strength loop of a row that must pass the self-check.

Layouts: a row is (B, W, bpp) int32; candidate rows of the 5 filters are
(B, 5, W, bpp); dither rows are (B, W+5, 4) per image and (B, 5, W+5, 4)
per candidate; histograms are (B, 256) per image and (B, 5, 256) per
candidate. The pixel loop is a Python loop over W; every step works on all
(image, filter) lanes at once. ``w_real`` (B,) masks padded columns of a
ragged batch: a padded pixel counts in no histogram, diffuses nothing and
is left out of the cost and the MSAD.
"""

from __future__ import annotations

import torch

NUM_FILTERS = 5
# dither lanes read back by each channel: gray+alpha's alpha reads lane 3
# (color_delta.c:9-39)
_DITHER_LANE = {1: (0,), 2: (0, 3), 3: (0, 1, 2), 4: (0, 1, 2, 3)}
# channel feeding each of the 4 dither lanes (None = lane stays zero)
_LANE_SOURCE = {1: (0, 0, 0, None), 2: (0, 0, 0, 1),
                3: (0, 1, 2, None), 4: (0, 1, 2, 3)}
# how many of the 4 color_delta lanes each channel feeds (derivative error)
_CHANNEL_WEIGHT = {1: (3,), 2: (3, 1), 3: (1, 1, 1), 4: (1, 1, 1, 1)}


def tdiv(a: torch.Tensor, b) -> torch.Tensor:
    """C division: truncates toward zero (torch's // floors)."""
    return torch.div(a, b, rounding_mode="trunc")


def predict(above, diag, left, f: torch.Tensor):
    """PNG predictor of filter ids ``f`` (optimize_state.c:575-613) on
    quantized neighbour bytes; every argument broadcasts."""
    p = above - diag
    pd = left - diag
    pa, pb, pc = p.abs(), pd.abs(), (p + pd).abs()
    paeth = torch.where((pa <= pb) & (pa <= pc), left,
                        torch.where(pb <= pc, above, diag))
    zero = torch.zeros_like(paeth)
    return torch.where(f == 1, left, torch.where(
        f == 2, above, torch.where(f == 3, (above + left) >> 1,
                                   torch.where(f == 4, paeth, zero))))


def shift_right(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Shift one step along ``dim`` toward higher indices, zero-filled."""
    lead = a.narrow(dim, 0, 1)
    return torch.cat([torch.zeros_like(lead),
                      a.narrow(dim, 0, a.shape[dim] - 1)], dim)


def column_mask(w_real: torch.Tensor, w: int) -> torch.Tensor:
    """(B, W) int32: 1 for the real columns of each image."""
    cols = torch.arange(w, device=w_real.device)
    return (cols[None, :] < w_real[:, None]).to(torch.int32)


def filter_ids(device) -> torch.Tensor:
    return torch.arange(NUM_FILTERS, dtype=torch.int32, device=device)


def residual_symbols(imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W, bpp) int32 originals -> (B, 5, H, W, bpp) residual bytes
    under each filter, predicted from the ORIGINAL neighbours (the init
    pre-pass, optimize_state.c:66-83)."""
    above = shift_right(imgs, 1)
    left = shift_right(imgs, 2)
    diag = shift_right(above, 2)
    f = filter_ids(imgs.device).view(1, NUM_FILTERS, 1, 1, 1)
    pred = predict(above[:, None], diag[:, None], left[:, None], f)
    return (imgs[:, None] - pred) & 0xFF


def quantize_row(s, bleed: int, orig, qprev, e0, e1, hist, ofreq, w_real,
                 count=None):
    """One strength attempt on one row of B images under all 5 filters
    (optimize_state_row's pixel loop, optimize_state.c:114-313).

    s (B,) int32 strength per image; orig, qprev (B, W, bpp) int32 original
    row and quantized previous row (zeros at row 0); e0, e1 (B, W+5, 4)
    dither rows 0 and 1 at row start (row 2 starts zero); hist (B, 256)
    adaptive histogram; ofreq (B, 5, 256) original-residual histograms;
    w_real (B,) real widths. ``count``, when given, is a 0-d int64 tensor
    to which the band candidates scanned at real, non-transparent channel
    steps are added: the data-dependent part of the work (chip_smoke.py's
    operation count); a (B,) int64 tensor gets each image's count.

    Returns qrow (B, 5, W, bpp), hist (B, 5, 256), and the next row's
    dither rows e0n, e1n (B, 5, W+5, 4): the buffer shift of
    optimize_state.c:344-351 is built in.
    """
    b, w, bpp = orig.shape
    dev = orig.device
    f = filter_ids(dev).view(1, NUM_FILTERS)
    s = s.view(b, 1).to(torch.int32)
    band = s + 1
    hist = hist[:, None, :].expand(b, NUM_FILTERS, 256).clone()
    lanes5 = (b, NUM_FILTERS, w + 5, 4)
    err0 = e0[:, None].expand(lanes5).clone()
    err1 = e1[:, None].expand(lanes5).clone()
    err2 = torch.zeros(lanes5, dtype=torch.int32, device=dev)
    qrow = torch.zeros((b, NUM_FILTERS, w, bpp), dtype=torch.int32,
                       device=dev)
    cmask = column_mask(w_real, w)
    iota = torch.arange(256, dtype=torch.int32, device=dev).view(1, 1, 256)
    zero = torch.zeros((b, NUM_FILTERS), dtype=torch.int32, device=dev)

    for x in range(w):
        cm = cmask[:, x:x + 1]                                   # (B, 1)
        backs, heres = [], []
        for c in range(bpp):
            above = qprev[:, x, c:c + 1]
            diag = qprev[:, x - 1, c:c + 1] if x else zero[:, :1]
            left = qrow[:, :, x - 1, c] if x else zero
            pred = predict(above, diag, left, f)                 # (B, 5)
            orig_c = orig[:, x, c:c + 1]
            here = orig_c + err0[:, :, x + 2, _DITHER_LANE[bpp][c]]

            osym = orig_c - pred
            predw = pred + 256 * ((osym > 127).int() - (osym < -128).int())
            osym = orig_c - predw
            filt = here - predw

            q = filt.abs() // band
            mn = torch.where(filt < 0, -q * band - s, q * band)
            mx = mn + s
            mn = torch.where(mn + predw < 0, -predw, mn)
            mx = torch.where(mx + predw > 255, 255 - predw, mx)
            inv = mx < mn
            over = inv & (filt + predw > 255)
            under = inv & (filt + predw < 0)
            mn = torch.where(over, 255 - predw, torch.where(under, -predw, mn))
            mx = torch.where(over, 255 - predw, torch.where(under, -predw, mx))

            # three-level selection over u = (t - start) & 0xFF, the
            # symbol's offset in the band (optimize_state.c:183-248)
            start = mn & 0xFF
            width = mx - mn
            u_orig = osym - mn
            u = (iota - start[..., None]) & 0xFF                 # (B, 5, 256)
            m1 = u <= width[..., None]
            fmax = torch.where(m1, hist, -1).amax(-1, keepdim=True)
            m2 = m1 & (hist == fmax)
            omax = torch.where(m2, ofreq, -1).amax(-1, keepdim=True)
            m3 = m2 & (ofreq == omax)
            u_adj = torch.where(u == u_orig[..., None], -1, u)
            sel = torch.where(m3, u_adj, 256).amin(-1)
            u_best = torch.where(sel < 0, u_orig, sel)
            sym = (start + u_best) & 0xFF
            back = u_best + mn + predw

            scanned = (width + 1) * cm
            if bpp % 2 == 0 and c == bpp - 1:
                # fully transparent pixels stay fully transparent; the
                # emitted symbol uses the UNwrapped predictor (:158-164)
                transp = orig_c == 0
                back = torch.where(transp, 0, back)
                here = torch.where(transp, 0, here)
                sym = torch.where(transp, (0 - pred) & 0xFF, sym)
                scanned = torch.where(transp, 0, scanned)
            if count is not None:
                count += scanned.sum() if count.dim() == 0 else scanned.sum(1)

            hist.scatter_add_(2, sym[..., None].long(),
                              cm.expand(b, NUM_FILTERS)[..., None])
            qrow[:, :, x, c] = back
            backs.append(back)
            heres.append(here)

        # Sierra diffusion with C truncating division
        # (diffuse_color_error, optimize_state.c:390-490)
        lanes = [zero if src is None else heres[src] - backs[src]
                 for src in _LANE_SOURCE[bpp]]
        d = tdiv(torch.stack(lanes, -1), bleed) * cm[..., None]  # (B, 5, 4)
        twos = tdiv(d, 16)
        d = d - twos * 4
        threes = tdiv(d, 8)
        d = d - threes * 2
        fours = tdiv(d * 2, 9)
        d = d - fours * 2
        five = tdiv(d, 2)
        d = d - five
        err1[:, :, x] += twos
        err1[:, :, x + 4] += twos
        err2[:, :, x + 1] += twos
        err2[:, :, x + 3] += twos
        err0[:, :, x + 4] += threes
        err2[:, :, x + 2] += threes
        err1[:, :, x + 1] += fours
        err1[:, :, x + 3] += fours
        err1[:, :, x + 2] += five
        err0[:, :, x + 3] += d
    return qrow, hist, err1, err2


def _bitlength(n: torch.Tensor) -> torch.Tensor:
    """Bit length of positive integers (exact: frexp on float64)."""
    return torch.frexp(n.to(torch.float64))[1].to(torch.int64)


def row_cost(qrow5, hist_in, hist5, qprev, orow, oprev, w_real):
    """(B, 5) int64 row cost of each candidate (optimize_state.c:314-361):
    sum over emitted symbols of 65 - bitlength(freq) on the final
    histogram, computed as sum_t (hist_out - hist_in)[t] * bits[t], plus
    the derivative error / 128."""
    counts = (hist5 - hist_in[:, None]).to(torch.int64)
    freq = hist5.to(torch.int64)
    bits = torch.where(freq > 0, 65 - _bitlength(freq.clamp(min=1)), 0)
    cost = (counts * bits).sum(-1)

    bpp = orow.shape[2]
    wgt = torch.tensor(_CHANNEL_WEIGHT[bpp], dtype=torch.int64,
                       device=orow.device)
    q = qrow5.to(torch.int64)
    o = orow.to(torch.int64)[:, None]

    def dist(new, old):
        d = (q - new) - (o - old)
        return (d * d * wgt).sum(-1)                         # (B, 5, W)

    qp = qprev.to(torch.int64)[:, None]
    op = oprev.to(torch.int64)[:, None]
    e = (dist(qp, op) + dist(shift_right(qp, 2), shift_right(op, 2))
         + dist(shift_right(q, 2), shift_right(o, 2)))
    e = e * column_mask(w_real, orow.shape[1])[:, None]
    return cost + e.sum(-1) // 128


def msad_valid(qrow5, qprev, w_real):
    """(B, 5) bool: does each candidate row pass libpng's MSAD heuristic
    for its own filter (adaptive_filter_for_rows, optimize_state.c:492-562;
    ties resolve to the earliest trial filter)?"""
    above = qprev[:, None]
    diag = shift_right(above, 2)
    left = shift_right(qrow5, 2)
    mask = column_mask(w_real, qrow5.shape[2])[:, None, :, None]
    sums = []
    trials = filter_ids(qrow5.device)     # no host copy: CUDA-graph safe
    for t in range(NUM_FILTERS):
        v = (qrow5 - predict(above, diag, left, trials[t])) & 0xFF
        v = torch.where(v < 128, v, 256 - v)
        sums.append((v * mask).sum((-1, -2)))
    chosen = torch.stack(sums, -1).argmin(-1)                # first minimum
    return chosen == filter_ids(qrow5.device).long()


def self_check(qrow5, qprev, w_real, never_pass=None):
    """``msad_valid``, with every candidate failing in the images where
    ``never_pass`` (B,) is not 0: a test-only way to fail every filter of
    a row, which no real row does at strength 0."""
    passing = msad_valid(qrow5, qprev, w_real)
    if never_pass is None:
        return passing
    return passing & (never_pass == 0)[:, None]


# the cost of a candidate that fails the MSAD self-check: UINTMAX_MAX in
# the C code (optimize_state.c:319-324), above every real cost
FAIL_COST = torch.iinfo(torch.int64).max


def adaptive_cost(cost, passing):
    """(B, 5) cost with failing candidates at FAIL_COST, so ``first_min``
    picks the first passing minimum, and filter 0 where none passes."""
    return torch.where(passing, cost, FAIL_COST)


def pick(arr5: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """Select each image's winning candidate: (B, 5, ...) -> (B, ...)."""
    idx = best.long().view(-1, *([1] * (arr5.dim() - 1)))
    idx = idx.expand(-1, 1, *arr5.shape[2:])
    return arr5.gather(1, idx).squeeze(1)


def first_min(cost: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum over the 5 candidates (the C code keeps
    the earliest filter on ties)."""
    return cost.argmin(-1)


def strength_loop(attempt, s, orow, qprev, oprev, e0, e1, hist, w_real,
                  never_pass=None, live=None):
    """One row that must pass the MSAD self-check, from the state
    (qprev, oprev, e0, e1, hist) the previous row left: images with no
    passing filter retry at strength s-1; at s <= 0 the minimum true cost
    is accepted, ties to the lowest filter (where the C tool would abort).
    ``attempt(s)`` runs one attempt of the row at strengths s (B,) and
    returns what ``quantize_row`` returns. Each image's result is its own
    first successful attempt, whatever the rest of the batch needs. One
    host sync per attempt. ``never_pass`` as for ``self_check``. ``live``
    (B,) bool, where given: the images for which the row is real; the
    others (padded rows of a ragged batch) keep their state, filter 0 and
    0 attempts.

    Returns the winner's (qrow, hist, e0n, e1n), its filter id (B,) int64
    and the attempts each image took (B,) int32."""
    b = orow.shape[0]
    dev = orow.device
    s = s.clone()
    found = (torch.zeros(b, dtype=torch.bool, device=dev) if live is None
             else ~live)
    best = torch.zeros(b, dtype=torch.int64, device=dev)
    tries = torch.zeros(b, dtype=torch.int32, device=dev)
    state = (qprev, hist, e0, e1)
    while True:
        q5, h5, e0n, e1n = attempt(s)
        tries += (~found).to(torch.int32)
        cost = row_cost(q5, hist, h5, qprev, orow, oprev, w_real)
        passing = self_check(q5, qprev, w_real, never_pass)
        found_real = passing.any(1)
        give_up = ~found_real & (s <= 0)
        bf = first_min(adaptive_cost(cost, passing | give_up[:, None]))
        upd = ~found & (found_real | give_up)
        best = torch.where(upd, bf, best)
        state = tuple(
            torch.where(upd.view(-1, *([1] * (new.dim() - 2))),
                        pick(new, bf), old)
            for new, old in zip((q5, h5, e0n, e1n), state))
        found = found | upd
        s = torch.where(found, s, (s - 1).clamp(min=0))
        if bool(found.all()):
            return tuple(t.contiguous() for t in state), best, tries


def replayable(fn, device):
    """``fn`` itself on the CPU. On CUDA, ``fn`` run eagerly on its first
    call, then captured once in a CUDA graph: each later call replays its
    kernels and returns the same output tensors, refilled. ``fn`` must not
    write its inputs. The plain versions run their repeated step (a row, an
    attempt) so on the card. A capture costs about one eager call more
    and grows faster than the step (a 12288-step row: ~30 s against ~19 s
    eager on an H100, PERF.md), so a step run once (a row 0 that passes at
    once, one row of a cut) is never captured. The capture is
    thread-local: another thread may run work on its own stream
    meanwhile."""
    if device.type != "cuda":
        return fn
    graph = out = None
    first = True

    def replay():
        nonlocal graph, out, first
        with torch.cuda.device(device):
            if first:                # also the lazy initialisation
                first = False
                return fn()
            if graph is None:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph,
                                      capture_error_mode="thread_local"):
                    out = fn()
            graph.replay()
        return out
    return replay
