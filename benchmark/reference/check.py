"""Judge the program's outputs against the frozen scalar model.

An output row of pngloss depends on the whole image's pre-pass (the five
histograms of the original's residuals) and on the state the rows above it
left: the adaptive symbol histogram and three rows of dither error. Both
follow from the original image and the output rows above, with no search.
So the check walks each output from its first row down and, for every row:

1. works out that state from the output rows above it (``replay``);
2. recomputes, from that state, the symbol choice of every channel of the
   row under the row's filter: the band the strength allows around the
   dithered value, clipped to 0..255, and in it the symbol with the most
   uses so far, then the most uses in the original under that filter, then
   the original symbol, then the first (``pick``). Each output byte must be
   that choice, and a fully transparent pixel's alpha 0;
3. on rows drawn from the seed (and always the first, second and last),
   and on every row whose bytes match only a strength below the
   configuration's, runs the scalar model's whole row search from that
   state (``rowsearch``): all five filters, the row cost, libpng's MSAD
   self-check where the row must pass it, and the strength fallback
   (``search_row``). Its pixels and filter must be the output's.

Step 2 judges every byte of every output against the state its own rows
imply; step 3 judges each searched row's filter and strength too, and so
every row that kept a lower strength. Where the rows above are the
reference's own (as they are when no row above was judged wrong), the
state is the reference's own, so a run of rows judged right from row 0 is
the scalar model's output, row for row.

Imports numpy and the benchmark's frozen copies only.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import rowsearch, scalar


def _trunc(a: int, b: int) -> int:
    return a // b if a >= 0 else -((-a) // b)


def predictions(q: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """(H, W*bpp) int64: each byte's predictor under its row's filter, from
    the output's own neighbours (optimize_state.c:575-613)."""
    rows = q.astype(np.int64)
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    diag = np.zeros_like(rows)
    diag[1:, bpp:] = rows[:-1, :-bpp]
    preds = np.stack([rowsearch.predict(f, left, up, diag)
                      for f in range(5)])
    return preds[np.asarray(filters, np.intp), np.arange(len(rows))]


def msad_filters(q: np.ndarray, bpp: int) -> np.ndarray:
    """Each row's filter by libpng's MSAD heuristic on the output rows
    (optimize_state.c:492-562). In embedding mode every row's filter is
    this one: a row passes only if its winning filter equals it."""
    w = q.shape[1] // bpp
    return np.asarray([scalar.adaptive_filter_for_row(
        q[y - 1] if y else None, q[y], bpp, w) for y in range(len(q))],
        np.int64)


class Walk:
    """The state each row of one output starts from, worked out from the
    original and the output rows above it."""

    def __init__(self, work: np.ndarray, q: np.ndarray, filters, bpp: int,
                 bleed: int):
        self.work = work.astype(np.int64)
        self.q = q.astype(np.int64)
        self.filters = np.asarray(filters, np.int64)
        self.bpp, self.bleed = bpp, bleed
        self.h, n = q.shape
        self.w = n // bpp
        self.ofreq = rowsearch.original_frequencies(work, bpp)
        self.pred = predictions(q, self.filters, bpp)
        self.symbols = (self.q - self.pred) & 0xFF
        counts = np.stack([np.bincount(r, minlength=256)
                           for r in self.symbols])
        # the adaptive histogram at the start of each row
        self.hist = np.zeros((self.h, 256), np.int64)
        self.hist[1:] = np.cumsum(counts, 0)[:-1]
        self.transparent = np.zeros_like(self.work, bool)
        if bpp % 2 == 0:
            self.transparent[:, bpp - 1::bpp] = self.work[:, bpp - 1::bpp] == 0
        self.errors = {}

    def replay(self):
        """Yields (y, here) for every row: the dithered value of each byte
        (optimize_state.c:167-169). While row y is yielded, ``keep(y)``
        snapshots the dither rows it started from into ``self.errors``."""
        w, bpp, bleed, div = self.w, self.bpp, self.bleed, _trunc
        lanes = rowsearch.lanes(bpp)
        alpha = bpp - 1 if bpp % 2 == 0 else -1
        size = (w + 5) * 4
        e0, e1, e2 = [0] * size, [0] * size, [0] * size
        for y in range(self.h):
            self._start = (e0[:], e1[:])       # e2 starts each row at zero
            orig = self.work[y].tolist()
            back = self.q[y].tolist()
            here = [0] * (w * bpp)
            for x in range(w):
                base = x * bpp
                transparent = alpha >= 0 and orig[base + alpha] == 0
                for c in range(bpp):
                    lane = lanes[c]
                    if c == alpha and transparent:
                        continue               # here 0, back 0: no error
                    hc = orig[base + c] + e0[(x + 2) * 4 + lane]
                    here[base + c] = hc
                    d = hc - back[base + c]
                    if d == 0:
                        continue
                    d = div(d, bleed)
                    k = x * 4 + lane
                    t = div(d, 16)
                    d -= t * 4
                    e1[k] += t
                    e1[k + 16] += t
                    e2[k + 4] += t
                    e2[k + 12] += t
                    t = div(d, 8)
                    d -= t * 2
                    e0[k + 16] += t
                    e2[k + 8] += t
                    t = div(d * 2, 9)
                    d -= t * 2
                    e1[k + 4] += t
                    e1[k + 12] += t
                    t = div(d, 2)
                    d -= t
                    e1[k + 8] += t
                    e0[k + 12] += d
            e0, e1, e2 = e1, e2, [0] * size
            yield y, np.asarray(here, np.int64)

    def keep(self, y: int) -> None:
        e0, e1 = self._start
        self.errors[y] = np.asarray([e0, e1, [0] * len(e0)], np.int64)

    def uses_before(self, y: int) -> tuple[np.ndarray, np.ndarray]:
        """The uses of each symbol by the channels of row y before each
        channel, as (index, counts): ``counts[index[v], j]`` is symbol v's
        uses before channel j; only the symbols the row uses take a row of
        ``counts`` (the last row, all zero, stands for the others)."""
        n = self.q.shape[1]
        used, inv = np.unique(self.symbols[y], return_inverse=True)
        index = np.full(256, len(used), np.intp)
        index[used] = np.arange(len(used))
        onehot = np.zeros((len(used) + 1, n), np.int32)
        onehot[inv, np.arange(n)] = 1
        counts = np.cumsum(onehot, 1, dtype=np.int32)
        counts -= onehot
        return index, counts

    def pick(self, y: int, here: np.ndarray, strength: int,
             before=None) -> np.ndarray:
        """The byte each channel of row y would get under the row's filter
        at ``strength`` (the symbol search of optimize_state.c:114-248),
        from the row's dithered values and the histogram as the row's
        start and its own earlier channels leave it (``uses_before``)."""
        pred, orig = self.pred[y], self.work[y]
        n = len(pred)
        if before is None:
            before = self.uses_before(y)
        osym = orig - pred
        pw = pred - 256 * (osym < -128) + 256 * (osym > 127)
        osym = orig - pw
        filtered = here - pw
        band = strength + 1
        neg = filtered < 0
        mx_neg = -((-filtered) - ((-filtered) % band))
        mn_pos = filtered - filtered % band
        mn = np.where(neg, mx_neg - strength, mn_pos)
        mx = np.where(neg, mx_neg, mn_pos + strength)
        mn = np.where(mn + pw < 0, -pw, mn)
        mx = np.where(mx + pw > 255, 255 - pw, mx)
        empty = mx < mn
        high = empty & (filtered + pw > 255)
        low = empty & (filtered + pw < 0)
        mn = np.where(high, 255 - pw, np.where(low, -pw, mn))
        mx = np.where(high, 255 - pw, np.where(low, -pw, mx))
        cand = mn[:, None] + np.arange(band)[None, :]
        valid = cand <= mx[:, None]
        idx = cand & 0xFF
        index, counts = before
        freq = self.hist[y][idx] + counts.ravel()[index[idx] * n
                                                  + np.arange(n)[:, None]]
        close = self.ofreq[self.filters[y]][idx]
        key = np.where(valid, (freq << 28) | (close << 1)
                       | (cand == osym[:, None]), -1)
        best = np.argmax(key, 1)
        out = cand[np.arange(n), best] + pw
        out = np.where(valid.any(1), out, -1)      # no candidate: no byte
        return np.where(self.transparent[y], 0, out)


def row_state(walk: Walk, y: int) -> dict:
    """What the whole row search of row y needs: the original row and the
    rows above, the dither rows and histogram the rows above left, and
    the pre-pass (plain data, so it can go to a worker process)."""
    return dict(orig=walk.work[y], above_q=walk.q[y - 1] if y else None,
                above_o=walk.work[y - 1] if y else None,
                error=walk.errors[y], hist=walk.hist[y], ofreq=walk.ofreq,
                bpp=walk.bpp, bleed=walk.bleed, q=walk.q[y],
                filter=int(walk.filters[y]), y=y)


def search_row(state: dict, strength: int, adaptive: bool) -> bool:
    """The scalar model's row search (optimize_image's loop body,
    pngloss_image.c:201-308) from ``state``; True when its pixels and
    filter are the output's."""
    row = rowsearch.Row(state["orig"], state["above_q"], state["above_o"],
                        state["bpp"], state["ofreq"], state["bleed"])
    found = row.search(strength, rowsearch.Start.from_arrays(
        state["hist"], state["error"]), adaptive)
    return (found is not None and found[1] == state["filter"]
            and np.array_equal(found[0], state["q"]))


def judge_rows(walk: Walk, strength: int, adaptive_rows: str,
               keep=(), fell_back=None) -> np.ndarray:
    """Rows of the output whose bytes are not the picks from their state
    (step 2). ``adaptive_rows``: "first" (CLI mode: only row 0 may have
    fallen back to a lower strength) or "all" (embedding mode: any row
    may). A row that may have fallen back is judged at the highest
    strength, from ``strength`` down, whose picks it matches; the rows
    that match below ``strength`` only are appended to ``fell_back``. The
    states of the rows in ``keep`` and of those that fell back are kept
    (``walk.errors``). Returns the indices of the rows judged wrong."""
    wrong = []
    for y, here in walk.replay():
        ladder = (range(strength, -1, -1)
                  if adaptive_rows == "all" or y == 0 else (strength,))
        before = walk.uses_before(y)
        s = next((s for s in ladder if np.array_equal(
            walk.pick(y, here, s, before), walk.q[y])), None)
        if s is None:
            wrong.append(y)
        elif s < strength and fell_back is not None:
            fell_back.append(y)
            walk.keep(y)
        if y in keep:
            walk.keep(y)
    return np.asarray(wrong, np.int64)
