"""The scalar model's row search (``scalar.optimize_image``'s loop body,
pngloss_image.c:201-308), written again for speed: one pass of a row under
one filter is a loop over plain Python ints with the symbol search done on
list slices, and the row's derivative error and cost are NumPy over the
whole row. It gives the same pixels, filters and state as ``scalar``
(``benchmark/tests/test_bench_reference.py`` holds it to that), about ten
times sooner, so the check can search many rows whole.

``division="floor"`` replaces the dither's C truncating division
(optimize_state.c:445-467) by floor division, the shortcut an arithmetic
shift would take: ``optimize_image(..., division="floor")`` is the
control, the reference in the precision just below the configuration's.

Imports numpy and the benchmark's frozen copies only.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import scalar

UINTMAX_MAX = scalar.UINTMAX_MAX
FREQ_SHIFT = 32          # symbol uses above, the original's uses below


class Start:
    """The state a row starts from: the adaptive histogram (256 ints) and
    three dither rows, each (W+5)*4 ints, index column*4 + lane."""

    def __init__(self, hist, e0, e1, e2):
        self.hist, self.e0, self.e1, self.e2 = hist, e0, e1, e2

    @classmethod
    def zero(cls, w: int) -> "Start":
        size = (w + 5) * 4
        return cls([0] * 256, [0] * size, [0] * size, [0] * size)

    @classmethod
    def from_arrays(cls, hist, error) -> "Start":
        """From a (256,) histogram and three dither rows, as
        ``scalar._State`` holds them ((3, W+5, 4)) or flat."""
        e = np.asarray(error, np.int64).reshape(3, -1)
        return cls(np.asarray(hist, np.int64).tolist(), *e.tolist())


class Row:
    """What every pass over row ``y`` reads: its original bytes, the
    output row above and the original row above (None for row 0)."""

    def __init__(self, orig, above_q, above_o, bpp: int, ofreq, bleed: int,
                 division: str = "trunc"):
        self.orig = np.asarray(orig, np.int64)
        self.n = len(self.orig)
        self.bpp, self.w = bpp, self.n // bpp
        self.first = above_q is None
        zero = np.zeros(self.n, np.int64)
        self.above_q = zero if self.first else np.asarray(above_q, np.int64)
        self.above_o = zero if self.first else np.asarray(above_o, np.int64)
        self.ofreq = np.asarray(ofreq, np.int64)
        self.bleed, self.floor = bleed, division == "floor"
        # channel c's dither lane; the alpha channel of gray+alpha and
        # RGBA images, whose transparent pixels stay transparent
        self.lanes = lanes(bpp)
        self.alpha = bpp - 1 if bpp % 2 == 0 else -1

    def run(self, f: int, s: int, start: Start):
        """One pass under filter ``f`` at strength ``s`` (optimize_state_run,
        optimize_state.c:114-290, for every pixel of the row). Returns
        (pixels, histogram, e0, e1, e2), the dither rows not yet shifted."""
        bpp, alpha, lanes, bleed, floor = (self.bpp, self.alpha, self.lanes,
                                           self.bleed, self.floor)
        orig = self.orig.tolist()
        above = self.above_q.tolist()
        first = self.first
        hist = list(start.hist)
        e0, e1, e2 = list(start.e0), list(start.e1), list(start.e2)
        ofr = self.ofreq[f].tolist()
        key = [(hist[v & 255] << FREQ_SHIFT) | (ofr[v & 255] << 1)
               for v in range(512)]
        one = 1 << FREQ_SHIFT
        pix = [0] * self.n
        band = s + 1
        for x in range(self.w):
            base = x * bpp
            transparent = alpha >= 0 and orig[base + alpha] == 0
            here = [0, 0, 0, 0]
            back = [0, 0, 0, 0]
            for c in range(bpp):
                off = base + c
                if f == 0:
                    pred = 0
                elif f == 1:
                    pred = pix[off - bpp] if x else 0
                elif f == 2:
                    pred = 0 if first else above[off]
                else:
                    left = pix[off - bpp] if x else 0
                    up = 0 if first else above[off]
                    if f == 3:
                        pred = (up + left) >> 1
                    else:
                        diag = above[off - bpp] if x and not first else 0
                        p = up - diag
                        pd = left - diag
                        pl, pa, pdd = abs(p), abs(pd), abs(p + pd)
                        pred = (left if pl <= pa and pl <= pdd
                                else up if pa <= pdd else diag)
                if transparent and c == alpha:
                    sym = (-pred) & 255
                    hist[sym] += 1
                    key[sym] += one
                    key[sym + 256] += one
                    continue                   # here 0, back 0: pix 0
                o = orig[off]
                h = o + e0[(x + 2) * 4 + lanes[c]]
                here[c] = h
                osym = o - pred
                if osym < -128:
                    pred -= 256
                    osym = o - pred
                elif osym > 127:
                    pred += 256
                    osym = o - pred
                filtered = h - pred
                if filtered < 0:
                    mx = -(-filtered - (-filtered % band))
                    mn = mx - s
                else:
                    mn = filtered - filtered % band
                    mx = mn + s
                if mn + pred < 0:
                    mn = -pred
                if mx + pred > 255:
                    mx = 255 - pred
                if mx < mn:
                    if filtered + pred > 255:
                        mn = mx = 255 - pred
                    if filtered + pred < 0:
                        mn = mx = -pred
                lo = mn & 255
                cand = key[lo:lo + mx - mn + 1]
                best = max(cand)
                if mn <= osym <= mx and key[osym & 255] == best:
                    sym = osym
                else:
                    sym = mn + cand.index(best)
                b = sym + pred
                back[c] = b
                pix[off] = b
                sym &= 255
                hist[sym] += 1
                key[sym] += one
                key[sym + 256] += one
            # Sierra error diffusion (optimize_state.c:390-490) on the
            # lanes the row reads
            for c in range(bpp):
                d = here[c] - back[c]
                if d == 0:
                    continue
                k = x * 4 + lanes[c]
                if floor:
                    d //= bleed
                    t = d // 16
                    d -= t * 4
                    e1[k] += t
                    e1[k + 16] += t
                    e2[k + 4] += t
                    e2[k + 12] += t
                    t = d // 8
                    d -= t * 2
                    e0[k + 16] += t
                    e2[k + 8] += t
                    t = (d * 2) // 9
                    d -= t * 2
                    e1[k + 4] += t
                    e1[k + 12] += t
                    t = d // 2
                else:
                    d = d // bleed if d >= 0 else -(-d // bleed)
                    t = d // 16 if d >= 0 else -(-d // 16)
                    d -= t * 4
                    e1[k] += t
                    e1[k + 16] += t
                    e2[k + 4] += t
                    e2[k + 12] += t
                    t = d // 8 if d >= 0 else -(-d // 8)
                    d -= t * 2
                    e0[k + 16] += t
                    e2[k + 8] += t
                    t = (d * 2) // 9 if d >= 0 else -(-(d * 2) // 9)
                    d -= t * 2
                    e1[k + 4] += t
                    e1[k + 12] += t
                    t = d // 2 if d >= 0 else -(-d // 2)
                d -= t
                e1[k + 8] += t
                e0[k + 12] += d
        return pix, hist, e0, e1, e2

    def derivative_error(self, pix: np.ndarray) -> int:
        """The row's summed derivative error against its three neighbours
        (optimize_state.c:265-289), over the whole row at once."""
        bpp = self.bpp
        orig, aq, ao = self.orig, self.above_q, self.above_o
        left_new = np.zeros_like(pix)
        left_new[bpp:] = pix[:-bpp]
        left_old = np.zeros_like(orig)
        left_old[bpp:] = orig[:-bpp]
        diag_new = np.zeros_like(aq)
        diag_new[bpp:] = aq[:-bpp]
        diag_old = np.zeros_like(ao)
        diag_old[bpp:] = ao[:-bpp]
        # color_difference's lanes: a gray channel counts in three
        weight = np.ones(self.n, np.int64)
        if bpp <= 2:
            weight[::bpp] = 3
        total = 0
        for new, old in ((aq, ao), (diag_new, diag_old),
                         (left_new, left_old)):
            total += int((weight * ((pix - new) - (orig - old)) ** 2).sum())
        return total

    def cost(self, f: int, pix, hist, adaptive: bool) -> int:
        """optimize_state_row's tail (optimize_state.c:314-361): libpng's
        MSAD self-check where the row must pass it, then the derivative
        error over 128 plus the entropy proxy on the final histogram."""
        pix = np.asarray(pix, np.int64)
        above = None if self.first else self.above_q
        if adaptive and f != scalar.adaptive_filter_for_row(
                above, pix, self.bpp, self.w):
            return UINTMAX_MAX
        bpp = self.bpp
        left = np.zeros_like(pix)
        left[bpp:] = pix[:-bpp]
        diag = np.zeros_like(pix)
        diag[bpp:] = self.above_q[:-bpp]
        pred = predict(f, left, self.above_q, diag)
        freq = np.asarray(hist, np.int64)[(pix - pred) & 255]
        _, bits = np.frexp(freq.astype(np.float64))
        entropy = int((65 - bits)[freq > 0].sum())
        return self.derivative_error(pix) // 128 + entropy

    def search(self, strength: int, start: Start, adaptive: bool):
        """The whole row search: five filters, the lowest cost (the first
        on a tie), and on no passing filter the next strength down.
        Returns (pixels, filter, strength, next row's Start), or None where
        no strength passes."""
        s = strength
        while True:
            best_cost, best = UINTMAX_MAX, None
            for f in range(scalar.NUM_FILTERS):
                pix, hist, e0, e1, e2 = self.run(f, s, start)
                cost = self.cost(f, pix, hist, adaptive)
                if best_cost > cost:
                    best_cost, best = cost, (f, pix, hist, e1, e2)
            if best is not None:
                f, pix, hist, e1, e2 = best
                # the dither rows shift up (optimize_state.c:344-351)
                return pix, f, s, Start(hist, e1, e2, [0] * len(e2))
            if s <= 0:
                return None
            s -= 1


def lanes(bpp: int) -> tuple[int, ...]:
    """The dither lane each working-format channel reads and feeds
    (optimize_state.c:167: gray+alpha's alpha reads lane 3)."""
    return (0, 3) if bpp == 2 else tuple(range(bpp))


def predict(f, left, up, diag):
    """Filter ``f``'s predictor of every byte from its neighbours
    (optimize_state.c:575-613), on whole arrays."""
    if f == 0:
        return np.zeros_like(left)
    if f == 1:
        return left
    if f == 2:
        return up
    if f == 3:
        return (left + up) >> 1
    p = up - diag
    pd = left - diag
    pl, pa, pdd = np.abs(p), np.abs(pd), np.abs(p + pd)
    return np.where((pl <= pa) & (pl <= pdd), left,
                    np.where(pa <= pdd, up, diag))


def optimize_image(work: np.ndarray, bpp: int, strength: int,
                   bleed: int = 2, use_row_filters: bool = True,
                   division: str = "trunc"):
    """``scalar.optimize_image`` from this module's row search: (H, W*bpp)
    working rows in; (quantized rows uint8, row filters int8) out."""
    work = np.asarray(work, np.int64)
    h, n = work.shape
    ofreq = original_frequencies(work, bpp)
    q = np.zeros((h, n), np.int64)
    filters = np.zeros(h, np.int8)
    start = Start.zero(n // bpp)
    for y in range(h):
        row = Row(work[y], q[y - 1] if y else None,
                  work[y - 1] if y else None, bpp, ofreq, bleed, division)
        found = row.search(strength, start, (not use_row_filters) or y == 0)
        if found is None:
            raise ValueError(f"no strength passes row {y}")
        q[y], filters[y], _, start = found
    return q.astype(np.uint8), filters


def original_frequencies(work: np.ndarray, bpp: int) -> np.ndarray:
    """The pre-pass (optimize_state.c:66-83) over the whole image at once:
    (5, 256) histograms of the original's residuals under each filter."""
    rows = np.asarray(work, np.int64)
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    diag = np.zeros_like(rows)
    diag[1:, bpp:] = rows[:-1, :-bpp]
    out = np.empty((5, 256), np.int64)
    for f in range(5):
        out[f] = np.bincount(((rows - predict(f, left, up, diag)) & 255)
                             .ravel(), minlength=256)
    return out
