"""Exact scalar reference model of the pngloss row optimizer.

This is a from-scratch numpy implementation of the algorithm specified by the
reference C sources (optimize_state.c, pngloss_image.c, color_delta.c). It is
deliberately slow and literal: its job is to pin down bit-exact semantics so
the batched kernels can be property-tested against it, and it in
turn is property-tested against the compiled C tool.

Semantics pinned here (with reference citations):
  * per-pixel quantization with banded symbol search   (optimize_state.c:114-290)
  * three-level tie-breaking in symbol selection       (optimize_state.c:212-248)
  * the adaptive symbol histogram is shared across channels within a pixel
  * Sierra error diffusion with C truncating division  (optimize_state.c:445-467)
  * predictor wrap so the original residual is in [-128,127] (:175-182)
  * transparent-pixel rule for even bpp                (optimize_state.c:158-164)
  * derivative (second-difference) row error           (optimize_state.c:265-289)
  * row cost = total_error/128 + sum(65 - bitlength(freq))  (:326-342,360)
  * per-row 5-filter search, lowest-index tie-break, strength fallback
    (pngloss_image.c:201-308)
  * grayscale/alpha colorspace reduction               (pngloss_image.c:64-147)
  * libpng-heuristic self-consistency check for adaptive rows
    (optimize_state.c:492-562)

All arithmetic uses Python ints / int64 numpy, which subsumes the C tool's
int_fast16_t (64-bit on x86-64) and uintmax_t.

Frozen copy of ``pngloss_tpu_torch/reference.py`` at commit 942c847, the
benchmark's own: it imports nothing of the program, and later changes to
the program's copy do not reach it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

FILTER_NONE, FILTER_SUB, FILTER_UP, FILTER_AVG, FILTER_PAETH = range(5)
NUM_FILTERS = 5
DITHER_ROWS = 3
DITHER_WIDTH = 5
UINTMAX_MAX = (1 << 64) - 1


def trunc_div(a: int, b: int) -> int:
    """C-style integer division truncating toward zero."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def filter_predict(above: int, diag: int, left: int, f: int) -> int:
    """The five PNG filter predictors on already-quantized neighbor bytes
    (optimize_state.c:575-613). All inputs/outputs are uint8 values."""
    if f == FILTER_NONE:
        return 0
    if f == FILTER_SUB:
        return left
    if f == FILTER_UP:
        return above
    if f == FILTER_AVG:
        return (above + left) // 2
    # paeth
    p = above - diag
    p_diag = left - diag
    p_left = abs(p)
    p_above = abs(p_diag)
    p_d = abs(p + p_diag)
    if p_left <= p_above and p_left <= p_d:
        return left
    if p_above <= p_d:
        return above
    return diag


def original_frequencies(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Histogram of original-image residuals under each filter: (5, 256) int64.

    Mirrors the init pre-pass (optimize_state.c:66-83): predictions use the
    ORIGINAL image for left/above/diag.
    """
    h, w = rows.shape[0], rows.shape[1] // bpp
    freq = np.zeros((NUM_FILTERS, 256), dtype=np.int64)
    for f in range(NUM_FILTERS):
        for y in range(h):
            for x in range(w):
                for c in range(bpp):
                    off = x * bpp + c
                    color = int(rows[y][off])
                    left = int(rows[y][off - bpp]) if x > 0 else 0
                    above = int(rows[y - 1][off]) if y > 0 else 0
                    diag = int(rows[y - 1][off - bpp]) if (y > 0 and x > 0) else 0
                    predicted = filter_predict(above, diag, left, f)
                    freq[f][(color - predicted) & 0xFF] += 1
    return freq


def adaptive_filter_for_row(above_row: np.ndarray | None, pixels: np.ndarray, bpp: int, w: int) -> int:
    """libpng's MSAD heuristic as reimplemented in adaptive_filter_for_rows
    (optimize_state.c:492-562). Ties resolve to the earliest filter via the
    >= cascade."""
    n = w * bpp
    px = pixels[:n].astype(np.int64)
    above = above_row[:n].astype(np.int64) if above_row is not None else np.zeros(n, dtype=np.int64)
    left = np.zeros(n, dtype=np.int64)
    left[bpp:] = px[:-bpp]
    diag = np.zeros(n, dtype=np.int64)
    if above_row is not None:
        diag[bpp:] = above[:-bpp]

    def score(vals: np.ndarray) -> int:
        v = vals & 0xFF
        return int(np.where(v < 128, v, 256 - v).sum())

    none_sum = score(px)
    sub_sum = score(px - left)
    up_sum = score(px - above)
    avg_sum = score(px - (left + above) // 2)
    p = above - diag
    p_diag_t = left - diag
    p_left = np.abs(p)
    p_above = np.abs(p_diag_t)
    p_d = np.abs(p + p_diag_t)
    pred = np.where((p_left <= p_above) & (p_left <= p_d), left, np.where(p_above <= p_d, above, diag))
    paeth_sum = score(px - pred)

    sums = [none_sum, sub_sum, up_sum, avg_sum, paeth_sum]
    min_sum = min(sums)
    for f in range(5):
        if min_sum >= sums[f]:
            return f
    raise AssertionError("unreachable")


@dataclass
class _State:
    """optimize_state (optimize_state.h:9-16), minus x/y cursors."""
    pixels: np.ndarray        # (W*bpp,) int64 — quantized current row
    color_error: np.ndarray   # (3, W+5, 4) int64 dither error buffer
    symbol_frequency: np.ndarray  # (256,) int64 adaptive histogram

    def copy(self) -> "_State":
        return _State(self.pixels.copy(), self.color_error.copy(), self.symbol_frequency.copy())


def _color_difference(bpp: int, back: list[int], here: list[int]) -> list[int]:
    """color_difference (color_delta.c:4-41): map channel deltas to 4 lanes."""
    if bpp == 1:
        d = here[0] - back[0]
        return [d, d, d, 0]
    if bpp == 2:
        d = here[0] - back[0]
        return [d, d, d, here[1] - back[1]]
    if bpp == 3:
        return [here[0] - back[0], here[1] - back[1], here[2] - back[2], 0]
    return [here[i] - back[i] for i in range(4)]


def _run_pixel(
    state: _State,
    rows: np.ndarray,
    last_row_pixels: np.ndarray,
    original_frequency: np.ndarray,
    x: int,
    y: int,
    f: int,
    strength: int,
    bleed_divider: int,
    bpp: int,
) -> int:
    """optimize_state_run (optimize_state.c:114-290) for one pixel.
    Returns the derivative error contribution; mutates state in place."""
    w = rows.shape[1] // bpp
    back_color = [0, 0, 0, 0]
    here_color = [0, 0, 0, 0]
    original_color = [0, 0, 0, 0]
    old_above_color = [0, 0, 0, 0]
    new_above_color = [0, 0, 0, 0]
    old_diag_color = [0, 0, 0, 0]
    new_diag_color = [0, 0, 0, 0]
    old_left_color = [0, 0, 0, 0]
    new_left_color = [0, 0, 0, 0]

    for c in range(bpp):
        off = x * bpp + c
        original_color[c] = int(rows[y][off])

        above = old_above = diag = old_diag = left = old_left = 0
        if y > 0:
            above = int(rows[y - 1][off])
            old_above = int(last_row_pixels[off])
            if x > 0:
                diag = int(rows[y - 1][off - bpp])
                old_diag = int(last_row_pixels[off - bpp])
        if x > 0:
            left = int(state.pixels[off - bpp])
            old_left = int(rows[y][off - bpp])
        old_above_color[c] = old_above
        new_above_color[c] = above
        old_diag_color[c] = old_diag
        new_diag_color[c] = diag
        old_left_color[c] = old_left
        new_left_color[c] = left

        predicted = filter_predict(above, diag, left, f)

        if (bpp % 2) == 0 and int(rows[y][x * bpp + bpp - 1]) == 0 and c == bpp - 1:
            # fully transparent pixels stay fully transparent (:158-164)
            here_color[c] = 0
            back_color[c] = 0
            best_symbol = (0 - predicted) & 0xFF
        else:
            i = 3 if (bpp == 2 and c == 1) else c
            color_error = int(state.color_error[0][x + DITHER_WIDTH // 2][i])
            here_color[c] = original_color[c] + color_error

            original_symbol = original_color[c] - predicted
            if original_symbol < -128:
                predicted -= 256
                original_symbol = original_color[c] - predicted
            elif original_symbol > 127:
                predicted += 256
                original_symbol = original_color[c] - predicted
            filtered = here_color[c] - predicted

            band = strength + 1
            if filtered < 0:
                mx = -(-filtered - (-filtered % band))
                mn = mx - strength
            else:
                mn = filtered - (filtered % band)
                mx = mn + strength

            if mn + predicted < 0:
                mn = 0 - predicted
            if mx + predicted > 255:
                mx = 255 - predicted
            if mx < mn:
                if filtered + predicted > 255:
                    mn = mx = 255 - predicted
                if filtered + predicted < 0:
                    mn = mx = 0 - predicted

            found_best = False
            best_frequency = 0
            best_symbol = 0
            for symbol in range(mn, mx + 1):
                back = symbol + predicted
                assert 0 <= back <= 255, (back, mn, mx)
                frequency = int(state.symbol_frequency[symbol & 0xFF])
                new_best = False
                if not found_best:
                    new_best = True
                elif best_frequency < frequency:
                    new_best = True
                elif best_frequency == frequency:
                    best_close = int(original_frequency[f][best_symbol])
                    close = int(original_frequency[f][symbol & 0xFF])
                    if best_close < close:
                        new_best = True
                    elif best_close == close and symbol == original_symbol:
                        new_best = True
                if new_best:
                    found_best = True
                    best_frequency = frequency
                    best_symbol = symbol & 0xFF
                    back_color[c] = back
            assert found_best

        state.pixels[off] = back_color[c]
        state.symbol_frequency[best_symbol] += 1

    # Sierra error diffusion (diffuse_color_error, optimize_state.c:390-490)
    difference = _color_difference(bpp, back_color, here_color)
    err = state.color_error
    for c in range(4):
        d = difference[c]
        d = trunc_div(d, bleed_divider)

        twos = trunc_div(d, 16)
        d -= twos * 4
        err[1][x + 0][c] += twos
        err[1][x + 4][c] += twos
        err[2][x + 1][c] += twos
        err[2][x + 3][c] += twos

        threes = trunc_div(d, 8)
        d -= threes * 2
        err[0][x + 4][c] += threes
        err[2][x + 2][c] += threes

        fours = trunc_div(d * 2, 9)
        d -= fours * 2
        err[1][x + 1][c] += fours
        err[1][x + 3][c] += fours

        five = trunc_div(d, 2)
        d -= five
        err[1][x + 2][c] += five

        err[0][x + 3][c] += d

    # derivative error vs. three neighbors (:265-289)
    def dist(new_pair, old_pair):
        old_partial = _color_difference(bpp, old_pair, original_color)
        new_partial = _color_difference(bpp, new_pair, back_color)
        return sum((n - o) ** 2 for n, o in zip(new_partial, old_partial))

    above_error = dist(new_above_color, old_above_color)
    diag_error = dist(new_diag_color, old_diag_color)
    left_error = dist(new_left_color, old_left_color)
    return above_error + diag_error + left_error


def _row_cost(
    state: _State,
    rows: np.ndarray,
    y: int,
    f: int,
    total_error: int,
    bpp: int,
    adaptive: bool,
) -> int:
    """Tail of optimize_state_row (optimize_state.c:314-361): adaptive
    self-consistency check plus entropy-proxy cost on the FINAL histogram."""
    w = rows.shape[1] // bpp
    above_row = rows[y - 1] if y > 0 else None

    if adaptive:
        if f != adaptive_filter_for_row(above_row, state.pixels, bpp, w):
            return UINTMAX_MAX

    total_cost = 0
    for x in range(w):
        for c in range(bpp):
            off = x * bpp + c
            left = int(state.pixels[off - bpp]) if x > 0 else 0
            above = int(above_row[off]) if above_row is not None else 0
            diag = int(above_row[off - bpp]) if (above_row is not None and x > 0) else 0
            predicted = filter_predict(above, diag, left, f)
            symbol = (int(state.pixels[off]) - predicted) & 0xFF
            frequency = int(state.symbol_frequency[symbol])
            if frequency:
                total_cost += 65 - frequency.bit_length()  # == ulog2(UINTMAX_MAX/freq)
    return total_error // 128 + total_cost


def optimize_image(
    rows: np.ndarray,
    bpp: int,
    strength: int,
    bleed_divider: int = 2,
    use_row_filters: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """optimize_image (pngloss_image.c:159-333) on a working-format image.

    rows: (H, W*bpp) uint8 array, mutated semantics returned as a copy.
    Returns (quantized_rows (H, W*bpp) uint8, row_filters (H,) int8 filter ids).
    When use_row_filters is False (embedding mode), every row must pass the
    adaptive self-consistency check (pngloss_image.c:210).
    """
    rows = rows.astype(np.int64).copy()
    h, wb = rows.shape
    w = wb // bpp
    original_frequency = original_frequencies(rows, bpp)

    state = _State(
        pixels=np.zeros(wb, dtype=np.int64),
        color_error=np.zeros((DITHER_ROWS, w + DITHER_WIDTH, 4), dtype=np.int64),
        symbol_frequency=np.zeros(256, dtype=np.int64),
    )
    last_row_pixels = np.zeros(wb, dtype=np.int64)
    row_filters = np.zeros(h, dtype=np.int8)

    for y in range(h):
        best_cost = UINTMAX_MAX
        best_filter = 0
        best_state: _State | None = None
        found_best = False
        s = strength
        adaptive = (not use_row_filters) or y == 0
        while not found_best:
            for f in range(NUM_FILTERS):
                filter_state = state.copy()
                total_error = 0
                for x in range(w):
                    total_error += _run_pixel(
                        filter_state, rows, last_row_pixels, original_frequency,
                        x, y, f, s, bleed_divider, bpp,
                    )
                cost = _row_cost(filter_state, rows, y, f, total_error, bpp, adaptive)
                if best_cost > cost:
                    best_cost = cost
                    best_filter = f
                    found_best = True
                    best_state = filter_state
            if not found_best:
                assert s > 0, f"no good row at y == {y}"
                s -= 1

        # shift error rows up and zero the bottom (optimize_state.c:344-351);
        # in the C code this happens inside optimize_state_row before the copy
        # back to `state`, so apply it to the winning state here.
        best_state.color_error[:-1] = best_state.color_error[1:]
        best_state.color_error[-1] = 0

        last_row_pixels[:] = rows[y]
        rows[y] = best_state.pixels
        state = best_state
        row_filters[y] = best_filter

    return rows.astype(np.uint8), row_filters


def reduce_colorspace(rgba: np.ndarray) -> tuple[np.ndarray, int, bool, bool]:
    """optimize_with_rows' colorspace reduction (pngloss_image.c:64-121).
    Returns (working rows (H, W*bpp) uint8, bpp, grayscale, strip_alpha)."""
    h, w = rgba.shape[0], rgba.shape[1]
    grayscale = bool(np.all(rgba[:, :, 0] == rgba[:, :, 1]) and np.all(rgba[:, :, 1] == rgba[:, :, 2]))
    strip_alpha = bool(np.all(rgba[:, :, 3] == 255))
    if grayscale and strip_alpha:
        work, bpp = rgba[:, :, 1:2], 1      # green channel (pngloss_image.c:112)
    elif grayscale:
        work, bpp = rgba[:, :, (1, 3)], 2
    elif strip_alpha:
        work, bpp = rgba[:, :, :3], 3
    else:
        work, bpp = rgba, 4
    return np.ascontiguousarray(work).reshape(h, w * bpp).copy(), bpp, grayscale, strip_alpha


def restore_colorspace(work: np.ndarray, bpp: int, w: int) -> np.ndarray:
    """Back to RGBA (pngloss_image.c:126-147)."""
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


def optimize_rgba(
    rgba: np.ndarray,
    strength: int,
    bleed_divider: int = 2,
    use_row_filters: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """optimize_with_rows (pngloss_image.c:52-156): colorspace-reduce, optimize,
    restore. Returns (quantized RGBA (H,W,4) uint8, row_filters (H,) ids)."""
    work, bpp, _, _ = reduce_colorspace(rgba)
    qrows, row_filters = optimize_image(work, bpp, strength, bleed_divider, use_row_filters)
    return restore_colorspace(qrows, bpp, rgba.shape[1]), row_filters
