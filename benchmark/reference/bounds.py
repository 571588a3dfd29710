"""The least time an H100 could take for the image kernels' work, counted
from the inputs, for their roofline shares.

Frozen copy of ``chip_smoke.py``'s operation counts and ``bounds`` (:208-253,
:983-1039, commit 942c847): int32 operations counted from the scalar
model's body, one add, subtract, multiply, divide, compare, select, shift,
mask, abs or leading-zero count each; bytes read once and written once.
Two changes, both toward fewer operations, so a share stays under the true
one: each channel step of each filter counts one band candidate (the least
any implementation scans; the candidates a strength of s can give number
up to s + 1, and the count from the data is the program's to make), and
the ladder counts one attempt per real row (the retries a row needs are
not visible from the public entry points).

Peaks of one H100 SXM5 80 GB at its 700 W limit:

* HBM: 3.35 TB/s, NVIDIA's H100 data sheet;
* int32: 16.73 TOP/s, not published: 64 int32 lanes per SM per clock
  (NVIDIA's Hopper architecture white paper: 4 sub-partitions of 16 INT32
  units) x 132 SMs x 1.98 GHz (the card's maximum SM clock, as
  ``nvidia-smi --query-gpu=clocks.max.sm`` reads it).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9

# predictor, per filter (filter_predict): none, sub, up 0; avg: add,
# shift 2; paeth: 3 add/sub, 3 abs, 3 compares, an and, 2 selects 12
PREDICT_OPS = (0, 0, 0, 2, 12)
# one channel of one pixel under one filter (_run_pixel), beside its
# predictor: carried error add 1; the +-256 wrap 5; filtered residual 1;
# band start 4; clamp tests 5; histogram update 1
CHANNEL_OPS = 17
# each band candidate: loop step and test 2, back = symbol + predictor 1,
# symbol & 0xFF 1, the two frequency compares 2
CANDIDATE_OPS = 6
# per dither lane a channel feeds (bpp 1 and 3: 3 lanes, bpp 2 and 4: 4),
# the Sierra split: 23
DIFFUSE_OPS, FED_LANES = 23, {1: 3, 2: 4, 3: 3, 4: 4}
# per channel and neighbour of the derivative error 5 (+1 for gray's
# channel weight of 3); per pixel 3 adds
DERIV_OPS, DERIV_PIXEL_OPS = 5, 3
# per row and filter: 6 for each of the 256 histogram bins, then 3
COST_BIN_OPS, COST_ROW_OPS = 6, 3
# MSAD self-check, per channel of each candidate row: the 5 trial
# predictors, and per trial 6
MSAD_TRIAL_OPS = 6


def pixel_ops(bpp: int, deriv: bool, msad: bool) -> int:
    """Fixed int32 operations of one pixel of one row summed over the 5
    filters, band candidates apart."""
    weight3 = {1: 1, 2: 1}.get(bpp, 0)
    ops = 0
    for f in range(5):
        ops += bpp * (PREDICT_OPS[f] + CHANNEL_OPS) + bpp
        ops += bpp % 2 == 0
        ops += DIFFUSE_OPS * FED_LANES[bpp]
        if deriv:
            ops += 3 * (bpp * DERIV_OPS + weight3) + DERIV_PIXEL_OPS
        if msad:
            ops += bpp * (sum(PREDICT_OPS) + 5 * MSAD_TRIAL_OPS)
    return ops


def image_work(h: int, w: int, bpp: int, ladder: bool) -> tuple[int, int]:
    """(int32 operations, bytes) of rows 1..h-1 of one image of h x w
    pixels at bpp: ``image_kernel`` in CLI mode, ``ladder_kernel`` (one
    attempt a row, with the MSAD self-check) in embedding mode."""
    px, we = w * bpp, (w + 5) * 4
    rows = h - 1
    nbytes = (h * w * bpp + 4 * (px + 2 * we + 256 + 5 * 256 + 2)
              + 4 * (rows * (w * bpp + 1) + 1))
    ops = rows * w * pixel_ops(bpp, True, ladder)
    ops += rows * 5 * (256 * COST_BIN_OPS + COST_ROW_OPS)
    ops += CANDIDATE_OPS * 5 * rows * w * bpp
    return ops, nbytes


def bound_s(ops: int, nbytes: int) -> float:
    """The least seconds for ``ops`` int32 operations and ``nbytes``."""
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
