"""Kernel inputs at the edges of the row and image kernels' design.

``csrc/quantize.cuh`` keeps each warp's histogram in registers, selects
with two reductions, patches a pixel's later channels with its earlier
symbols, loads inputs two pixels ahead and runs bands wider than the warp
through a separate loop. These cases reach each of those edges: rows wider
than the warp and than shared memory would hold, bands over 32 lanes
(s 255), extreme bleeds with negative dither, a channel's symbol inside
the next channel's band (equal channels), transparent pixels at bpp 2 and
4, and ragged widths. The image kernel's retry variant (the ladder) runs
the pixel chain at strengths that fall row by row: its cases (``retry-``,
noise rows that fail the MSAD self-check at full strength) start at
strength 32, so a retry at 31 changes from the wide loop to the narrow
one, at 255, at 2, 1 and 0, and fail on every row. ``chip_smoke.py``
(phase 3a) and ``tests/test_torch_cuda.py`` hold each kernel to its plain
version on them.

``csrc/hist.cu`` gives each lane 16 bytes of a row, loads them as one
vector where the base and the pitch allow it and as bytes where they do
not, packs several narrow rows into a warp, and splits an image's
rows over several blocks. ``HIST_EDGES`` reaches those edges: row
pitches from 1 byte to 16396, bases 1 and 4 bytes off a 16-byte boundary,
a constant image (one hot bin per filter), real sizes of 1 x 1 and of the
whole plane, 1 image and 33.

``row_retry_inputs`` gives the row kernel's retry variant (row 0's
ladder) the same cases: row 0 from the zero state and row 1 from the
carried state.

``give_up_inputs`` reaches the retry variants' give-up branch (no filter
passes at strength 0) through the test-only ``never_pass`` flag: flagged
images at strengths 0, 1, 2 and 40 (which starts in the wide-band loop and
falls below it) beside unflagged ones, in one launch.

``rows_by_step`` is what the card checks hold ``optimize_gpu.optimize_rows``
to: the same per-row path with the strength loop of every row on the host,
around the row kernel's one-attempt variant.
"""

from __future__ import annotations

import numpy as np
import torch

from pngloss_tpu_torch.convert import Carry
from pngloss_tpu_torch.ops import row
from pngloss_tpu_torch.ops.optimize import strength_loop

# name: (B, W, bpp, strengths, bleed, dither bound, equal channels[, rows])
ROWS = 3
EDGES = {
    "w1408-bpp4-s255-bleed1": (2, 1408, 4, [255, 19], 1, 300, False),
    "w4096-bpp4-bleed32767": (1, 4096, 4, [40], 32767, 300, False),
    "w64-bpp1-s255-bleed1": (2, 64, 1, [255, 254], 1, 300, False),
    "equal-channels-bpp3": (3, 40, 3, [3, 19, 40], 2, 0, True),
    "equal-channels-bpp2": (3, 40, 2, [19, 255, 0], 1, 40, True),
    "equal-channels-bpp4": (2, 33, 4, [19, 31], 32767, 40, True),
    # the retry variant's (the seed comes from the name): images that start
    # at strength 32 and retry below it
    "retry-from-s32-bpp3": (6, 40, 3, [32, 32, 32, 33, 31, 32], 2, 40, False,
                            6),
    "retry-from-s32-bpp1": (6, 64, 1, [32, 32, 32, 33, 31, 32], 2, 40, False,
                            6),
    # strength 0, and a strength-255 image that retries 78 times
    "retry-s0-s1-s255-bpp4": (6, 24, 4, [0, 1, 255, 1, 255, 1], 1, 40, False,
                              5),
    # rows that fail at strength 1 and 2 and end at 0 and 1
    "retry-to-s0-w64-bpp1": (6, 64, 1, [1, 1, 2, 1, 2, 1], 2, 10, False, 6),
    # image 0 fails on every row (46, 74, 14 and 67 attempts)
    "retry-every-row-w64-s150-bpp2-e40": (2, 64, 2, [150, 150], 2, 40, False,
                                          5),
}


def _i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int32), device=device)


def edge_inputs(name: str, device):
    """(row-kernel args, image-kernel args over ROWS rows, or as many as
    the case names) for one EDGES case, on ``device``; the same seed gives
    the same values on every device."""
    b, w, bpp, strengths, bleed, err, equal, *more = EDGES[name]
    h = more[0] if more else ROWS
    rng = np.random.default_rng(sum(map(ord, name)))
    if equal:
        orig = np.repeat(rng.integers(100, 112, (b, w, 1)), bpp, 2)
        img = np.repeat(rng.integers(96, 116, (b, h, w, 1)), bpp, 3)
    else:
        orig = rng.integers(0, 256, (b, w, bpp))
        img = rng.integers(0, 256, (b, h, w, bpp))
    if bpp % 2 == 0:
        orig[:, ::3, bpp - 1] = 0
        img[:, :, 1::3, bpp - 1] = 0
    w_real = [w - 7 * k for k in range(b)]
    st = dict(
        orig=orig, qprev=rng.integers(0, 256, (b, w, bpp)),
        e0=rng.integers(-err, err + 1, (b, w + 5, 4)),
        e1=rng.integers(-err, err + 1, (b, w + 5, 4)),
        hist=rng.integers(0, 40, (b, 256)),
        ofreq=rng.integers(0, 40, (b, 5, 256)))
    st = {k: _i32(v, device) for k, v in st.items()}
    s, wr = _i32(strengths, device), _i32(w_real, device)
    rows = torch.as_tensor(img.reshape(b, h, w * bpp).astype(np.uint8),
                           device=device)
    return ((s, bleed, st["orig"], st["qprev"], st["e0"], st["e1"],
             st["hist"], st["ofreq"], wr),
            (s, bleed, wr, st["ofreq"], rows, st["qprev"], st["e0"],
             st["e1"], st["hist"]))


def row_retry_inputs(image_args):
    """The row kernel's retry variant's arguments (s, bleed, orow, carry,
    ofreq, w_real) from image-kernel arguments (an EDGES or GIVE_UP case):
    row 0 from the zero state, and row 1 from the case's carried state,
    the originals of row 0 as the previous row's (the EDGES ``retry-``
    cases' rows 1 retry from strength 32, 255, 2 and 1)."""
    s, bleed, wr, ofreq, rows, qprev, e0, e1, hist = image_args
    b, h, wb = rows.shape
    w, bpp = qprev.shape[1], qprev.shape[2]
    orig = rows.view(b, h, w, bpp).to(torch.int32)
    o0, o1 = orig[:, 0].contiguous(), orig[:, 1].contiguous()
    return [(s, bleed, o0, row.zero_carry(b, w, bpp, rows.device), ofreq, wr),
            (s, bleed, o1, Carry(qprev, o0, e0, e1, hist), ofreq, wr)]


# per image: strength, never_pass flag, real width (of GIVE_UP_W)
GIVE_UP = ((0, 1, 16), (1, 1, 9), (2, 1, 16), (40, 1, 5), (40, 0, 16),
           (2, 0, 12))
GIVE_UP_H, GIVE_UP_W = 4, 16


def give_up_inputs(bpp: int, device, strengths=None):
    """(image-kernel args, never_pass (B,) int32) of the GIVE_UP batch at
    ``bpp``, with ``strengths`` in place of its own where given; the same
    seed gives the same values on every device."""
    s, flags, w_real = (list(c) for c in zip(*GIVE_UP))
    b, h, w = len(GIVE_UP), GIVE_UP_H, GIVE_UP_W
    rng = np.random.default_rng(980 + bpp)
    img = rng.integers(0, 256, (b, h, w, bpp))
    if bpp % 2 == 0:
        img[:, :, 1::3, bpp - 1] = 0
    st = dict(qprev=rng.integers(0, 256, (b, w, bpp)),
              e0=rng.integers(-40, 41, (b, w + 5, 4)),
              e1=rng.integers(-40, 41, (b, w + 5, 4)),
              hist=rng.integers(0, 40, (b, 256)),
              ofreq=rng.integers(0, 40, (b, 5, 256)))
    st = {k: _i32(v, device) for k, v in st.items()}
    rows = torch.as_tensor(img.reshape(b, h, w * bpp).astype(np.uint8),
                           device=device)
    return ((_i32(s if strengths is None else strengths, device), 2,
             _i32(w_real, device), st["ofreq"], rows, st["qprev"], st["e0"],
             st["e1"], st["hist"]), _i32(flags, device))


# name: (B, H, W in pixels, bytes the base lies after a 16-byte boundary,
# constant image)
HIST_EDGES = {
    "w1": (3, 5, 1, 0, False),
    "w15": (3, 5, 15, 0, False),
    "w17": (3, 6, 17, 0, False),
    "w4099": (2, 3, 4099, 0, False),
    "w48-rows-share-a-warp": (2, 21, 48, 0, False),
    "w512-aligned": (2, 9, 512, 0, False),
    "w64-base-off-by-1": (2, 7, 64, 1, False),
    "w64-base-off-by-4": (2, 7, 64, 4, False),
    "w176-constant": (2, 11, 176, 0, True),
    "b1": (1, 40, 33, 0, False),
    "b33": (33, 4, 20, 0, False),
}


def hist_edge_inputs(name: str, bpp: int, device):
    """Argument tuples (rows, bpp, w_real, h_real) of the pre-pass for one
    HIST_EDGES case: every plane whole, then ragged real sizes (image 0
    whole, the last image 1 x 1, the others seeded). The same seed gives
    the same values on every device."""
    b, h, w, shift, constant = HIST_EDGES[name]
    rng = np.random.default_rng(sum(map(ord, name)) + bpp)
    if constant:
        img = np.full((b, h, w * bpp), 7, np.uint8)
    else:
        img = rng.integers(0, 256, (b, h, w * bpp)).astype(np.uint8)
        img[0, :, : (w * bpp) // 2] //= 64                # a few hot bins
    # the plane starts ``shift`` bytes into a fresh (aligned) allocation
    flat = torch.zeros(shift + img.size, dtype=torch.uint8, device=device)
    flat[shift:] = torch.as_tensor(img.reshape(-1), device=device)
    rows = flat[shift:].view(b, h, w * bpp)
    w_real = rng.integers(1, w + 1, b)
    h_real = rng.integers(1, h + 1, b)
    w_real[0], h_real[0] = w, h
    w_real[-1], h_real[-1] = (1, 1) if b > 1 else (w, 1)
    return [(rows, bpp, None, None),
            (rows, bpp, _i32(w_real, device), _i32(h_real, device))]


def rows_by_step(s, bleed: int, orig, ofreq, w_real):
    """``optimize_gpu.optimize_rows`` from row 0 with the strength loop of
    every row on the host: ``strength_loop`` around ``row.row_attempt``
    per row, one launch of the row kernel's one-attempt variant and one
    host sync per attempt, the row cost and the self-check in PyTorch. It
    shares no code with the two retry kernels (the row kernel's and the
    image kernel's), so it holds both. Returns the winner rows, their
    filter ids (B, R) int64 and the attempts each image took (B,) int32."""
    b, r, w, bpp = orig.shape
    carry = row.zero_carry(b, w, bpp, orig.device)
    q = torch.empty_like(orig)
    f = torch.empty((b, r), dtype=torch.int64, device=orig.device)
    attempts = torch.zeros(b, dtype=torch.int32, device=orig.device)
    for y in range(r):
        orow = orig[:, y].contiguous()
        qprev, oprev, e0, e1, hist = carry

        def attempt(s_try):
            return row.row_attempt(s_try, bleed, orow, qprev, e0, e1, hist,
                                   ofreq, w_real)

        (qn, hn, e0n, e1n), f[:, y], tries = strength_loop(
            attempt, s, orow, qprev, oprev, e0, e1, hist, w_real)
        carry = Carry(qn, orow, e0n, e1n, hn)
        q[:, y] = qn
        attempts += tries
    return q, f, attempts
