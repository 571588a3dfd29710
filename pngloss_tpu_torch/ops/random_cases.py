"""Random inputs for the port's differential checks (``tools/fuzz_torch.py``).

``random_case`` draws one RGBA image and a strength, as the JAX package's
fuzz loop does (``tools/fuzz_loop.py``, ``random_case``): six kinds (gray,
gray+alpha, RGB, RGBA, flat, noisy), random sizes, transparent stripes on
every other row of half the images with alpha, and strengths over 0-255.
``random_bleed`` draws a batch's bleed. Those feed the entry points.

``random_bucket`` feeds the kernels directly: one padded shape, from the
pipeline's pad ladder, wide and short (2-4 rows of 200-1536 px at bpp 4)
or, where its limit on channel steps allows, long (2-3 rows of 2000-8192
px at bpp 1-4: the rows of users' photos and screenshots), and B images whose real sizes lie inside it, zero-padded as the pipeline
pads them, so that one batch is one launch of each kernel. Per image it
draws a strength over 0-255 and, for low strengths, sometimes the
test-only ``never_pass`` flag of the image kernel's adaptive and retry
variants (every filter fails the self-check: the rows retry down to
strength 0 and take the give-up branch).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pngloss_tpu_torch.pipeline import _SIZE_LADDER, pack_work

KINDS = ("gray", "gray_alpha", "rgb", "rgba", "flat", "noisy")
BLEEDS = (1, 2, 3, 5, 17, 255, 32767)
# images a bucket holds at most; the share of wide, short buckets and their
# rows and pixels (at bpp 4)
MAX_BATCH = 8
WIDE_SHARE, WIDE_H, WIDE_W = 0.125, (2, 4), (200, 1536)
# the share of long buckets, their rows and pixels (at bpp 1-4); drawn only
# where max_steps holds the smallest of them, so that a lower limit draws
# the same buckets as before they existed
LONG_SHARE, LONG_H, LONG_W = 0.25, (2, 3), (2000, 8192)
# never_pass is drawn, for half of them, only for images at strengths up
# to this: a flagged row takes s + 1 attempts
NEVER_PASS_MAX_STRENGTH = 16


def random_rgba(rng, kind: str, h: int, w: int) -> np.ndarray:
    """(h, w, 4) uint8 image of one of KINDS."""
    if kind == "flat":
        rgba = np.full((h, w, 4), int(rng.integers(0, 256)), np.uint8)
        rgba[:, :, 3] = 255
        return rgba
    rgba = rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
    if kind in ("gray", "gray_alpha"):
        rgba[:, :, 0] = rgba[:, :, 2] = rgba[:, :, 1]
    if kind in ("gray", "rgb", "noisy"):
        rgba[:, :, 3] = 255
    if kind in ("gray_alpha", "rgba") and rng.random() < 0.5:
        rgba[::2, :, 3] = 0        # the transparent-pixel rule
    return rgba


def random_case(rng, max_px: int = 16, max_strength: int = 255):
    """(kind, rgba (h, w, 4) uint8, strength): sides 1..max_px, strength
    0..max_strength."""
    kind = str(rng.choice(KINDS))
    h = int(rng.integers(1, max_px + 1))
    w = int(rng.integers(1, max_px + 1))
    return kind, random_rgba(rng, kind, h, w), int(rng.integers(
        0, max_strength + 1))


def random_bleed(rng) -> int:
    return int(rng.choice(BLEEDS))


@dataclasses.dataclass
class Bucket:
    """B zero-padded working-format planes of one padded shape."""
    bpp: int
    rows: np.ndarray              # (B, H, W*bpp) uint8
    kinds: list[str]
    w_real: np.ndarray            # (B,) int32
    h_real: np.ndarray            # (B,) int32
    strengths: np.ndarray         # (B,) int32
    never_pass: np.ndarray        # (B,) int32

    @property
    def shape(self) -> tuple[int, int]:
        """Padded (H, W) in pixels."""
        return self.rows.shape[1], self.rows.shape[2] // self.bpp


def random_bucket(rng, max_steps: int = 4096, max_strength: int = 255
                  ) -> Bucket:
    """One bucket: a padded shape whose image-kernel chain, (H-1) x W x
    bpp channel steps, is at most ``max_steps`` (the plain versions' cost
    on the card grows with it): long with probability LONG_SHARE where
    ``max_steps`` allows (LONG_H - 1) x LONG_W steps, else wide and short
    with probability WIDE_SHARE, else H and W from the pad ladder; then
    1..MAX_BATCH images, the first of the whole padded size, the others of
    real sizes drawn inside it."""
    long_fits = max_steps >= (LONG_H[0] - 1) * LONG_W[0]
    while True:
        if long_fits and rng.random() < LONG_SHARE:
            bpp = int(rng.integers(1, 5))
            h = int(rng.integers(LONG_H[0], LONG_H[1] + 1))
            w = int(rng.integers(LONG_W[0], LONG_W[1] + 1))
        elif rng.random() < WIDE_SHARE:
            bpp = 4
            h = int(rng.integers(WIDE_H[0], WIDE_H[1] + 1))
            w = int(rng.integers(WIDE_W[0], WIDE_W[1] + 1))
        else:
            bpp = int(rng.integers(1, 5))
            h = int(rng.choice(_SIZE_LADDER))
            w = int(rng.choice(_SIZE_LADDER))
        if (h - 1) * w * bpp <= max_steps:
            break
    b = int(rng.integers(1, MAX_BATCH + 1))
    rows = np.zeros((b, h, w * bpp), np.uint8)
    kinds, w_real, h_real = [], [], []
    for k in range(b):
        hr = h if k == 0 else int(rng.integers(1, h + 1))
        wr = w if k == 0 else int(rng.integers(1, w + 1))
        kind = str(rng.choice(KINDS))
        rows[k, :hr, :wr * bpp] = pack_work(random_rgba(rng, kind, hr, wr),
                                            bpp)
        kinds.append(kind)
        w_real.append(wr)
        h_real.append(hr)
    strengths = rng.integers(0, max_strength + 1, b)
    never_pass = ((strengths <= NEVER_PASS_MAX_STRENGTH)
                  & (rng.random(b) < 0.5))
    return Bucket(bpp, rows, kinds, np.asarray(w_real, np.int32),
                  np.asarray(h_real, np.int32), strengths.astype(np.int32),
                  never_pass.astype(np.int32))
