"""Image generators of the benchmark's traffic, drawn from a numpy
Generator: each returns opaque (h, w, 4) uint8 RGBA, or applies an alpha.

Frozen copies, so that later changes to their originals do not move the
benchmark's inputs: ``synthetic_rgb``, ``photo_rgb`` and ``screenshot_rgb``
from ``chip_smoke.py`` (:355, :2328, :2355), the noise draw of
``chip_smoke.embedding_batch`` (:1143) and the alpha tiles of
``bench_torch.rgba_images`` (:131), all at commit 942c847. Only the
signatures differ: one image a call, at any size.
"""

from __future__ import annotations

import numpy as np


def synthetic_rgb(rng, h: int, w: int) -> np.ndarray:
    """Smooth gradients plus seeded +-12 noise."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x + y) * 255 // max(h + w - 2, 1)], -1).astype(np.int64)
    out = np.full((h, w, 4), 255, np.uint8)
    out[..., :3] = np.clip(base + rng.integers(-12, 13, (h, w, 3)), 0, 255)
    return out


def noise_rgb(rng, h: int, w: int) -> np.ndarray:
    """Uniform noise in every colour channel."""
    out = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    out[..., 3] = 255
    return out


def photo_rgb(rng, h: int, w: int) -> np.ndarray:
    """Like a camera photo: smooth gradients under a +-6 grain, fine
    texture (+-40) in the lower third, and hard edges (12 flat rectangles
    and 8 flat discs below the top eighth)."""
    y, x = np.ogrid[0:h, 0:w]
    rgb = np.empty((h, w, 3), np.int16)
    rgb[..., 0] = 30 + x * 190 // w
    rgb[..., 1] = 40 + y * 170 // h
    rgb[..., 2] = 60 + (x + y) * 130 // (h + w)
    rgb += rng.integers(-6, 7, (h, w, 3), dtype=np.int16)
    lo = 2 * h // 3
    rgb[lo:] += rng.integers(-40, 41, (h - lo, w, 3), dtype=np.int16)
    for _ in range(12):
        top, left = int(rng.integers(h // 8, h)), int(rng.integers(0, w))
        rgb[top:top + int(rng.integers(h // 75 + 1, h // 4 + 2)),
            left:left + int(rng.integers(w // 100 + 1, w // 4 + 2))] = (
                rng.integers(0, 256, 3, dtype=np.int16))
    for _ in range(8):
        cy, cx = int(rng.integers(h // 8, h)), int(rng.integers(0, w))
        r = int(rng.integers(h // 150 + 1, h // 6 + 2))
        rgb[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.integers(
            0, 256, 3, dtype=np.int16)
    out = np.full((h, w, 4), 255, np.uint8)
    out[..., :3] = np.clip(rgb, 0, 255)
    return out


def screenshot_rgb(rng, h: int, w: int) -> np.ndarray:
    """Like a desktop screenshot: flat fills (a page, a dark sidebar, 6
    panels), lines of text-like glyphs every 22 px drawn with 1-2 px
    strokes, and one gradient (the title bar)."""
    out = np.full((h, w, 4), 255, np.uint8)
    out[..., :3] = (246, 246, 244)
    side = w // 6
    out[:, :side, :3] = (40, 44, 52)
    for _ in range(6):
        top = int(rng.integers(h // 18, h - h // 10 + 1))
        left = int(rng.integers(side, w - w // 10 + 1))
        out[top:top + int(rng.integers(h // 18 + 1, h // 4 + 2)),
            left:left + int(rng.integers(w // 13 + 1, w // 3 + 2)),
            :3] = rng.integers(200, 256, 3)
    bar = h // 27 + 1
    for c, (lo, hi) in enumerate(((20, 90), (60, 140), (150, 230))):
        out[:bar, :, c] = np.linspace(lo, hi, w).astype(np.uint8)
    for line in range(bar + 20, h - 20, 22):
        x = 10 + int(rng.integers(0, 30))
        while x < w - 20:
            ink = (230, 230, 230) if x < side else (30, 30, 30)
            for _ in range(int(rng.integers(2, 9))):           # a word
                for _ in range(int(rng.integers(2, 4))):       # strokes
                    th = int(rng.integers(1, 3))
                    if rng.random() < 0.5:
                        y0 = line + int(rng.integers(0, 12))
                        out[y0:y0 + th, x:x + int(rng.integers(3, 9)),
                            :3] = ink
                    else:
                        x0 = x + int(rng.integers(0, 7))
                        out[line:line + int(rng.integers(6, 14)),
                            x0:x0 + th, :3] = ink
                x += 9
            x += int(rng.integers(6, 30))
    return out


KINDS = {"synthetic": synthetic_rgb, "noise": noise_rgb,
         "photo": photo_rgb, "screenshot": screenshot_rgb}


def alpha_tiles(rng, im: np.ndarray, tile: int) -> np.ndarray:
    """``im``'s alpha, in place, as tile-px tiles that are in turn fully
    transparent, partly transparent (a ramp over 1-254) and opaque, the
    turn shifted by a draw; any 2 x 2 tiles hold all three."""
    h, w = im.shape[:2]
    y, x = np.mgrid[0:h, 0:w]
    ramp = (1 + (x + y) % 254).astype(np.uint8)
    kind = (y // tile + 2 * (x // tile) + int(rng.integers(0, 3))) % 3
    im[..., 3] = np.where(kind == 0, 0, np.where(kind == 1, ramp, 255))
    return im
