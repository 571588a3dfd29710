"""Quality metrics for compressed images.

The port's own copy of ``pngloss_tpu/metrics.py``: the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import math

import numpy as np


def psnr_rgba(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR in dB between two (H, W, 4) uint8 RGBA images (inf if equal)."""
    diff = a.astype(np.int64) - b.astype(np.int64)
    mse = float(np.mean(diff * diff))
    if mse == 0:
        return math.inf
    return 10.0 * math.log10(255.0 * 255.0 / mse)
