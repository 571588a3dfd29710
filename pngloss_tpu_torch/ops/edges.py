"""Kernel inputs at the edges of the row and image kernels' design.

``csrc/quantize.cuh`` keeps each warp's histogram in registers, selects
with two reductions, patches a pixel's later channels with its earlier
symbols, loads inputs two pixels ahead and runs bands wider than the warp
through a separate loop. These cases reach each of those edges: rows wider
than the warp and than shared memory would hold, bands over 32 lanes
(s 255), extreme bleeds with negative dither, a channel's symbol inside
the next channel's band (equal channels), transparent pixels at bpp 2 and
4, and ragged widths. ``chip_smoke.py`` (phase 3a) and
``tests/test_torch_cuda.py`` hold each kernel to its plain version on
them.
"""

from __future__ import annotations

import numpy as np
import torch

# name: (B, W, bpp, strengths, bleed, dither bound, equal channels)
EDGES = {
    "w1408-bpp4-s255-bleed1": (2, 1408, 4, [255, 19], 1, 300, False),
    "w4096-bpp4-bleed32767": (1, 4096, 4, [40], 32767, 300, False),
    "w64-bpp1-s255-bleed1": (2, 64, 1, [255, 254], 1, 300, False),
    "equal-channels-bpp3": (3, 40, 3, [3, 19, 40], 2, 0, True),
    "equal-channels-bpp2": (3, 40, 2, [19, 255, 0], 1, 40, True),
    "equal-channels-bpp4": (2, 33, 4, [19, 31], 32767, 40, True),
}


def _i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int32), device=device)


def edge_inputs(name: str, device):
    """(row-kernel args, image-kernel args over 3 rows) for one EDGES
    case, on ``device``; the same seed gives the same values on every
    device."""
    b, w, bpp, strengths, bleed, err, equal = EDGES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    if equal:
        orig = np.repeat(rng.integers(100, 112, (b, w, 1)), bpp, 2)
        img = np.repeat(rng.integers(96, 116, (b, 3, w, 1)), bpp, 3)
    else:
        orig = rng.integers(0, 256, (b, w, bpp))
        img = rng.integers(0, 256, (b, 3, w, bpp))
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
    rows = torch.as_tensor(img.reshape(b, 3, w * bpp).astype(np.uint8),
                           device=device)
    return ((s, bleed, st["orig"], st["qprev"], st["e0"], st["e1"],
             st["hist"], st["ofreq"], wr),
            (s, bleed, wr, st["ofreq"], rows, st["qprev"], st["e0"],
             st["e1"], st["hist"]))
