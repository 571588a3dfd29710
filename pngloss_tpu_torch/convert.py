"""State carried from one row to the next, and its JAX layout.

The system has no weights: what crosses from row to row (from row 0 into
the image stage, and from row to row of embedding mode's per-row path) is
the winner's state, a ``Carry``. ``pngloss_tpu.ops.optimize_pallas.
optimize_batch_pallas_t(..., return_carry=True)`` returns it in the TPU
layout (transposed batch lanes, stride-8 dither columns) after the rows it
ran: after row 0 when given one row, after row k-1 when given k rows, in
either mode. ``carry_from_jax`` turns it into the port's layout, so the
port's image stage and per-row path can be seeded from the JAX package at
any row and checked on their own.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_STRIDE = 8   # TPU layout: dither column j's 4 lanes at rows [8j, 8j+4)


class Carry(NamedTuple):
    qprev: torch.Tensor   # (B, W, bpp) int32 quantized previous row
    oprev: torch.Tensor   # (B, W, bpp) int32 original previous row
    e0: torch.Tensor      # (B, W+5, 4) int32 dither row 0 of the next row
    e1: torch.Tensor      # (B, W+5, 4) int32 dither row 1 of the next row
    hist: torch.Tensor    # (B, 256) int32 adaptive histogram


def carry_from_jax(carry, *, w: int, bpp: int, b: int) -> Carry:
    """carry = (qprev_t, oprev_t (W*bpp, B); e0, e1 (8(W+5), B);
    hist (256, B)) as numpy-convertible arrays -> Carry of CPU tensors."""
    qprev_t, oprev_t, e0, e1, hist = (np.asarray(a) for a in carry)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))

    def row(a):
        return tensor(a.reshape(w, bpp, b).transpose(2, 0, 1))

    def dither(a):
        return tensor(a.reshape(w + 5, _STRIDE, b)[:, :4].transpose(2, 0, 1))

    return Carry(row(qprev_t), row(oprev_t), dither(e0), dither(e1),
                 tensor(hist.reshape(256, b).T))
