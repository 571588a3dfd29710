"""Device entry point of the optimizer.

``optimize_batch_auto`` runs the optimizer, in CLI mode or embedding
mode, on the given device:
a CPU device runs the plain PyTorch versions of the kernels, a CUDA device
runs the kernels. Nothing here imports JAX, and nothing builds a kernel at
import time.
"""

from __future__ import annotations

import numpy as np
import torch

from pngloss_tpu_torch import tracing
from pngloss_tpu_torch.ops.optimize_gpu import (
    optimize_bands,
    optimize_batch,
    to_device,
)


class CudaUnavailableError(RuntimeError):
    """A CUDA device was asked for on a machine where CUDA is not
    available. Nothing falls back to the CPU."""


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no CUDA available
    raises ``CudaUnavailableError`` instead of running anywhere else."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise CudaUnavailableError(
            "device 'cuda' requested but CUDA is not available")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def optimize_batch_auto(rows, strength, bleed: int = 2, *, bpp: int, device,
                        use_row_filters: bool = True, w_real=None,
                        h_real=None, in_flight=None):
    """Optimize a batch of same-shaped working-format planes.

    rows: (B, H, W*bpp) uint8, numpy or tensor. strength: int or per-image
    (B,) values. w_real/h_real: per-image real sizes of padded planes
    (ragged batching). use_row_filters=False is embedding mode: every row
    must pass libpng's MSAD self-check. in_flight: the images the caller
    has on the card at once, these among them (None: these alone), which
    pick CLI mode's layout (``image.pick_split``). Returns ((B, H, W*bpp)
    uint8, (B, H) int8) tensors on ``device``. Host arrays go to a CUDA device
    from pinned memory without blocking; the call only queues work on
    the current stream and returns without waiting for the card.
    """
    device = resolve_device(device)

    def as_int32(v):
        if v is None:
            return None
        return to_device(v if torch.is_tensor(v) else np.asarray(v, np.int32),
                         device).to(torch.int32)

    with tracing.stage("ops.upload"):
        rows = to_device(rows, device)
        if rows.dtype != torch.uint8 or rows.dim() != 3:
            raise ValueError("rows must be a (B, H, W*bpp) uint8 array")
        strength, w_real, h_real = (as_int32(v)
                                    for v in (strength, w_real, h_real))
    return optimize_batch(rows, strength, int(bleed), bpp=bpp,
                          use_row_filters=use_row_filters,
                          w_real=w_real, h_real=h_real, in_flight=in_flight)


__all__ = ["CudaUnavailableError", "optimize_bands", "optimize_batch",
           "optimize_batch_auto", "resolve_device"]
