"""Original-frequency pre-pass: per image, the 5x256 histograms of the
original residuals under each PNG filter (optimize_state.c:66-83).

Counterpart of ``pngloss_tpu/ops/pallas_hist.py`` (``_hist_kernel``). On a
CUDA tensor ``original_frequencies`` launches ``csrc/hist.cu``; on a CPU
tensor it runs ``original_frequencies_ref``.
"""

from __future__ import annotations

import torch

from pngloss_tpu_torch.ops import _build
from pngloss_tpu_torch.ops.optimize import NUM_FILTERS, residual_symbols

LAUNCHES = 0


def _full(v, n: int, fill: int, device) -> torch.Tensor:
    if v is None:
        return torch.full((n,), fill, dtype=torch.int32, device=device)
    return torch.as_tensor(v, dtype=torch.int32, device=device)


def original_frequencies_ref(rows, bpp: int, w_real=None, h_real=None):
    """Plain version. rows (B, H, W*bpp) uint8; w_real/h_real (B,) real
    sizes of padded planes (samples outside count nothing).
    Returns (B, 5, 256) int32."""
    b, h, wb = rows.shape
    w = wb // bpp
    imgs = rows.view(b, h, w, bpp).to(torch.int32)
    syms = residual_symbols(imgs)                       # (B, 5, H, W, bpp)
    wr = _full(w_real, b, w, rows.device)
    hr = _full(h_real, b, h, rows.device)
    keep = ((torch.arange(w, device=rows.device)[None, None, :]
             < wr[:, None, None])
            & (torch.arange(h, device=rows.device)[None, :, None]
               < hr[:, None, None]))
    weight = keep[:, None, :, :, None].expand(syms.shape).to(torch.int32)
    out = torch.zeros((b, NUM_FILTERS, 256), dtype=torch.int32,
                      device=rows.device)
    out.scatter_add_(2, syms.reshape(b, NUM_FILTERS, -1).long(),
                     weight.reshape(b, NUM_FILTERS, -1))
    return out


def original_frequencies(rows, bpp: int, w_real=None, h_real=None):
    """(B, 5, 256) int32 residual histograms of rows (B, H, W*bpp) uint8.
    A CUDA tensor launches the kernel; a CPU tensor runs the plain
    version."""
    global LAUNCHES
    if _build.route(rows) == "cpu":
        return original_frequencies_ref(rows, bpp, w_real, h_real)
    b, h, wb = rows.shape
    wr = _full(w_real, b, wb // bpp, rows.device)
    hr = _full(h_real, b, h, rows.device)
    _build.require(rows, "rows", torch.uint8, (b, h, wb))
    _build.require(wr, "w_real", torch.int32, (b,))
    _build.require(hr, "h_real", torch.int32, (b,))
    if not 1 <= bpp <= 4 or wb % bpp:
        raise ValueError(f"bad bpp {bpp} for row width {wb}")
    out = torch.zeros((b, NUM_FILTERS, 256), dtype=torch.int32,
                      device=rows.device)
    lib = _build.library()
    with torch.cuda.device(rows.device):
        _build.check(lib.plk_hist(
            rows.data_ptr(), wr.data_ptr(), hr.data_ptr(), out.data_ptr(),
            b, h, wb // bpp, bpp, _build.stream_ptr(rows)), "plk_hist")
    LAUNCHES += 1
    return out
