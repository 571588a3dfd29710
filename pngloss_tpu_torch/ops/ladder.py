"""The strength ladder, shared by the row and the image kernels' retry
variants (``row.row_retry``, ``image.image_rows(retry=True)``).

A ladder runs one image per thread-block cluster of k blocks ("rungs"):
in round j rung r tries strength s - j*k - r, and the lowest rung with a
passing filter wins. This module holds what both kernels' ladders share:

  * ``ladder_round``: the winner of a round, for the plain versions;
  * the cluster size: ``pick_ladder`` over the clusters a kernel keeps
    resident (``resident_clusters``, from the kernel's own occupancy
    query), so it depends on the batch size and bpp alone and choosing it
    reads nothing from the card.
"""

from __future__ import annotations

import torch

from pngloss_tpu_torch.ops.optimize import NUM_FILTERS, adaptive_cost, first_min

# the cluster sizes, largest first; 8 is the largest portable cluster size
# and the most either kernel takes
LADDER_SIZES = (8, 4, 2, 1)
MAX_RUNGS = 8
# (occupancy query, device index, bpp) -> {k: clusters of k the card keeps
# resident}
_RESIDENT: dict = {}


def check_rungs(k: int) -> None:
    """Raises ValueError unless 1 <= k <= MAX_RUNGS."""
    if not 1 <= k <= MAX_RUNGS:
        raise ValueError(f"k must be 1..{MAX_RUNGS}, got {k}")


def ladder_round(passing, cost, s, j: int, k: int):
    """The winner of round j of a strength ladder (the plain versions of
    the row and image kernels' retry variants): B images x k rungs, rung r
    at strength s - j*k - r. passing (B*k, 5) bool, rungs below strength
    0 already failing; cost (B*k, 5) the true row costs; s (B,) the
    images' strengths. The lowest rung with a passing filter wins, its
    first passing minimum; where none passes and the round reached
    strength 0, the strength-0 rung with its first minimum of the true
    cost. Returns (decided (B,) bool, win (B,) the winning rung, lane
    (B,) its index in the B*k batch, best (B,) its filter)."""
    b = s.shape[0]
    passed = passing.view(b, k, NUM_FILTERS).any(2)                 # (B, k)
    some = passed.any(1)
    give_up = ~some & (s - j * k - (k - 1) <= 0)
    win = torch.where(some, passed.to(torch.int32).argmax(1),
                      (s - j * k).long())
    lane = torch.arange(b, device=s.device) * k + win.clamp(0, k - 1)
    pw = passing[lane]
    best = first_min(adaptive_cost(cost[lane],
                                   pw | ~pw.any(1, keepdim=True)))
    return some | give_up, win, lane, best


def pick_ladder(b: int, resident: dict, sms: int) -> int:
    """The cluster size for ``b`` images: the largest k of LADDER_SIZES
    for which the card keeps all b clusters of k blocks resident at once
    (``resident[k]``, cudaOccupancyMaxActiveClusters) and every block can
    have an SM of its own (b * k <= ``sms``); else 1."""
    for k in LADDER_SIZES:
        if resident.get(k, 0) >= b and b * k <= sms:
            return k
    return 1


def resident_clusters(occupancy, bpp: int, device) -> dict:
    """{k: the most clusters of k blocks of a kernel at ``bpp`` that
    ``device`` keeps resident at once}, for k in LADDER_SIZES, queried once
    per kernel, device and bpp. ``occupancy(k, bpp)`` is the kernel's own
    query on the current device (``image.clusters``, ``row.clusters``)."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    key = (occupancy, idx, bpp)
    if key not in _RESIDENT:
        with torch.cuda.device(idx):
            _RESIDENT[key] = {k: occupancy(k, bpp) for k in LADDER_SIZES}
    return _RESIDENT[key]


def ladder_size(occupancy, b: int, bpp: int, device) -> int:
    """``pick_ladder`` for ``b`` images at ``bpp`` on a CUDA ``device``,
    over the clusters of the kernel that ``occupancy`` queries
    (``resident_clusters``)."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    sms = torch.cuda.get_device_properties(idx).multi_processor_count
    return pick_ladder(b, resident_clusters(occupancy, bpp, idx), sms)
