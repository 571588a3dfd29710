"""Row 0's strength loop as a ladder (the row kernel's retry variant on the
card tries k strengths of the row at once), on the CPU.

The plain ladder (``ops/row.row_retry_ladder_ref``) against the sequential
plain version (``row_retry_ref``: ``strength_loop``, one strength at a
time) for k = 1, 2, 4 and 8 on 48-px noise rows that retry tens of times
at -s 90 and -s 255, from the zero state and from a mid-image state, at
bpp 1-4; and the row ladder's cluster size. The give-up branch and the
entry points are in ``test_torch_row_ladder_paths.py``. Integers
throughout: exact equality, tolerance 0.
"""

import functools
import math

import numpy as np
import pytest
import torch

from pngloss_tpu_torch.convert import Carry
from pngloss_tpu_torch.ops import hist, ladder, row

W, STRENGTHS, W_REAL = 48, (90, 255, 90, 255), (48, 41, 48, 30)
KS = (1, 2, 4, 8)
# per bpp, the seeds of the zero-state and the mid-image-state images:
# each batch's slowest image takes 40-83 attempts (most noise rows pass
# at once or take over 100), so every k runs several rounds within the
# file's time; an image at -s 255 retries in every batch
SEEDS = {1: (3, 4), 2: (22, 20), 3: (21, 21), 4: (0, 9)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run thousands of small tensor operations a
    round: one intra-op thread runs them faster than several, most of all
    beside other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _i32(a):
    return torch.as_tensor(np.asarray(a, np.int32))


def _rows(rng, bpp, b, h):
    """(b, h, W * bpp) uint8 noise, transparent pixels at bpp 2 and 4."""
    img = rng.integers(0, 256, (b, h, W, bpp))
    if bpp % 2 == 0:
        img[:, :, ::5, bpp - 1] = 0
    return torch.as_tensor(img.reshape(b, h, W * bpp).astype(np.uint8))


@functools.lru_cache(maxsize=None)
def _noise_case(bpp):
    """Row-retry arguments (s, bleed, orow, carry, ofreq, w_real) of 8
    48-px noise rows at -s 90, 255, 90, 255 (twice) with real widths 48,
    41, 48 and 30 (twice): images 0-3 from the zero state before row 0,
    images 4-7 from a seeded mid-image state."""
    zero_seed, mid_seed = SEEDS[bpp]
    b = len(STRENGTHS)
    wr = _i32(W_REAL)
    parts = []
    for seed, mid in ((zero_seed, False), (mid_seed, True)):
        rng = np.random.default_rng(seed)
        rows = _rows(rng, bpp, b, 2)
        ofreq = hist.original_frequencies(rows, bpp, wr, _i32([2] * b))
        orow = rows[:, 1].reshape(b, W, bpp).to(torch.int32)
        if mid:
            carry = Carry(_i32(rng.integers(0, 256, (b, W, bpp))),
                          rows[:, 0].reshape(b, W, bpp).to(torch.int32),
                          _i32(rng.integers(-40, 41, (b, W + 5, 4))),
                          _i32(rng.integers(-40, 41, (b, W + 5, 4))),
                          _i32(rng.integers(0, 40, (b, 256))))
        else:
            carry = row.zero_carry(b, W, bpp, "cpu")
        parts.append((orow, carry, ofreq))
    (o0, c0, f0), (o1, c1, f1) = parts
    return (_i32(STRENGTHS * 2), 2, torch.cat([o0, o1]),
            Carry(*(torch.cat([a, b_]) for a, b_ in zip(c0, c1))),
            torch.cat([f0, f1]), torch.cat([wr, wr]))


@functools.lru_cache(maxsize=None)
def _sequential(bpp):
    return row.row_retry_ref(*_noise_case(bpp))


def _flat(out):
    """row_retry's ((q, hist, e0n, e1n), filter, attempts) as one list."""
    state, best, tries = out
    return [*state, best, tries]


def _assert_same(got, want):
    for g, w in zip(_flat(got), _flat(want)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def _rounds(attempts, k):
    return [math.ceil(int(a) / k) for a in attempts]


def _image(args, i):
    """Image i of row-retry arguments (tensors and a Carry)."""
    return [Carry(*(t[i:i + 1] for t in a)) if isinstance(a, Carry)
            else a[i:i + 1] if torch.is_tensor(a) else a for a in args]


def _image_out(out, i):
    return [[t[i:i + 1] for t in out[0]], *(t[i:i + 1] for t in out[1:])]


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_noise_rows_retry_at_high_strength(bpp):
    """The cases reach what they are for: in each state an image takes
    tens of attempts, one at -s 255; the slowest image's result equals it
    run alone."""
    tries = _sequential(bpp)[2]
    zero, mid = tries[:4], tries[4:]
    assert int(zero.max()) >= 20 and int(mid.max()) >= 20, tries.tolist()
    assert int(tries[1::2].max()) >= 40, tries.tolist()
    i = int(tries.argmax())
    _assert_same(row.row_retry_ref(*_image(_noise_case(bpp), i)),
                 _image_out(_sequential(bpp), i))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_plain_row_ladder_equals_the_sequential_loop(bpp, k):
    """Row, histogram, dither rows, filter and attempts of the ladder at k
    equal the sequential plain version's, from the zero state and from a
    mid-image state; the rounds are ceil(attempts / k), as the kernel
    counts them."""
    rounds = torch.zeros(2 * len(STRENGTHS), dtype=torch.int32)
    got = row.row_retry_ladder_ref(*_noise_case(bpp), k=k, rounds=rounds)
    want = _sequential(bpp)
    _assert_same(got, want)
    assert rounds.tolist() == _rounds(want[2], k)


RESIDENT = {8: 16, 4: 33, 2: 66, 1: 132}


@pytest.mark.parametrize("b, resident, want", [
    (1, RESIDENT, 8), (16, RESIDENT, 8), (17, RESIDENT, 4),
    (33, RESIDENT, 4), (34, RESIDENT, 2), (66, RESIDENT, 2),
    (67, RESIDENT, 1), (132, RESIDENT, 1), (1000, RESIDENT, 1),
    # 15 clusters of 8 resident, one rung to an SM (an H100's count for
    # both ladders at bpp 3): 16 images take clusters of 4
    (16, {8: 15, 4: 30, 2: 66, 1: 132}, 4),
    # an SM for every block: 20 x 8 blocks would share SMs
    (20, {8: 40, 4: 80, 2: 160, 1: 320}, 4),
    (2, {}, 1),
])
def test_row_ladder_size(monkeypatch, b, resident, want):
    """The row ladder's k: ``ladder.pick_ladder`` over the clusters of the
    row kernel the card keeps resident (its own occupancy query,
    ``row.clusters``) and 132 SMs, from the batch size and bpp alone."""
    asked = []

    def resident_clusters(occupancy, bpp, device):
        asked.append((occupancy, bpp))
        return resident

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(ladder, "resident_clusters", resident_clusters)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda idx: Props())
    assert row.ladder_size(b, 3, "cuda:0") == want
    assert asked == [(row.clusters, 3)]
