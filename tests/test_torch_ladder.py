"""Embedding mode's per-row path as a ladder (the image stage's retry
variant on the card tries k strengths of a row at once) and every image
variant stopping at its image's last real row, on the CPU.

The plain ladder (``ops/image.image_rows_ladder_ref``) against the
sequential plain version (``image_rows_retry_ref``: ``strength_loop``, one
strength at a time) for several k; the cluster size ``pick_ladder`` as a
pure function; ``h_real`` in the three plain versions and in embedding
mode against the JAX package (Pallas in interpret mode). Integers
throughout: exact equality, tolerance 0.
"""

import functools
import math

import numpy as np
import pytest
import torch

from pngloss_tpu.ops.optimize_pallas import optimize_batch_pallas
from pngloss_tpu_torch import reference as ref
from pngloss_tpu_torch.ops import (
    hist,
    image,
    ladder,
    optimize,
    optimize_batch_auto,
    optimize_gpu,
)
from pngloss_tpu_torch.ops.edges import edge_inputs, give_up_inputs

# inputs whose rows retry from strengths 0, 1 and 255 (and 78 times), from
# 1 and 2 down to 0, from 32 across the wide-band loop's edge, and the
# give-up batch: never_pass on images at 0, 1, 2 and 40 beside unflagged
# images at 40 and 2
CASES = ("retry-s0-s1-s255-bpp4", "retry-to-s0-w64-bpp1",
         "retry-from-s32-bpp3", "give-up-bpp2")


def _case(name):
    """(image-stage args, never_pass or None) on the CPU."""
    if name.startswith("give-up"):
        return give_up_inputs(int(name[-1]), "cpu")
    return edge_inputs(name, "cpu")[1], None


@functools.lru_cache(maxsize=None)
def _sequential(name):
    """The sequential loop row by row (``strength_loop`` around one
    attempt, the carry passed by hand): winner rows, filters and the
    attempts of every row (B, H-1)."""
    args, flags = _case(name)
    s, bleed, w_real, ofreq, rows, qprev, e0, e1, hist0 = args
    b, h, _ = rows.shape
    w, bpp = qprev.shape[1:]
    orig = rows.view(b, h, w, bpp).to(torch.int32)
    state, q, f, n = (qprev, hist0, e0, e1), [], [], []
    for y in range(1, h):
        qp, hp, e0p, e1p = state

        def attempt(s_try):
            return optimize.quantize_row(s_try, bleed, orig[:, y], qp, e0p,
                                         e1p, hp, ofreq, w_real)

        state, best, tries = optimize.strength_loop(
            attempt, s, orig[:, y], qp, orig[:, y - 1], e0p, e1p, hp, w_real,
            flags)
        q.append(state[0])
        f.append(best)
        n.append(tries)
    return torch.stack(q, 1), torch.stack(f, 1), torch.stack(n, 1)


@pytest.mark.parametrize("name", CASES)
def test_cases_retry_and_the_sequential_versions_agree(name):
    """The cases reach what they are for: rows that take more than one
    attempt, and (give-up batch) s + 1 attempts a row for flagged images.
    The sequential plain version equals the row-by-row loop, which the
    ladder is held to below."""
    args, flags = _case(name)
    q, f, n = _sequential(name)
    assert int(n.max()) > 1
    if flags is not None:
        flagged = flags.bool()
        want = (args[0][flagged] + 1)[:, None].expand(-1, n.shape[1])
        np.testing.assert_array_equal(n[flagged].numpy(), want.numpy())
    got = image.image_rows_retry_ref(*args, never_pass=flags)
    for g, x in zip(got, (q, f, n.sum(1))):
        np.testing.assert_array_equal(g.numpy(), x.numpy())


@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("name", CASES)
def test_plain_ladder_equals_the_sequential_loop(name, k):
    """Rows, filters and attempts of the ladder at k equal the sequential
    plain version's (``image_rows_retry_ref``, equal to the row-by-row loop
    above); the rounds are sum over rows of ceil(attempts / k)."""
    args, flags = _case(name)
    rounds = torch.zeros(args[0].shape[0], dtype=torch.int32)
    got = image.image_rows_ladder_ref(*args, k=k, never_pass=flags,
                                      rounds=rounds)
    q, f, n = _sequential(name)
    for g, x in zip(got, (q, f, n.sum(1))):
        np.testing.assert_array_equal(g.numpy(), x.numpy())
    want_rounds = [sum(math.ceil(int(a) / k) for a in row) for row in n]
    assert rounds.tolist() == want_rounds


@functools.lru_cache(maxsize=None)
def _candidates(name):
    """The band candidates of the sequential plain version, each image run
    alone, summed."""
    args, flags = _case(name)
    count = torch.zeros((), dtype=torch.int64)
    for i in range(args[0].shape[0]):
        one = [a if isinstance(a, int) else a[i:i + 1] for a in args]
        image.image_rows_retry_ref(
            *one, count=count, never_pass=None if flags is None
            else flags[i:i + 1])
    return int(count)


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("name", CASES)
def test_plain_ladder_counts_the_sequential_loops_candidates(name, k):
    """The band candidates the plain ladder counts (chip_smoke.py's bound
    of the retry variant) are those of the attempts the sequential loop
    takes, at every k: each image's ``image_rows_retry_ref`` count, run
    alone (in a batch the sequential version reruns the images that have
    passed), summed; the rungs below a round's winner are left out."""
    args, flags = _case(name)
    got = torch.zeros((), dtype=torch.int64)
    image.image_rows_ladder_ref(*args, k=k, never_pass=flags, count=got)
    assert _candidates(name) > 0
    assert int(got) == _candidates(name)


def test_image_rows_on_the_cpu_runs_the_ladder():
    """``image_rows(retry=True)`` on CPU tensors is the plain ladder, at k
    = 1 unless k is given; k and rounds belong to the retry variant."""
    args, flags = give_up_inputs(2, "cpu", strengths=[0, 1, 2, 3, 9, 2])
    for k in (None, 4):
        rounds = torch.zeros(args[0].shape[0], dtype=torch.int32)
        got = image.image_rows(*args, adaptive=True, retry=True,
                               never_pass=flags, k=k, rounds=rounds)
        want_rounds = torch.zeros_like(rounds)
        want = image.image_rows_ladder_ref(*args, k=k or 1, never_pass=flags,
                                           rounds=want_rounds)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), x.numpy())
        assert rounds.tolist() == want_rounds.tolist()
    with pytest.raises(ValueError, match="retry variant"):
        image.image_rows(*args, adaptive=True, k=2)
    with pytest.raises(ValueError, match="k must be"):
        image.image_rows_ladder_ref(*args, k=0)


RESIDENT = {8: 16, 4: 33, 2: 66, 1: 132}


@pytest.mark.parametrize("b, resident, sms, want", [
    (1, RESIDENT, 132, 8), (2, RESIDENT, 132, 8), (16, RESIDENT, 132, 8),
    # residency: 17 clusters of 8 do not fit, 33 of 4 do
    (17, RESIDENT, 132, 4), (33, RESIDENT, 132, 4), (34, RESIDENT, 132, 2),
    (66, RESIDENT, 132, 2), (67, RESIDENT, 132, 1), (132, RESIDENT, 132, 1),
    (500, RESIDENT, 132, 1),
    # an SM for every block: 20 x 8 blocks would share SMs
    (20, {8: 40, 4: 80, 2: 160, 1: 320}, 132, 4),
    (12, {8: 10, 4: 40, 2: 80, 1: 160}, 132, 4),
    (2, {}, 132, 1),
])
def test_pick_ladder(b, resident, sms, want):
    assert ladder.pick_ladder(b, resident, sms) == want


def test_pick_ladder_sizes():
    assert ladder.LADDER_SIZES == (8, 4, 2, 1)
    assert ladder.MAX_RUNGS == 8


def _run(variant, args, flags, h_real):
    if variant == "cli":
        return image.image_rows_ref(*args, h_real=h_real)
    if variant == "adaptive":
        return image.image_rows_ref(*args, adaptive=True, never_pass=flags,
                                    h_real=h_real)
    if variant == "sequential":
        return image.image_rows_retry_ref(*args, never_pass=flags,
                                          h_real=h_real)
    return image.image_rows_ladder_ref(*args, k=int(variant[-1]),
                                       never_pass=flags, h_real=h_real)


@pytest.mark.parametrize("bpp", [1, 4])
@pytest.mark.parametrize("variant", ["cli", "adaptive", "sequential",
                                     "ladder-1", "ladder-3"])
def test_every_variant_stops_at_the_last_real_row(variant, bpp):
    """With h_real each image's real rows equal the image cut to its
    real height and run alone; the rows after them are 0; ok and attempts
    count real rows only."""
    args, flags = give_up_inputs(bpp, "cpu", strengths=[0, 1, 2, 3, 9, 2])
    hr = torch.tensor([4, 2, 1, 3, 4, 2], dtype=torch.int32)
    got = _run(variant, args, flags, hr)
    for i, h in enumerate(hr.tolist()):
        assert not got[0][i, h - 1:].any() and not got[1][i, h - 1:].any()
        if h == 1:
            # no row after row 0: ok stays 1, no attempt
            if len(got) == 3:
                assert int(got[2][i]) == (variant == "adaptive")
            continue
        one = [t[i:i + 1] if torch.is_tensor(t) else t for t in args]
        one[4] = one[4][:, :h].contiguous()            # rows
        alone = _run(variant, one, flags[i:i + 1], None)
        for g, x in zip(got, alone):
            np.testing.assert_array_equal(g[i, :h - 1].numpy()
                                          if g.dim() > 1 else g[i].numpy(),
                                          x[0].numpy())


def _ragged_noise():
    """A ragged bucket of 3 noise images, 6 rows of 7 px RGB, at -s 45
    with real heights 4, 3 and 6: image 1 passes the MSAD self-check at
    full strength over its 3 real rows but not over all 6 (its padded rows
    are noise; the pipeline pads with zeros, and noise shows that a padded
    row is not run); images 0 and 2 fail over their real rows."""
    rows = np.random.default_rng(10).integers(0, 256, (3, 6, 21),
                                              dtype=np.uint8)
    return rows, np.asarray([4, 3, 6], np.int32), 45


def test_padded_rows_neither_fail_nor_retry(monkeypatch):
    """Image 1's padded rows would fail the self-check: over its real rows
    the speculation (the adaptive variant) passes it, so it would not be
    sent to the per-row fallback, and embedding mode's one call of the
    retry variant takes one attempt for each of its real rows after row 0;
    every image's planes and filters equal pngloss_tpu's (Pallas in
    interpret mode, which runs the padded rows too) and the scalar
    model's over its real rows, and are 0 after them."""
    bpp = 3
    rows, h_real, strength = _ragged_noise()
    b, h, wb = rows.shape
    w = wb // bpp
    s = torch.full((b,), strength, dtype=torch.int32)
    wr = torch.full((b,), w, dtype=torch.int32)
    rows_t = torch.from_numpy(rows)
    ofreq = hist.original_frequencies(rows_t, bpp, wr,
                                      torch.from_numpy(h_real))
    c0, _ = optimize_gpu.row0(s, 2, rows_t[:, 0].reshape(b, w, bpp).to(
        torch.int32), ofreq, wr)
    args = (s, 2, wr, ofreq, rows_t, c0.qprev, c0.e0, c0.e1, c0.hist)
    hr = torch.from_numpy(h_real)
    assert image.image_rows(*args, adaptive=True)[2].tolist() == [0, 0, 0]
    assert image.image_rows(*args, adaptive=True,
                            h_real=hr)[2].tolist() == [0, 1, 0]
    whole = image.image_rows(*args, adaptive=True, retry=True)[2]
    assert int(whole[1]) > h - 1, "the padded rows do not retry"

    calls = []
    spy_on = image.image_rows

    def spy(*a, **k):
        out = spy_on(*a, **k)
        calls.append(out)
        return out

    monkeypatch.setattr(image, "image_rows", spy)
    q, f = optimize_batch_auto(rows, strength, 2, bpp=bpp, device="cpu",
                               use_row_filters=False, h_real=h_real)
    (_, _, tries), = calls
    assert int(tries[1]) == h_real[1] - 1
    assert int(tries[0]) > h_real[0] - 1 and int(tries[2]) > h - 1
    q, f = q.numpy(), f.numpy()
    qj, fj = optimize_batch_pallas(rows, np.full(b, strength, np.int32), 2,
                                   bpp=bpp, use_row_filters=False,
                                   interpret=True, h_real=h_real)
    qj, fj = np.asarray(qj), np.asarray(fj)
    for i, hh in enumerate(h_real):
        np.testing.assert_array_equal(q[i, :hh], qj[i, :hh])
        np.testing.assert_array_equal(f[i, :hh], fj[i, :hh])
        qr, fr = ref.optimize_image(rows[i, :hh], bpp, strength, 2, False)
        np.testing.assert_array_equal(q[i, :hh], qr)
        np.testing.assert_array_equal(f[i, :hh], fr)
        assert not q[i, hh:].any() and not f[i, hh:].any()
