"""Row 0's strength loop as a ladder, on the CPU: its give-up branch and
the entry points.

The plain ladder (``ops/row.row_retry_ladder_ref``) at k = 1, 2, 4 and 8
against the sequential plain version (``row_retry_ref``) on the give-up
batch (the test-only ``never_pass`` flag), ``row_retry`` on CPU tensors,
and ``optimize_batch_auto(device="cpu")`` on noise rows whose row 0
retries 69 times against the JAX package's ``optimize_batch_pallas`` in
interpret mode, in CLI mode and in embedding mode. Integers throughout:
exact equality, tolerance 0.
"""

import functools
import math

import numpy as np
import pytest
import torch

from pngloss_tpu.ops.optimize_pallas import optimize_batch_pallas
from pngloss_tpu_torch.convert import Carry
from pngloss_tpu_torch.ops import hist, optimize_batch_auto, row
from pngloss_tpu_torch.ops.edges import give_up_inputs, row_retry_inputs

KS = (1, 2, 4, 8)


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


@functools.lru_cache(maxsize=None)
def _give_up(bpp):
    """The give-up batch at bpp as row-retry arguments of row 0 (zero
    state) and row 1 (carried state), its never_pass flags, and the
    sequential plain version's output on each."""
    image_args, flags = give_up_inputs(bpp, "cpu")
    cases = row_retry_inputs(image_args)
    return cases, flags, [row.row_retry_ref(*a, never_pass=flags)
                          for a in cases]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_plain_row_ladder_gives_up_as_the_sequential_loop(bpp, k):
    """The give-up branch: never_pass on images at strengths 0, 1, 2 and
    40 beside unflagged images at 40 and 2, at row 0 (zero state) and row
    1 (carried state): equal to the sequential plain version, flagged
    images take s + 1 attempts (the strength-0 rung's true minimum wins),
    unflagged ones equal themselves run alone."""
    cases, flags, wants = _give_up(bpp)
    flagged = flags.bool()
    for args, want in zip(cases, wants):
        rounds = torch.zeros(flags.shape[0], dtype=torch.int32)
        got = row.row_retry_ladder_ref(*args, never_pass=flags, k=k,
                                       rounds=rounds)
        _assert_same(got, want)
        assert got[2][flagged].tolist() == (args[0][flagged] + 1).tolist()
        assert rounds.tolist() == _rounds(want[2], k)
        for i in (~flagged).nonzero().squeeze(1).tolist():
            _assert_same(row.row_retry_ladder_ref(*_image(args, i), k=k),
                         _image_out(got, i))


def test_row_retry_on_the_cpu_runs_the_plain_ladder():
    """``row_retry`` on CPU tensors is the plain ladder, at k = 1 unless k
    is given, and launches nothing; k outside 1..8 is refused."""
    cases, flags, wants = _give_up(3)
    args = cases[1]
    before = row.RETRY_LAUNCHES
    for k in (None, 4):
        rounds = torch.zeros(flags.shape[0], dtype=torch.int32)
        got = row.row_retry(*args, never_pass=flags, k=k, rounds=rounds)
        _assert_same(got, wants[1])
        assert rounds.tolist() == _rounds(wants[1][2], k or 1)
    assert row.RETRY_LAUNCHES == before
    for k in (0, 9):
        with pytest.raises(ValueError, match="k must be"):
            row.row_retry(*args, k=k)


def _pipeline_batch():
    """4 noise images of 2 rows x 48 px RGB at -s 90, 255, 90, 255 (seed
    30): row 0 of image 1 takes 69 attempts, the others 1."""
    rows = np.random.default_rng(30).integers(0, 256, (4, 2, 48 * 3))
    return rows.astype(np.uint8), np.asarray([90, 255, 90, 255], np.int32)


def test_pipeline_batch_retries_in_row_0():
    """The entry points' batch reaches what it is for: row 0 of one image
    retries 69 times."""
    rows, strengths = _pipeline_batch()
    b, _, wb = rows.shape
    t = torch.from_numpy(rows)
    wr = _i32([wb // 3] * b)
    ofreq = hist.original_frequencies(t, 3, wr, _i32([2] * b))
    tries = row.row0_retry(_i32(strengths), 2, t[:, 0].reshape(
        b, -1, 3).to(torch.int32), ofreq, wr)[2]
    assert tries.tolist() == [1, 69, 1, 1]


@pytest.mark.parametrize("use_row_filters", [True, False],
                         ids=["cli", "embedding"])
def test_entry_point_on_retrying_rows_matches_jax(use_row_filters):
    """``optimize_batch_auto(device="cpu")`` (row 0 through the plain
    ladder) equals the JAX package's ``optimize_batch_pallas`` in interpret
    mode, planes and filters, in CLI mode and in embedding mode, on a batch
    whose row 0 retries 69 times in one image."""
    rows, strengths = _pipeline_batch()
    q, f = optimize_batch_auto(rows, strengths, 2, bpp=3, device="cpu",
                               use_row_filters=use_row_filters)
    qj, fj = optimize_batch_pallas(rows, strengths, 2, bpp=3,
                                   use_row_filters=use_row_filters,
                                   interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(f.numpy(), np.asarray(fj))
