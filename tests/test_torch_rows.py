"""The port's per-row path of embedding mode as the image stage's retry
variant (every row starts at the image's full strength and retries one
lower while no filter passes libpng's MSAD self-check) against the JAX
package's per-row path (Pallas in interpret mode) and the scalar model.
Integers throughout: exact equality, tolerance 0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pngloss_tpu.ops.optimize_pallas import optimize_batch_pallas_t
from pngloss_tpu_torch import reference as ref
from pngloss_tpu_torch.ops import hist, image, optimize, optimize_gpu
from pngloss_tpu_torch.ops.edges import EDGES, edge_inputs, rows_by_step

H, W = 5, 6
STRENGTHS = [0, 3, 32, 255]
W_REAL = [6, 4, 6, 1]


def _planes(seed, bpp, b=4, h=H, w=W):
    rows = np.random.default_rng(seed).integers(
        0, 256, size=(b, h, w * bpp), dtype=np.uint8)
    if bpp % 2 == 0:                                     # transparency
        rows.reshape(b, h, w, bpp)[:, 1::2, ::2, bpp - 1] = 0
    return rows


def _i32(a):
    return torch.as_tensor(np.asarray(a, np.int32))


@functools.partial(jax.jit, static_argnames=("bpp",))
def _jax_rows(rows_t, strength, bleed, w_real, *, bpp):
    """The JAX package's per-row path: one device program, a scan over
    rows with a while_loop over the strength."""
    return optimize_batch_pallas_t(
        rows_t, strength, bleed, bpp=bpp, band_pad=0, use_row_filters=False,
        interpret=True, w_real=w_real,
        h_real=jnp.full((rows_t.shape[2],), rows_t.shape[0], jnp.int32))


def _port_inputs(rows, bpp, strengths, w_real):
    b, h, wb = rows.shape
    rows_pt = torch.from_numpy(rows)
    wr = _i32(w_real)
    ofreq = hist.original_frequencies(rows_pt, bpp, wr,
                                      torch.full((b,), h, dtype=torch.int32))
    orig = rows_pt.view(b, h, wb // bpp, bpp).to(torch.int32)
    return _i32(strengths), rows_pt, orig, ofreq, wr


def _port_rows(rows, bpp, strengths, bleed, w_real):
    """``optimize_rows`` over whole images: row 0 by ``row_step``, the
    rest in one call of the retry variant (its plain version here)."""
    s, _, orig, ofreq, wr = _port_inputs(rows, bpp, strengths, w_real)
    q, f = optimize_gpu.optimize_rows(s, bleed, orig, ofreq, wr)
    return q.numpy().reshape(rows.shape), f.numpy()


def _port_attempts(rows, bpp, strengths, bleed, w_real):
    """The row attempts each image takes on that path: row 0's, and those
    the retry variant reports for the rows after it."""
    s, rows_pt, orig, ofreq, wr = _port_inputs(rows, bpp, strengths, w_real)
    b, _, w, _ = orig.shape
    c0, _, first = optimize_gpu.row_step(
        s, bleed, orig[:, 0].contiguous(),
        optimize_gpu.zero_carry(b, w, bpp, "cpu"), ofreq, wr)
    return first + image.image_rows(s, bleed, wr, ofreq, rows_pt, c0.qprev,
                                    c0.e0, c0.e1, c0.hist, adaptive=True,
                                    retry=True)[2]


@pytest.mark.parametrize("bleed", [1, 2])
@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_retry_variant_matches_pallas_and_reference(bpp, bleed):
    """Strengths 0, 3, 32 (a retry at 31 changes the kernel's loop) and
    255, ragged widths."""
    rows = _planes(900 + bpp, bpp)
    q, f = _port_rows(rows, bpp, STRENGTHS, bleed, W_REAL)
    qj, fj = _jax_rows(
        jnp.transpose(jnp.asarray(rows, jnp.int32), (1, 2, 0)),
        jnp.asarray(STRENGTHS, jnp.int32), jnp.int32(bleed),
        jnp.asarray(W_REAL, jnp.int32), bpp=bpp)
    qj = np.transpose(np.asarray(qj), (2, 0, 1))
    fj = np.asarray(fj).T
    for i, (s, w) in enumerate(zip(STRENGTHS, W_REAL)):
        real = (i, slice(None), slice(0, w * bpp))
        np.testing.assert_array_equal(q[real], qj[real])
        np.testing.assert_array_equal(f[i], fj[i])
        qr, fr = ref.optimize_image(rows[real], bpp, s, bleed, False)
        np.testing.assert_array_equal(q[real], qr)
        np.testing.assert_array_equal(f[i], fr)


@pytest.mark.parametrize("name", sorted(n for n in EDGES if "retry" in n))
def test_retry_edge_cases_retry_and_match_the_row_by_row_loop(name):
    """The cases the kernel is held to on the card do retry, and the
    retry variant's plain version equals the strength loop row by row
    (``strength_loop`` around one attempt, the carry passed by hand)."""
    s, bleed, w_real, ofreq, rows, qprev, e0, e1, hist0 = edge_inputs(
        name, "cpu")[1]
    b, h, wb = rows.shape
    w, bpp = qprev.shape[1:]
    q, f, tries = image.image_rows(s, bleed, w_real, ofreq, rows, qprev, e0,
                                   e1, hist0, adaptive=True, retry=True)
    assert int(tries.max()) > h - 1, "no row of this case retries"
    orig = rows.view(b, h, w, bpp).to(torch.int32)
    state, want_tries = (qprev, hist0, e0, e1), torch.zeros_like(tries)
    for y in range(1, h):
        qp, hp, e0p, e1p = state

        def attempt(s_try):
            return optimize.quantize_row(s_try, bleed, orig[:, y], qp, e0p,
                                         e1p, hp, ofreq, w_real)

        state, best, n = optimize.strength_loop(
            attempt, s, orig[:, y], qp, orig[:, y - 1], e0p, e1p, hp, w_real)
        want_tries += n
        np.testing.assert_array_equal(q[:, y - 1].numpy(), state[0].numpy())
        np.testing.assert_array_equal(f[:, y - 1].numpy(), best.numpy())
    np.testing.assert_array_equal(tries.numpy(), want_tries.numpy())


def test_every_row_can_fail():
    """Image 0 of the every-row case takes more than one attempt on each
    of its rows."""
    args = list(edge_inputs("retry-every-row-w64-s150-bpp2-e40", "cpu")[1])
    rows = args[4]
    seen = torch.zeros(2, dtype=torch.int32)
    for k in range(2, rows.shape[1] + 1):
        args[4] = rows[:, :k].contiguous()
        tries = image.image_rows(*args, adaptive=True, retry=True)[2]
        assert int((tries - seen)[0]) > 1, f"row {k - 1} passed at once"
        seen = tries


@pytest.mark.parametrize("bpp", [1, 3, 4])
def test_batch_equals_each_image_alone(bpp):
    """Each image retries alone: its rows, filters and attempts do not
    depend on what the rest of the batch needs."""
    rows = _planes(910 + bpp, bpp, b=5, w=9)
    strengths, w_real = [45, 19, 60, 3, 200], [9, 9, 5, 9, 2]
    q, f = _port_rows(rows, bpp, strengths, 2, w_real)
    tries = _port_attempts(rows, bpp, strengths, 2, w_real)
    assert int(tries.max()) > int(tries.min()), "the images retry alike"
    for i in range(5):
        one = (rows[i:i + 1], bpp, strengths[i:i + 1], 2, w_real[i:i + 1])
        qi, fi = _port_rows(*one)
        np.testing.assert_array_equal(q[i:i + 1], qi)
        np.testing.assert_array_equal(f[i:i + 1], fi)
        assert int(_port_attempts(*one)) == int(tries[i])


def test_strength_starts_again_at_full_on_every_row():
    """A row after one that retried starts at the image's full strength:
    the rows after row k, run from the state after row k, equal the whole
    run's, and so does the row kernel's loop row by row."""
    bpp = 3
    rows = _planes(700, bpp, h=6, w=7)
    b, h, wb = rows.shape
    s, wr = _i32([45] * b), _i32([7] * b)
    rows_pt = torch.from_numpy(rows)
    ofreq = hist.original_frequencies(rows_pt, bpp)
    orig = rows_pt.view(b, h, 7, bpp).to(torch.int32)
    per_row = []
    carry = optimize_gpu.zero_carry(b, 7, bpp, "cpu")
    carries = []
    for y in range(h):
        carry, _, n = optimize_gpu.row_step(s, 2, orig[:, y].contiguous(),
                                            carry, ofreq, wr)
        carries.append(carry)
        per_row.append(n)
    per_row = torch.stack(per_row, 1)                    # (B, H)
    # some row retried and the row after it passed at the first attempt
    after = (per_row[:, :-1] > 1) & (per_row[:, 1:] == 1)
    assert bool(after.any())
    k = int(after.any(0).nonzero()[0]) + 1
    q, f = optimize_gpu.optimize_rows(s, 2, orig, ofreq, wr)
    tries = _port_attempts(rows, bpp, [45] * b, 2, [7] * b)
    np.testing.assert_array_equal(tries.numpy(), per_row.sum(1).numpy())
    qk, fk = optimize_gpu.optimize_rows(s, 2, orig[:, k:], ofreq, wr,
                                        carry=carries[k - 1])
    np.testing.assert_array_equal(qk.numpy(), q[:, k:].numpy())
    np.testing.assert_array_equal(fk.numpy(), f[:, k:].numpy())
    qs, fs, ns = rows_by_step(s, 2, orig, ofreq, wr)
    np.testing.assert_array_equal(qs.numpy(), q.numpy())
    np.testing.assert_array_equal(fs.numpy(), f.numpy())
    np.testing.assert_array_equal(ns.numpy(), tries.numpy())


def _fake_hist():
    hist0 = torch.ones((2, 256), dtype=torch.int32)
    hist0[:, 200] = 1000
    return hist0


def _fake_attempt(cheapest):
    """An attempt whose 5 candidates are one row that adds 4 symbols to a
    rare bin, but for filter ``cheapest``, which adds them to a frequent
    bin and so costs fewer bits."""
    def attempt(s_try):
        q5 = torch.full((2, 5, 4, 1), 9, dtype=torch.int32)
        h5 = _fake_hist()[:, None].repeat(1, 5, 1)
        h5[:, :, 9] += 4
        if cheapest is not None:
            h5[:, cheapest, 9] -= 4
            h5[:, cheapest, 200] += 4
        e = torch.zeros((2, 5, 9, 4), dtype=torch.int32)
        return q5, h5, e, e.clone()
    return attempt


@pytest.mark.parametrize("cheapest, want", [(None, 0), (3, 3), (4, 4)])
def test_strength_0_without_a_passing_filter_takes_the_minimum_cost(
        monkeypatch, cheapest, want):
    """Where the C tool would abort: at strength 0 with no passing filter
    the minimum true cost wins, ties to the lowest filter; an image at
    strength 2 gets there in three attempts."""
    monkeypatch.setattr(optimize, "msad_valid", lambda q5, qprev, w_real:
                        torch.zeros(q5.shape[:2], dtype=torch.bool))
    z = torch.zeros((2, 4, 1), dtype=torch.int32)
    e = torch.zeros((2, 9, 4), dtype=torch.int32)
    state, best, tries = optimize.strength_loop(
        _fake_attempt(cheapest), _i32([0, 2]), z, z, z, e, e, _fake_hist(),
        _i32([4, 4]))
    assert best.tolist() == [want, want]
    assert tries.tolist() == [1, 3]
    assert int(state[1][0, 200]) == (1004 if cheapest is not None else 1000)
