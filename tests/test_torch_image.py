"""Port's optimizer (rows 1..H-1 through the image stage) vs the JAX
package's Pallas path (interpret mode) and the scalar model, and the image
stage alone, seeded from the JAX row-0 carry. Exact equality throughout.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pngloss_tpu.core import reference as ref
from pngloss_tpu.ops.optimize_pallas import (
    optimize_batch_pallas,
    optimize_batch_pallas_t,
)
from pngloss_tpu_torch.convert import carry_from_jax
from pngloss_tpu_torch.ops import hist, image, optimize_batch_auto


def _ragged_batch(rng, bpp, sizes, hp, wp):
    rows = np.zeros((len(sizes), hp, wp * bpp), np.uint8)
    for k, (h, w) in enumerate(sizes):
        im = rng.integers(0, 256, (h, w * bpp), dtype=np.uint8)
        if bpp % 2 == 0:
            im.reshape(h, w, bpp)[1::2, ::2, bpp - 1] = 0   # transparency
        rows[k, :h, :w * bpp] = im
    return rows


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_optimizer_matches_pallas_and_reference(bpp):
    rng = np.random.default_rng(300 + bpp)
    sizes = [(6, 7), (4, 3), (6, 5)]
    strengths = np.asarray([19, 0, 40], np.int32)
    rows = _ragged_batch(rng, bpp, sizes, 6, 7)
    w_real = np.asarray([w for _, w in sizes], np.int32)
    h_real = np.asarray([h for h, _ in sizes], np.int32)
    q, f = optimize_batch_auto(rows, strengths, 2, bpp=bpp, device="cpu",
                               w_real=w_real, h_real=h_real)
    q, f = q.numpy(), f.numpy()
    qj, fj = optimize_batch_pallas(rows, strengths, 2, bpp=bpp,
                                   interpret=True, w_real=w_real,
                                   h_real=h_real)
    for i, (h, w) in enumerate(sizes):
        np.testing.assert_array_equal(q[i, :h, :w * bpp],
                                      np.asarray(qj)[i, :h, :w * bpp])
        np.testing.assert_array_equal(f[i, :h], np.asarray(fj)[i, :h])
        qr, fr = ref.optimize_image(rows[i, :h, :w * bpp], bpp,
                                    int(strengths[i]), 2, True)
        np.testing.assert_array_equal(q[i, :h, :w * bpp], qr)
        np.testing.assert_array_equal(f[i, :h], fr)


@pytest.mark.parametrize("bleed", [1, 32767])
def test_optimizer_bleed_extremes(bleed):
    rng = np.random.default_rng(320 + bleed % 7)
    rows = rng.integers(0, 256, (2, 5, 6 * 3), dtype=np.uint8)
    q, f = optimize_batch_auto(rows, 255, bleed, bpp=3, device="cpu")
    for i in range(2):
        qr, fr = ref.optimize_image(rows[i], 3, 255, bleed, True)
        np.testing.assert_array_equal(q[i].numpy(), qr)
        np.testing.assert_array_equal(f[i].numpy(), fr)


def test_chunked_batch_equals_whole(monkeypatch):
    """Batches larger than a chunk run chunk by chunk, same result."""
    from pngloss_tpu_torch.ops import optimize_gpu

    rng = np.random.default_rng(330)
    rows = rng.integers(0, 256, (5, 4, 5 * 3), dtype=np.uint8)
    strengths = [19, 0, 3, 40, 19]
    whole = optimize_batch_auto(rows, strengths, 2, bpp=3, device="cpu")
    monkeypatch.setattr(optimize_gpu, "max_batch", lambda *a: 2)
    chunked = optimize_batch_auto(rows, strengths, 2, bpp=3, device="cpu")
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@functools.partial(jax.jit, static_argnames=("bpp",))
def _jax_row0_carry(rows_t, strength, bleed, *, bpp):
    return optimize_batch_pallas_t(
        rows_t[:1], strength, bleed, bpp=bpp, band_pad=0,
        interpret=True, return_carry=True, ofreq_rows=rows_t)


def test_image_stage_seeded_from_jax_carry():
    """The port's image stage alone, from the JAX row-0 winner state
    (gray+alpha: the alpha channel's dither lane 3 crosses the carry)."""
    rng = np.random.default_rng(342)
    b, h, w, bpp = 2, 6, 7, 2
    rows = _ragged_batch(rng, bpp, [(h, w)] * b, h, w)
    strengths = np.asarray([19, 3], np.int32)
    rows_t = jnp.transpose(jnp.asarray(rows, jnp.int32), (1, 2, 0))
    _, _, carry = _jax_row0_carry(rows_t, jnp.asarray(strengths),
                                  jnp.int32(2), bpp=bpp)
    c = carry_from_jax(carry, w=w, bpp=bpp, b=b)
    rows_pt = torch.from_numpy(rows)
    np.testing.assert_array_equal(
        c.oprev.numpy(), rows[:, 0].reshape(b, w, bpp))
    s = torch.from_numpy(strengths)
    w_real = torch.full((b,), w, dtype=torch.int32)
    ofreq = hist.original_frequencies(rows_pt, bpp)
    qrows, filt = image.image_rows(s, 2, w_real, ofreq, rows_pt, c.qprev,
                                   c.e0, c.e1, c.hist)
    qj, fj = optimize_batch_pallas(rows, strengths, 2, bpp=bpp,
                                   interpret=True)
    np.testing.assert_array_equal(
        qrows.numpy().reshape(b, h - 1, w * bpp), np.asarray(qj)[:, 1:])
    np.testing.assert_array_equal(filt.numpy(), np.asarray(fj)[:, 1:])


@pytest.mark.parametrize("bpp", [2, 3])
def test_plain_image_counts_candidates_of_every_row(bpp):
    """image_rows_ref's band-candidate count is the sum of quantize_row's
    counts along the winners' states, row by row. Bleed 32767 and zero
    dither keep every dither row zero, so each row's state is its
    predecessor's output row and the winner's histogram."""
    from pngloss_tpu_torch.ops.optimize import pick, quantize_row

    rng = np.random.default_rng(350 + bpp)
    b, h, w = 3, 4, 6
    rows = torch.from_numpy(_ragged_batch(rng, bpp, [(h, w)] * b, h, w))
    s = torch.tensor([0, 19, 255], dtype=torch.int32)
    w_real = torch.tensor([6, 4, 6], dtype=torch.int32)
    ofreq = hist.original_frequencies(rows, bpp)
    orig = rows.view(b, h, w, bpp).to(torch.int32)
    qprev = torch.from_numpy(rng.integers(0, 256, (b, w, bpp), dtype=np.int32))
    ze = torch.zeros((b, w + 5, 4), dtype=torch.int32)
    hist0 = torch.from_numpy(rng.integers(0, 3, (b, 256), dtype=np.int32))
    count = torch.zeros((), dtype=torch.int64)
    qrows, filt = image.image_rows_ref(s, 32767, w_real, ofreq, rows, qprev,
                                       ze, ze, hist0, count=count)
    want = torch.zeros((), dtype=torch.int64)
    hs = hist0
    for y in range(1, h):
        _, h5, e0n, e1n = quantize_row(s, 32767, orig[:, y], qprev, ze, ze, hs,
                                       ofreq, w_real, count=want)
        assert not e0n.any() and not e1n.any()
        hs = pick(h5, filt[:, y - 1])
        qprev = qrows[:, y - 1]
    assert int(count) == int(want) > 0
