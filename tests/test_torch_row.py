"""Port's row attempt vs the JAX package's per-row quantizer, and one-row
images through the port's optimizer vs the Pallas path (interpret mode)
and the scalar model. Everything is integer: exact equality.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pngloss_tpu.core import reference as ref
from pngloss_tpu.ops.optimize import _quantize_row
from pngloss_tpu.ops.optimize_pallas import optimize_batch_pallas
from pngloss_tpu_torch.ops import optimize_batch_auto
from pngloss_tpu_torch.ops.row import row_attempt, row_attempt_ref

BAND_PAD = 256   # covers every strength up to 255


@functools.partial(jax.jit, static_argnames=("bpp",))
def _jax_rows(s, bleed, orig, qprev, e0, e1, hist, ofreq, col_mask, *, bpp):
    """vmap of _quantize_row over the 5 filters and the batch."""
    def one_image(s_i, orig_i, qprev_i, e0_i, e1_i, hist_i, ofreq_i, cm_i):
        hist_ext = jnp.concatenate([hist_i, hist_i[:BAND_PAD]])
        ofreq_ext = jnp.concatenate([ofreq_i, ofreq_i[:, :BAND_PAD]], axis=1)
        return jax.vmap(
            lambda f, ofr: _quantize_row(
                f, s_i, bleed, orig_i, qprev_i, e0_i, e1_i, hist_ext, ofr,
                bpp=bpp, band_pad=BAND_PAD, col_mask=cm_i)
        )(jnp.arange(5, dtype=jnp.int32), ofreq_ext)
    return jax.vmap(one_image)(s, orig, qprev, e0, e1, hist, ofreq, col_mask)


def _inputs(rng, bpp, b=4, w=7):
    """Mid-image row state with many frequency ties."""
    orig = rng.integers(0, 256, (b, w, bpp), dtype=np.int32)
    if bpp % 2 == 0:
        orig[:, ::2, bpp - 1] = 0                       # transparent pixels
    orig[0, :3] = 255                                   # saturated band
    return dict(
        orig=orig,
        qprev=rng.integers(0, 256, (b, w, bpp), dtype=np.int32),
        e0=rng.integers(-40, 41, (b, w + 5, 4), dtype=np.int32),
        e1=rng.integers(-40, 41, (b, w + 5, 4), dtype=np.int32),
        hist=rng.integers(0, 3, (b, 256), dtype=np.int32),
        ofreq=rng.integers(0, 3, (b, 5, 256), dtype=np.int32),
    )


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_row_attempt_matches_jax(bpp):
    rng = np.random.default_rng(200 + bpp)
    x = _inputs(rng, bpp)
    s = np.asarray([0, 3, 19, 255], np.int32)           # per-image strengths
    w_real = np.asarray([7, 5, 7, 2], np.int32)         # ragged columns
    col_mask = (np.arange(7)[None, :] < w_real[:, None]).astype(np.int32)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    for bleed in (1, 2, 32767):
        want = _jax_rows(jnp.asarray(s), jnp.int32(bleed), x["orig"],
                         x["qprev"], x["e0"], x["e1"], x["hist"], x["ofreq"],
                         jnp.asarray(col_mask), bpp=bpp)
        got = row_attempt(torch.from_numpy(s), bleed, t["orig"], t["qprev"],
                          t["e0"], t["e1"], t["hist"], t["ofreq"],
                          torch.from_numpy(w_real))
        qrow, hist5, e0n, e1n = (g.numpy() for g in got)
        np.testing.assert_array_equal(qrow, np.asarray(want[0]))
        np.testing.assert_array_equal(hist5, np.asarray(want[1])[..., :256])
        np.testing.assert_array_equal(e0n, np.asarray(want[2]))
        np.testing.assert_array_equal(e1n, np.asarray(want[3]))


def test_cpu_tensor_takes_plain_version(monkeypatch):
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing."""
    from pngloss_tpu_torch.ops import row

    calls = []
    monkeypatch.setattr(row, "row_attempt_ref",
                        lambda *a: calls.append(1) or row_attempt_ref(*a))
    x = {k: torch.from_numpy(v)
         for k, v in _inputs(np.random.default_rng(3), 3, b=1).items()}
    before = row.LAUNCHES
    row.row_attempt(torch.tensor([19], dtype=torch.int32), 2, x["orig"],
                    x["qprev"], x["e0"], x["e1"], x["hist"], x["ofreq"],
                    torch.tensor([7], dtype=torch.int32))
    assert calls == [1] and row.LAUNCHES == before


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_one_row_images(bpp):
    """H=1 images run the row stage alone (strength fallback included)."""
    rng = np.random.default_rng(210 + bpp)
    rows = rng.integers(0, 256, (3, 1, 9 * bpp), dtype=np.uint8)
    strengths = np.asarray([0, 19, 40], np.int32)
    q, f = optimize_batch_auto(rows, strengths, 2, bpp=bpp, device="cpu")
    qj, fj = optimize_batch_pallas(rows, strengths, 2, bpp=bpp,
                                   interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(f.numpy(), np.asarray(fj))
    for i, s in enumerate(strengths):
        qr, fr = ref.optimize_image(rows[i], bpp, int(s), 2, True)
        np.testing.assert_array_equal(q[i].numpy(), qr)
        np.testing.assert_array_equal(f[i].numpy(), fr)


def _band_candidates(o, here, pred, s):
    """How many symbols the scalar model's band loop scans for one channel
    (core/reference.py ``_run_pixel``: wrap, band, clamp, fallback)."""
    osym = o - pred
    if osym < -128:
        pred -= 256
    elif osym > 127:
        pred += 256
    filtered = here - pred
    band = s + 1
    if filtered < 0:
        mx = -(-filtered - (-filtered % band))
        mn = mx - s
    else:
        mn = filtered - filtered % band
        mx = mn + s
    if mn + pred < 0:
        mn = -pred
    if mx + pred > 255:
        mx = 255 - pred
    if mx < mn:
        if filtered + pred > 255:
            mn = mx = 255 - pred
        if filtered + pred < 0:
            mn = mx = -pred
    return mx - mn + 1


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_candidate_count_matches_scalar_band(bpp):
    """The plain version's count of scanned band candidates against the
    scalar model's band. With bleed 32767 and no carried error nothing is
    dithered (|here - back| < 256 divides to 0), so each channel's band
    follows from its original and its predictor over the plain version's
    own output; padded columns and transparent alpha scan nothing."""
    rng = np.random.default_rng(220 + bpp)
    x = _inputs(rng, bpp)
    x["e0"][:] = 0
    x["e1"][:] = 0
    s = np.asarray([0, 3, 19, 255], np.int32)
    w_real = np.asarray([7, 5, 7, 2], np.int32)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    count = torch.zeros((), dtype=torch.int64)
    qrow = row_attempt_ref(torch.from_numpy(s), 32767, t["orig"], t["qprev"],
                           t["e0"], t["e1"], t["hist"], t["ofreq"],
                           torch.from_numpy(w_real), count=count)[0].numpy()
    want = 0
    for b in range(len(s)):
        for f in range(5):
            for px in range(w_real[b]):
                for c in range(bpp):
                    o = int(x["orig"][b, px, c])
                    if bpp % 2 == 0 and c == bpp - 1 and o == 0:
                        continue
                    above = int(x["qprev"][b, px, c])
                    diag = int(x["qprev"][b, px - 1, c]) if px else 0
                    left = int(qrow[b, f, px - 1, c]) if px else 0
                    pred = ref.filter_predict(above, diag, left, f)
                    want += _band_candidates(o, o, pred, int(s[b]))
    assert int(count) == want
