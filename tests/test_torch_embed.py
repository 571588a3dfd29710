"""The port's embedding mode (use_row_filters=False, every row passes
libpng's MSAD self-check) against the JAX package (Pallas in interpret
mode) and the scalar model: the image stage's adaptive variant, the
per-row fallback path, the optimizer, and the embedding API. Exact
equality throughout.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pngloss_tpu import pipeline as jax_pipeline
from pngloss_tpu.core import reference as ref
from pngloss_tpu.ops import optimize_pallas
from pngloss_tpu.ops.optimize_pallas import (
    optimize_batch_pallas,
    optimize_batch_pallas_t,
)
from pngloss_tpu_torch import pipeline
from pngloss_tpu_torch.convert import carry_from_jax
from pngloss_tpu_torch.ops import hist, image, optimize_batch_auto
from pngloss_tpu_torch.ops import optimize_gpu

STRENGTH = 45
# (bpp, seed): a (4, 6, 7*bpp) noise batch at s=45 whose speculation
# both passes and fails
MIXED = {1: 701, 2: 700, 3: 700, 4: 700}


def _noise(seed, bpp, b=4, h=6, w=7):
    rows = np.random.default_rng(seed).integers(
        0, 256, size=(b, h, w * bpp), dtype=np.uint8)
    if bpp % 2 == 0:                                     # transparency
        rows.reshape(b, h, w, bpp)[:, 1::2, ::2, bpp - 1] = 0
    return rows


@functools.partial(jax.jit, static_argnames=("bpp",))
def _jax_carry(rows_t, ofreq_rows_t, strength, bleed, *, bpp):
    """The JAX per-row path's state after the rows of ``rows_t``."""
    return optimize_batch_pallas_t(
        rows_t, strength, bleed, bpp=bpp, band_pad=0, use_row_filters=False,
        interpret=True, return_carry=True, ofreq_rows=ofreq_rows_t)


def _rows_t(rows):
    return jnp.transpose(jnp.asarray(rows, jnp.int32), (1, 2, 0))


def _jax_speculation(monkeypatch, rows, strength, bpp):
    """Run ``optimize_batch_pallas(use_row_filters=False)`` and return what
    its speculation (the image kernel with adaptive=True) gave: (q, f, ok)
    before the per-row re-run."""
    seen = []
    real = optimize_pallas._optimize_batch_pallas_image_jit

    def spy(*a, **k):
        out = real(*a, **k)
        if k.get("adaptive"):
            seen.append(tuple(np.asarray(o) for o in out))
        return out

    monkeypatch.setattr(optimize_pallas, "_optimize_batch_pallas_image_jit",
                        spy)
    optimize_batch_pallas(rows, strength, 2, bpp=bpp, use_row_filters=False,
                          interpret=True)
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_adaptive_image_stage_seeded_from_jax_carry(monkeypatch, bpp):
    """The port's image stage with adaptive=True alone, from the JAX
    row-0 winner state, against the JAX speculation: rows, filters and ok,
    failed images included."""
    rows = _noise(MIXED[bpp], bpp)
    b, h, wb = rows.shape
    w = wb // bpp
    qj, fj, okj = _jax_speculation(monkeypatch, rows, STRENGTH, bpp)
    assert okj.any() and not okj.all()
    rows_t = _rows_t(rows)
    _, _, carry = _jax_carry(rows_t[:1], rows_t, jnp.int32(STRENGTH),
                             jnp.int32(2), bpp=bpp)
    c = carry_from_jax(carry, w=w, bpp=bpp, b=b)
    rows_pt = torch.from_numpy(rows)
    s = torch.full((b,), STRENGTH, dtype=torch.int32)
    w_real = torch.full((b,), w, dtype=torch.int32)
    qrows, filt, ok = image.image_rows(
        s, 2, w_real, hist.original_frequencies(rows_pt, bpp), rows_pt,
        c.qprev, c.e0, c.e1, c.hist, adaptive=True)
    np.testing.assert_array_equal(qrows.numpy().reshape(b, h - 1, wb),
                                  qj[:, 1:])
    np.testing.assert_array_equal(filt.numpy(), fj[:, 1:])
    np.testing.assert_array_equal(ok.numpy(), okj.astype(np.int32))


@pytest.mark.parametrize("k", [1, 3])
def test_per_row_path_from_jax_carry(k):
    """The port's per-row path (every row adaptive, strength loop per row)
    from the JAX per-row path's state after k rows."""
    bpp = 3
    rows = _noise(700, bpp)
    b, h, wb = rows.shape
    w = wb // bpp
    rows_t = _rows_t(rows)
    s = jnp.int32(STRENGTH)
    _, _, carry = _jax_carry(rows_t[:k], rows_t, s, jnp.int32(2), bpp=bpp)
    qj, fj, _ = _jax_carry(rows_t, rows_t, s, jnp.int32(2), bpp=bpp)
    c = carry_from_jax(carry, w=w, bpp=bpp, b=b)
    rows_pt = torch.from_numpy(rows)
    orig = rows_pt.view(b, h, w, bpp).to(torch.int32)
    np.testing.assert_array_equal(c.oprev.numpy(), orig[:, k - 1].numpy())
    q, f = optimize_gpu.optimize_rows(
        torch.full((b,), STRENGTH, dtype=torch.int32), 2, orig[:, k:],
        hist.original_frequencies(rows_pt, bpp),
        torch.full((b,), w, dtype=torch.int32), carry=c)
    np.testing.assert_array_equal(
        q.numpy().reshape(b, h - k, wb),
        np.transpose(np.asarray(qj), (2, 0, 1))[:, k:])
    np.testing.assert_array_equal(f.numpy(), np.asarray(fj).T[:, k:])


def _ragged(bpp):
    rng = np.random.default_rng(760 + bpp)
    sizes = [(6, 7), (4, 3), (6, 5), (1, 6)]
    rows = np.zeros((len(sizes), 6, 7 * bpp), np.uint8)
    for i, (h, w) in enumerate(sizes):
        im = rng.integers(0, 256, (h, w * bpp), dtype=np.uint8)
        if bpp % 2 == 0:
            im.reshape(h, w, bpp)[1::2, ::2, bpp - 1] = 0
        rows[i, :h, :w * bpp] = im
    return rows, sizes, [STRENGTH, 19, 3, 45]


CASES = {
    "seed700_mixed": lambda: (_noise(700, 3), None, STRENGTH, 3),
    "seed711_all_ok": lambda: (_noise(711, 3), None, STRENGTH, 3),
    **{f"ragged_bpp{bpp}": functools.partial(
        lambda bpp: (*_ragged(bpp), bpp), bpp) for bpp in (1, 2, 3, 4)},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_embedding_matches_pallas_and_reference(case):
    rows, sizes, strength, bpp = CASES[case]()
    b, h, wb = rows.shape
    if sizes is None:
        sizes = [(h, wb // bpp)] * b
    kw = {}
    if case.startswith("ragged"):
        kw = dict(w_real=np.asarray([w for _, w in sizes], np.int32),
                  h_real=np.asarray([hh for hh, _ in sizes], np.int32))
    s = np.full(b, strength, np.int32)
    q, f = optimize_batch_auto(rows, s, 2, bpp=bpp, device="cpu",
                               use_row_filters=False, **kw)
    q, f = q.numpy(), f.numpy()
    qj, fj = optimize_batch_pallas(rows, s, 2, bpp=bpp,
                                   use_row_filters=False, interpret=True,
                                   **kw)
    qj, fj = np.asarray(qj), np.asarray(fj)
    for i, (hh, w) in enumerate(sizes):
        real = (i, slice(0, hh), slice(0, w * bpp))
        np.testing.assert_array_equal(q[real], qj[real])
        np.testing.assert_array_equal(f[i, :hh], fj[i, :hh])
        qr, fr = ref.optimize_image(rows[real], bpp, int(s[i]), 2, False)
        np.testing.assert_array_equal(q[real], qr)
        np.testing.assert_array_equal(f[i, :hh], fr)


def test_fallback_runs_on_failed_images_only(monkeypatch):
    """Embedding mode runs rows 1..H-1 in one call of the image stage's
    retry variant over the whole batch, and only the rows that fail the
    self-check at full strength fall back to lower strengths: an image
    the speculation passes (seed 700's image 1, all of seed 711) takes one
    attempt a row."""
    calls = []
    real = image.image_rows

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append((k, out))
        return out

    monkeypatch.setattr(image, "image_rows", spy)
    rows = _noise(700, 3)                      # speculation ok: [0, 1, 0, 0]
    optimize_batch_auto(rows, STRENGTH, 2, bpp=3, device="cpu",
                        use_row_filters=False)
    assert len(calls) == 1
    (kw, (_, _, tries)), = calls
    assert kw["adaptive"] and kw["retry"]
    h = rows.shape[1]
    assert int(tries[1]) == h - 1
    assert all(int(tries[i]) > h - 1 for i in (0, 2, 3))
    calls.clear()
    optimize_batch_auto(_noise(711, 3), STRENGTH, 2, bpp=3, device="cpu",
                        use_row_filters=False)
    (_, (_, _, tries)), = calls
    assert tries.tolist() == [h - 1] * 4, "an all-ok batch must not retry"


def test_embedding_chunked_equals_whole(monkeypatch):
    rows = _noise(700, 3, b=5)
    strengths = [45, 19, 45, 3, 45]
    kw = dict(bpp=3, device="cpu", use_row_filters=False)
    whole = optimize_batch_auto(rows, strengths, 2, **kw)
    monkeypatch.setattr(optimize_gpu, "max_batch", lambda *a: 2)
    chunked = optimize_batch_auto(rows, strengths, 2, **kw)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _rgb_images():
    """RGB images from the seed-700 batch (speculation mixes ok and
    failed) and a gray+alpha one."""
    rows = _noise(700, 3)
    rgba = np.full((4, 6, 7, 4), 255, np.uint8)
    rgba[..., :3] = rows.reshape(4, 6, 7, 3)
    ga = np.random.default_rng(770).integers(0, 256, (5, 6, 4),
                                             dtype=np.uint8)
    ga[..., 0] = ga[..., 2] = ga[..., 1]
    return list(rgba) + [ga]


def test_optimize_for_average_filter_matches_jax_pipeline():
    for rgba in _rgb_images():
        got = pipeline.optimize_for_average_filter(rgba, STRENGTH,
                                                   device="cpu")
        want = jax_pipeline.optimize_for_average_filter(rgba, STRENGTH)
        np.testing.assert_array_equal(got, want)
        q_ref, _ = ref.optimize_rgba(rgba, STRENGTH, 2, False)
        np.testing.assert_array_equal(got, q_ref)


def test_optimize_with_stride_in_place_matches_jax_pipeline():
    rgba = _rgb_images()[0]
    h, w = rgba.shape[:2]
    stride = w * 4 + 5
    buf = np.random.default_rng(771).integers(0, 256, h * stride,
                                              dtype=np.uint8)
    for y in range(h):
        buf[y * stride: y * stride + w * 4] = rgba[y].reshape(-1)
    mine, theirs = buf.copy(), buf.copy()
    f = pipeline.optimize_with_stride(mine, w, h, stride, STRENGTH,
                                      use_row_filters=False, device="cpu")
    fj = jax_pipeline.optimize_with_stride(theirs, w, h, stride, STRENGTH,
                                           use_row_filters=False)
    np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_array_equal(f, fj)
    assert not np.array_equal(mine, buf), "buffer not modified in place"
    pad = np.concatenate([buf[y * stride + w * 4:(y + 1) * stride]
                          for y in range(h - 1)])
    np.testing.assert_array_equal(
        pad, np.concatenate([mine[y * stride + w * 4:(y + 1) * stride]
                             for y in range(h - 1)]))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_unique_symbol_count_matches_jax(bpp):
    rows = _noise(780 + bpp, bpp)
    rgba = [pipeline.restore_colorspace(r, bpp, 7) for r in rows]
    qs, fs = pipeline.optimize_rgba_batch(rgba, 19, device="cpu",
                                          use_row_filters=bpp % 2 == 0)
    for q, f in zip(qs, fs):
        for b in (bpp, None):
            assert (pipeline.unique_symbol_count(q, f, b)
                    == jax_pipeline.unique_symbol_count(q, f, b))


def test_embedding_cuda_without_cuda_raises(monkeypatch):
    """device='cuda' never falls back to the CPU in embedding mode."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        optimize_batch_auto(_noise(700, 3), STRENGTH, bpp=3, device="cuda",
                            use_row_filters=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.optimize_for_average_filter(_rgb_images()[0], device="cuda")
