"""The port at its users' sizes, on the CPU: a 12 MP camera photo (4000x3000
RGB), a 1920x1080 screenshot and a directory of 132 equal 512x512 files,
the shapes ``chip_smoke.py`` phase 14 runs on the card.

  * the port's plain path (``ops.optimize_batch_auto(device="cpu")``)
    against the JAX package's (its XLA path on the CPU) on strips of the
    users' widths, padded as the pipeline pads them, in CLI mode and in
    embedding mode, with the same seeded numpy inputs: integers
    throughout, exact equality, tolerance 0;
  * ``pad_dim`` and the bucketing of those shapes against
    ``pngloss_tpu.pipeline``;
  * the device memory a padded photo takes and the batch a chunk holds,
    with a stubbed ``torch.cuda.mem_get_info``;
  * ``chip_smoke.py``'s MSAD check of phase 14 against the scalar model.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from pngloss_tpu import pipeline as jax_pipeline
from pngloss_tpu.ops import optimize_batch_auto as jax_optimize
from pngloss_tpu_torch import pipeline
from pngloss_tpu_torch.ops import optimize_batch_auto, optimize_gpu
from pngloss_tpu_torch.reference import adaptive_filter_for_row

PHOTO, SCREEN = (3000, 4000), (1080, 1920)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _strip(rng, h: int, w: int, bpp: int) -> np.ndarray:
    """(h, w*bpp) uint8: a photo-like row strip, smooth gradients under a
    +-12 grain, one hard edge, transparent pixels where bpp is 4."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // (w - 1), (y * 37 + x // 3) % 256,
                     (x + y) * 255 // (h + w - 2), (x * 7) % 256], -1)
    px = np.clip(base[..., :bpp] + rng.integers(-12, 13, (h, w, bpp)), 0,
                 255)
    px[:, w // 3:w // 3 + 40, :3] = 250                  # a hard edge
    if bpp == 4:
        px[::2, ::3, 3] = 0
    return px.astype(np.uint8).reshape(h, w * bpp)


@pytest.mark.parametrize("use_row_filters", [True, False],
                         ids=["cli", "embedding"])
@pytest.mark.parametrize("h, w, bpp", [(2, PHOTO[1], 3), (3, SCREEN[1], 4)],
                         ids=["photo_rgb", "screenshot_rgba"])
def test_strips_at_users_widths_match_jax(h, w, bpp, use_row_filters):
    """Rows of a 4000-px photo (in its 4096-px bucket, w_real 4000) and of
    a 1920-px RGBA screenshot through the port's plain path and the JAX
    package's: the same planes and filters in both modes."""
    work = _strip(np.random.default_rng(w + bpp), h, w, bpp)
    wp = pipeline.pad_dim(w)
    rows = np.zeros((1, h, wp * bpp), np.uint8)
    rows[0, :, :w * bpp] = work
    w_real = np.asarray([w], np.int32)
    h_real = np.asarray([h], np.int32)
    q, f = optimize_batch_auto(rows, 19, bpp=bpp, device="cpu",
                               use_row_filters=use_row_filters,
                               w_real=w_real, h_real=h_real)
    q_jax, f_jax = jax_optimize(rows, 19, bpp=bpp,
                                use_row_filters=use_row_filters,
                                w_real=w_real, h_real=h_real)
    np.testing.assert_array_equal(q.numpy()[0, :, :w * bpp],
                                  np.asarray(q_jax)[0, :, :w * bpp])
    np.testing.assert_array_equal(f.numpy(), np.asarray(f_jax))


def test_pad_dim_matches_jax():
    """The pad ladder of both packages over every side up to 5000 px: the
    photo pads to 4096x3072, the screenshot to 1920x1152."""
    for n in range(1, 5001):
        assert pipeline.pad_dim(n) == jax_pipeline.pad_dim(n), n
    assert [pipeline.pad_dim(n) for n in (*PHOTO, *SCREEN, 512)] == [
        3072, 4096, 1152, 1920, 512]


def _port_buckets(monkeypatch, works, bpps):
    """The port's buckets of ``works``: {key: (idxs, planes, w_real,
    h_real)}, the optimizer stubbed out."""
    seen = {}

    def stub(batch, s, bleed, *, bpp, w_real, h_real, **kw):
        key = (batch.shape[1], batch.shape[2], bpp)
        seen[key] = (batch.copy(), w_real, h_real)
        return ([torch.zeros(batch.shape, dtype=torch.uint8)],
                [torch.zeros(batch.shape[:2], dtype=torch.int8)], None)

    monkeypatch.setattr(pipeline, "optimize_batch_sharded", stub)
    pending = pipeline.dispatch_buckets(works, bpps, 19, device="cpu")
    return {(p.q.shape[1], p.q.shape[2], p.bpp): (p.idxs, *seen[
        (p.q.shape[1], p.q.shape[2], p.bpp)]) for p in pending}


def _jax_buckets(monkeypatch, works, bpps):
    """The JAX package's buckets of ``works``, as ``_port_buckets``; its
    lanes past a chunk's images (batch size classes) left out."""
    seen = []

    def stub(batch, s, bleed, *, bpp, w_real, h_real, **kw):
        seen.append((batch.copy(), w_real, h_real))
        return (np.zeros(batch.shape, np.uint8),
                np.zeros(batch.shape[:2], np.int8))

    monkeypatch.setattr(jax_pipeline, "optimize_batch_auto", stub)
    pending = jax_pipeline.dispatch_buckets(works, bpps, 19)
    out = {}
    for p, (batch, w_real, h_real) in zip(pending, seen):
        n = len(p.idxs)
        key = (batch.shape[1], batch.shape[2], p.bpp)
        if w_real is None:                      # exact shapes: all real
            w_real = np.full(n, batch.shape[2] // p.bpp, np.int32)
            h_real = np.full(n, batch.shape[1], np.int32)
        idxs, planes, wr, hr = out.get(key, ([], [], [], []))
        out[key] = (idxs + list(p.idxs), planes + [batch[:n]],
                    wr + [w_real[:n]], hr + [h_real[:n]])
    return {k: (i, np.concatenate(p), np.concatenate(w), np.concatenate(h))
            for k, (i, p, w, h) in out.items()}


def test_buckets_of_users_shapes_match_jax(monkeypatch):
    """A photo, a screenshot, 132 equal 512x512 RGB planes (a directory of
    one file 132 times: ``compress_many`` decodes it once and hands the
    optimizer the same plane 132 times) and a gray 512x512 image: the same
    buckets, image indices, padded planes and real sizes as
    ``pngloss_tpu.pipeline``."""
    rng = np.random.default_rng(11)
    photo = rng.integers(0, 256, (PHOTO[0], PHOTO[1] * 3), dtype=np.uint8)
    screen = rng.integers(0, 256, (SCREEN[0], SCREEN[1] * 3), dtype=np.uint8)
    tile = rng.integers(0, 256, (512, 512 * 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (512, 512), dtype=np.uint8)
    works = [photo, screen] + [tile] * 132 + [gray]
    bpps = [3, 3] + [3] * 132 + [1]
    port = _port_buckets(monkeypatch, works, bpps)
    want = _jax_buckets(monkeypatch, works, bpps)
    assert sorted(port) == sorted(want) == sorted([
        (3072, 4096 * 3, 3), (1152, 1920 * 3, 3), (512, 512 * 3, 3),
        (512, 512, 1)])
    assert port[(512, 512 * 3, 3)][0] == list(range(2, 134))
    for key, (idxs, planes, w_real, h_real) in port.items():
        j_idxs, j_planes, j_w, j_h = want[key]
        assert idxs == j_idxs, key
        np.testing.assert_array_equal(planes, j_planes)
        np.testing.assert_array_equal(w_real, j_w)
        np.testing.assert_array_equal(h_real, j_h)


def test_photo_memory_and_chunk(monkeypatch):
    """The padded photo (3072 x 4096 x 3) takes bytes_per_image's ~569 MB
    on the card; a chunk holds what a quarter of the free memory fits, at
    least one image, and a card with 80 GB free takes 35 photos a chunk."""
    h, w, bpp = 3072, 4096, 3
    wb = w * bpp
    want = h * wb * 15 + 4 * 5 * 3 * (wb + 2 * 4 * (w + 5)) + 8192
    assert optimize_gpu.bytes_per_image(h, w, bpp) == want
    assert 568e6 < want < 570e6
    for free, fit in ((80 * 10 ** 9, 35), (2 * 10 ** 9, 1), (10 ** 6, 1)):
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda device, free=free: (free, 80 * 10 ** 9))
        assert optimize_gpu.max_batch(h, w, bpp, "cuda") == fit
        assert fit == max(1, free // 4 // want)
    assert optimize_gpu.max_batch(h, w, bpp, "cpu") == 1 << 30


@pytest.mark.parametrize("bpp, h, w", [(1, 600, 37), (3, 300, 50),
                                       (4, 513, 9), (2, 7, 1)])
def test_chip_smoke_msad_check_is_the_scalar_models(bpp, h, w):
    """``chip_smoke.msad_rows`` (phase 6 and 14's check that every row's
    filter is libpng's MSAD choice, whole blocks of rows at once) accepts
    exactly the scalar model's ``adaptive_filter_for_row`` choices, across
    its 256-row blocks, and names the first row that differs."""
    rng = np.random.default_rng(bpp * 1000 + h)
    work = rng.integers(0, 256, (h, w * bpp), dtype=np.uint8)
    work[::5] //= 16                                      # smoother rows
    f = np.array([adaptive_filter_for_row(work[y - 1] if y else None,
                                          work[y], bpp, w)
                  for y in range(h)])
    chip_smoke.msad_rows("t", [work], [f], bpp)
    bad = f.copy()
    bad[h // 2] = (bad[h // 2] + 1) % 5
    with pytest.raises(AssertionError, match=f"row {h // 2}:"):
        chip_smoke.msad_rows("t", [work], [bad], bpp)
