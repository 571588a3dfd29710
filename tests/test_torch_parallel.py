"""Data parallelism in the port (``pngloss_tpu_torch.parallel``): sharded
runs equal unsharded ones in both modes, and ``compress_many(mesh=...)``
equals ``pngloss_tpu.pipeline.compress_many`` over a 4-device JAX mesh."""

import jax
import numpy as np
import pytest
import torch

from pngloss_tpu import pipeline as jax_pipeline
from pngloss_tpu.codec import encode
from pngloss_tpu.parallel import data_mesh as jax_data_mesh
from pngloss_tpu_torch import pipeline
from pngloss_tpu_torch.ops import CudaUnavailableError, optimize_batch_auto
from pngloss_tpu_torch.parallel import (
    data_mesh,
    optimize_batch_sharded,
    resolve_mesh,
    shard_bounds,
)

STRENGTHS = [19, 0, 40, 3, 19]


def _images():
    """5 RGB images of mixed sizes inside one 8x8 bucket."""
    rng = np.random.default_rng(21)
    imgs = []
    for h, w in ((8, 8), (5, 7), (8, 3), (1, 8), (6, 6)):
        rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        rgba[..., 3] = 255
        imgs.append(rgba)
    return imgs


def test_shard_bounds():
    assert shard_bounds(5, 3) == [(0, 2), (2, 4), (4, 5)]
    assert shard_bounds(2, 3) == [(0, 1), (1, 2), (2, 2)]
    assert shard_bounds(4, 1) == [(0, 4)]


@pytest.mark.parametrize("use_row_filters", [True, False])
def test_sharded_equals_unsharded(use_row_filters):
    imgs = _images()
    mesh = data_mesh(("cpu",) * 3)
    assert mesh == (torch.device("cpu"),) * 3
    q1, f1 = pipeline.optimize_rgba_batch(
        imgs, STRENGTHS, use_row_filters=use_row_filters, device="cpu")
    q3, f3 = pipeline.optimize_rgba_batch(
        imgs, STRENGTHS, use_row_filters=use_row_filters, mesh=mesh)
    for i in range(len(imgs)):
        np.testing.assert_array_equal(q3[i], q1[i])
        np.testing.assert_array_equal(f3[i], f1[i])


def test_optimize_batch_sharded_shards():
    """Per-image strengths and real sizes travel with their images; two
    distinct devices ("cpu" and "cpu:0" compare unequal) take the
    one-thread-per-device path."""
    rng = np.random.default_rng(22)
    rows = rng.integers(0, 256, (5, 8, 8 * 3), dtype=np.uint8)
    kw = dict(bpp=3, w_real=[8, 7, 3, 8, 6], h_real=[8, 5, 8, 1, 6])
    want = optimize_batch_auto(rows, STRENGTHS, 2, device="cpu", **kw)
    for mesh in (("cpu",) * 3, ("cpu", "cpu:0"), ("cpu",) * 7):
        q, f = optimize_batch_sharded(rows, STRENGTHS, 2, mesh=mesh, **kw)
        np.testing.assert_array_equal(q, want[0].numpy())
        np.testing.assert_array_equal(f, want[1].numpy())
    qs, fs, b = optimize_batch_sharded(rows, STRENGTHS, 2, mesh=("cpu",) * 3,
                                       fetch=False, **kw)
    assert b == 5 and [len(q) for q in qs] == [2, 2, 1]
    assert [len(f) for f in fs] == [2, 2, 1]


def test_compress_many_mesh_matches_jax_mesh():
    pngs = [encode(im, row_filters=None) for im in _images()]
    got = pipeline.compress_many(pngs, STRENGTHS,
                                 mesh=data_mesh(("cpu",) * 3))
    want = jax_pipeline.compress_many(
        pngs, STRENGTHS, mesh=jax_data_mesh(jax.devices("cpu")[:4]))
    assert [r.unwrap() for r in got] == [r.unwrap() for r in want]


def test_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CudaUnavailableError, match="CUDA is not available"):
        data_mesh()
    with pytest.raises(CudaUnavailableError, match="CUDA is not available"):
        data_mesh(("cuda:0", "cuda:0"))
    with pytest.raises(CudaUnavailableError, match="CUDA is not available"):
        pipeline.compress_many([b""], 19, mesh=("cuda",))
    with pytest.raises(CudaUnavailableError, match="CUDA is not available"):
        resolve_mesh()
    with pytest.raises(ValueError, match="no devices"):
        data_mesh(())
