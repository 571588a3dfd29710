"""The port's CLI-mode pipeline: same PNG bytes as pngloss_tpu.pipeline,
no JAX import, and no silent CPU run when CUDA is asked for."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pngloss_tpu import pipeline as jax_pipeline
from pngloss_tpu.codec import decode, encode
from pngloss_tpu_torch import pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mixed_pngs():
    """Mixed sizes, colorspaces and strengths (as __graft_entry__.py's
    ragged mesh check builds them)."""
    rng = np.random.default_rng(1)
    pngs = []
    for h, w, kind in ((6, 5, "rgb"), (9, 4, "gray"), (6, 5, "rgba"),
                       (3, 11, "rgb"), (7, 7, "gray_alpha")):
        rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        if kind in ("gray", "gray_alpha"):
            rgba[:, :, 0] = rgba[:, :, 2] = rgba[:, :, 1]
        if kind in ("gray", "rgb"):
            rgba[:, :, 3] = 255
        pngs.append(encode(rgba, row_filters=None))
    return pngs, [0, 19, 3, 40, 19]


def test_compress_many_bytes_match_jax_pipeline():
    pngs, strengths = _mixed_pngs()
    got = pipeline.compress_many(pngs, strengths, device="cpu")
    want = jax_pipeline.compress_many(pngs, strengths)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.unwrap() == b.unwrap(), f"file {i} differs"
        assert a.output_size == b.output_size
    # -s 0 is pixel-lossless
    out = decode(got[0].unwrap()).rgba
    np.testing.assert_array_equal(out, decode(pngs[0]).rgba)


def test_compress_bytes_and_errors():
    pngs, _ = _mixed_pngs()
    assert (pipeline.compress_bytes(pngs[3], 19, device="cpu")
            == jax_pipeline.compress_bytes(pngs[3], 19))
    res = pipeline.compress_many([b"not a png", pngs[1]], 19, device="cpu")
    assert res[0].error is not None and res[0].data is None
    assert res[1].unwrap() == jax_pipeline.compress_bytes(pngs[1], 19)


def test_optimize_rgba_batch_matches_reference():
    from pngloss_tpu.core import reference as ref

    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
            for h, w in ((4, 5), (3, 6), (4, 5))]
    imgs[0][..., 3] = 255
    qs, fs = pipeline.optimize_rgba_batch(imgs, [19, 0, 40], device="cpu")
    for img, s, q, f in zip(imgs, (19, 0, 40), qs, fs):
        q_ref, f_ref = ref.optimize_rgba(img, s)
        np.testing.assert_array_equal(q, q_ref)
        np.testing.assert_array_equal(f, f_ref)


def test_import_pulls_in_no_jax():
    code = ("import sys, pngloss_tpu_torch.pipeline, pngloss_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.startswith(('pngloss_tpu.ops', 'pngloss_tpu.pipeline',"
            " 'pngloss_tpu.parallel', 'pngloss_tpu.compile_cache'))]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cuda_without_cuda_raises(monkeypatch):
    """device='cuda' must never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pngs, _ = _mixed_pngs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.compress_many(pngs[:1], 19, device="cuda")
    from pngloss_tpu_torch.ops import optimize_batch_auto

    rows = np.zeros((1, 2, 3), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        optimize_batch_auto(rows, 19, bpp=1, device="cuda")

