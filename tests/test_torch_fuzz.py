"""The port's random differential check (``tools/fuzz_torch.py`` and
``ops/random_cases.py``) on the CPU, and the image stage's test-only
``never_pass`` flag, which reaches the retry variant's give-up branch (no
filter passes at strength 0).

Random batches go through the port's entry points on the CPU (its plain
PyTorch versions) and through the JAX package's scalar model
(``pngloss_tpu.core.reference``), compared exactly: the PNG bytes in CLI
mode, the planes and filters in embedding mode. Integers throughout:
tolerance 0.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pngloss_tpu import codec as jax_codec
from pngloss_tpu.core import reference as jax_reference
from pngloss_tpu_torch import pipeline
from pngloss_tpu_torch.ops import image, optimize
from pngloss_tpu_torch.ops.edges import GIVE_UP_H, give_up_inputs
from pngloss_tpu_torch.ops.random_cases import (
    KINDS,
    NEVER_PASS_MAX_STRENGTH,
    random_bleed,
    random_bucket,
    random_rgba,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "fuzz_torch.py")
_spec = importlib.util.spec_from_file_location("fuzz_torch", TOOL)
fuzz_torch = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fuzz_torch)

# the kinds of each working bpp: one bpp per batch keeps it one bucket
KINDS_OF_BPP = {1: ("gray", "flat"), 2: ("gray_alpha",),
                3: ("rgb", "noisy"), 4: ("rgba",)}


@pytest.mark.parametrize("seed", range(8))
def test_random_batch_matches_the_scalar_model(seed):
    """Seeds 0-7 cover CLI and embedding mode at bpp 1-4; each batch is 4
    random images of up to 8 x 8 px (one bucket), strengths over 0-255."""
    mode = ("cli", "embed")[seed % 2]
    bpp = seed // 2 + 1
    rng = np.random.default_rng(6000 + seed)
    bleed = random_bleed(rng)
    rgbas = [random_rgba(rng, str(rng.choice(KINDS_OF_BPP[bpp])),
                         *rng.integers(1, 9, 2)) for _ in range(4)]
    strengths = rng.integers(0, 256, 4).tolist()
    assert {pipeline.working_bpp(rgba) for rgba in rgbas} == {bpp}
    if mode == "cli":
        pngs = [jax_codec.encode(rgba, row_filters=None) for rgba in rgbas]
        got = pipeline.compress_many(pngs, strengths, bleed, device="cpu")
        for png, s, res in zip(pngs, strengths, got):
            img = jax_codec.decode(png)
            q, f = jax_reference.optimize_rgba(img.rgba, s, bleed)
            assert res.unwrap() == jax_codec.encode(
                q, row_filters=f, gamma=img.gamma,
                color_transform=img.color_transform, chunks=img.chunks)
    else:
        qs, fs = pipeline.optimize_rgba_batch(
            rgbas, strengths, bleed, use_row_filters=False, device="cpu")
        for rgba, s, q, f in zip(rgbas, strengths, qs, fs):
            q_ref, f_ref = jax_reference.optimize_rgba(rgba, s, bleed, False)
            np.testing.assert_array_equal(q, q_ref)
            np.testing.assert_array_equal(f, f_ref)


def test_random_bucket_lies_inside_its_shape():
    rng = np.random.default_rng(6100)
    shapes = set()
    for _ in range(40):
        bk = random_bucket(rng, max_steps=4096)
        h, w = bk.shape
        shapes.add((h, w, bk.bpp))
        assert (h - 1) * w * bk.bpp <= 4096
        assert (bk.h_real[0], bk.w_real[0]) == (h, w)
        assert ((1 <= bk.h_real) & (bk.h_real <= h)).all()
        assert ((1 <= bk.w_real) & (bk.w_real <= w)).all()
        for k in range(len(bk.kinds)):
            plane = bk.rows[k].reshape(h, w, bk.bpp)
            assert not plane[bk.h_real[k]:].any()
            assert not plane[:, bk.w_real[k]:].any()
        assert not (bk.never_pass.astype(bool)
                    & (bk.strengths > NEVER_PASS_MAX_STRENGTH)).any()
        assert set(bk.kinds) <= set(KINDS)
    assert len({s[2] for s in shapes}) == 4 and len(shapes) > 20


def test_kernel_divergence_names_the_first_difference():
    """The fuzz tool's report of a kernel mismatch: the first kernel in
    order, the output, its named index (image rows from 1) and the filters
    of that row."""
    q = np.zeros((2, 3, 4, 2), np.int32)
    f = np.zeros((2, 3), np.int32)
    q_bad, f_bad = q.copy(), f.copy()
    q_bad[1, 2, 3, 1] = 7
    f_bad[1, 2] = 4
    pairs = {"hist": {"hist": (np.zeros((2, 5, 256)),) * 2},
             "image": {"q": (q_bad, q), "f": (f_bad, f)}}
    assert fuzz_torch.kernel_divergence(pairs, 0) is None
    assert fuzz_torch.kernel_divergence(pairs, 1) == {
        "kernel": "image", "output": "q", "row": 3, "col": 3, "channel": 1,
        "got": 7, "want": 0, "filter": [4, 0]}


def _flagged_alike(monkeypatch, flags):
    """msad_valid, stubbed to fail every filter of the flagged images: the
    rule ``never_pass`` stands for."""
    real = optimize.msad_valid
    monkeypatch.setattr(optimize, "msad_valid", lambda q5, qprev, w_real:
                        real(q5, qprev, w_real) & (flags == 0)[:, None])


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_never_pass_equals_the_stubbed_self_check(monkeypatch, bpp):
    """The plain versions with ``never_pass`` equal themselves under a
    stubbed self-check that fails the flagged images: the adaptive variant
    clears their ok, the retry variant takes s + 1 attempts a row on them
    and at strength 0 picks the first minimum of the true row cost; the
    unflagged images equal themselves run alone."""
    args, flags = give_up_inputs(bpp, "cpu", strengths=[0, 1, 2, 3, 40, 2])
    s, bleed, w_real, ofreq, rows, qprev, e0, e1, hist0 = args
    q, f, tries = image.image_rows(*args, adaptive=True, retry=True,
                                   never_pass=flags)
    qa, fa, ok = image.image_rows(*args, adaptive=True, never_pass=flags)
    flagged = flags.bool()
    assert tries[flagged].tolist() == [
        (int(v) + 1) * (GIVE_UP_H - 1) for v in s[flagged]]
    assert not ok[flagged].any()

    for k in (~flagged).nonzero().squeeze(1).tolist():
        one = [a[k:k + 1] if isinstance(a, torch.Tensor) else a
               for a in args]
        qk, fk, nk = image.image_rows(*one, adaptive=True, retry=True)
        assert torch.equal(qk, q[k:k + 1]) and torch.equal(fk, f[k:k + 1])
        assert int(nk) == int(tries[k])

    # strength 0 without a passing filter: the first minimum of the true
    # cost, row by row from the state the flagged images' winners leave
    sel = flagged.nonzero().squeeze(1)
    b, h, wb = rows.shape
    orig = rows[sel].view(len(sel), h, wb // bpp, bpp).to(torch.int32)
    state = tuple(t[sel] for t in (qprev, hist0, e0, e1))
    zero = torch.zeros(len(sel), dtype=torch.int32)
    for y in range(1, h):
        qp, hp, e0p, e1p = state
        cand = optimize.quantize_row(zero, bleed, orig[:, y], qp, e0p, e1p,
                                     hp, ofreq[sel], w_real[sel])
        best = optimize.first_min(optimize.row_cost(
            cand[0], hp, cand[1], qp, orig[:, y], orig[:, y - 1],
            w_real[sel]))
        assert torch.equal(f[sel, y - 1].long(), best)
        state = tuple(optimize.pick(t, best) for t in cand)
        assert torch.equal(q[sel, y - 1], state[0])

    _flagged_alike(monkeypatch, flags)
    assert all(torch.equal(a, b) for a, b in zip(
        (q, f, tries), image.image_rows(*args, adaptive=True, retry=True)))
    assert all(torch.equal(a, b) for a, b in zip(
        (qa, fa, ok), image.image_rows(*args, adaptive=True)))


def test_fuzz_tool_on_the_cpu_exits_0():
    proc = subprocess.run(
        [sys.executable, TOOL, "--device", "cpu", "--total", "16", "--max-px", "8"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["cases"] >= 16 and summary["mismatches"] == 0
    assert summary["modes"] == ["cli", "embed"]


def test_fuzz_tool_refuses_cuda_without_it():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    proc = subprocess.run(
        [sys.executable, TOOL, "--device", "cuda", "--total", "1"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "CUDA" in proc.stderr
    assert not proc.stdout
