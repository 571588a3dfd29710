"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a CUDA device. On the card (where JAX is not installed):

    PNGLOSS_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -q

(PNGLOSS_TEST_TPU=1 keeps tests/conftest.py from importing JAX.)
"""

import numpy as np
import pytest
import torch

from pngloss_tpu_torch.ops import hist, image, optimize_batch_auto, row

pytestmark = pytest.mark.cuda

STRENGTHS = [0, 3, 19, 255]
W_REAL = [7, 5, 7, 2]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _i32(a, device):
    return torch.as_tensor(np.asarray(a, np.int32), device=device)


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


def _row_state(rng, bpp, device):
    """A mid-image state of 4 images x 7 px with many frequency ties,
    transparent pixels (bpp 2, 4) and a saturated band."""
    orig = rng.integers(0, 256, (4, 7, bpp))
    if bpp % 2 == 0:
        orig[:, ::2, bpp - 1] = 0
    orig[0, :3] = 255
    return dict(
        orig=_i32(orig, device),
        qprev=_i32(rng.integers(0, 256, (4, 7, bpp)), device),
        e0=_i32(rng.integers(-40, 41, (4, 12, 4)), device),
        e1=_i32(rng.integers(-40, 41, (4, 12, 4)), device),
        hist=_i32(rng.integers(0, 3, (4, 256)), device),
        ofreq=_i32(rng.integers(0, 3, (4, 5, 256)), device),
    )


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_hist_kernel_matches_plain(cuda, bpp):
    rng = np.random.default_rng(420 + bpp)
    rows = rng.integers(0, 256, (3, 8, 9 * bpp), dtype=np.uint8)
    rows[1, :, :4] = 7                                   # hot bins
    rows_d = torch.as_tensor(rows, device=cuda)
    ragged = (_i32([9, 4, 2], cuda), _i32([8, 3, 5], cuda))
    for args in ((), ragged):
        _assert_same([hist.original_frequencies(rows_d, bpp, *args)],
                     [hist.original_frequencies_ref(rows_d, bpp, *args)])


@pytest.mark.parametrize("bleed", [1, 2, 32767])
@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_row_and_image_kernels_match_plain(cuda, bpp, bleed):
    rng = np.random.default_rng(430 + 10 * bpp + bleed % 7)
    st = _row_state(rng, bpp, cuda)
    s, w_real = _i32(STRENGTHS, cuda), _i32(W_REAL, cuda)
    args = (s, bleed, st["orig"], st["qprev"], st["e0"], st["e1"],
            st["hist"], st["ofreq"], w_real)
    _assert_same(row.row_attempt(*args), row.row_attempt_ref(*args))

    img = rng.integers(0, 256, (4, 6, 7 * bpp), dtype=np.uint8)
    if bpp % 2 == 0:
        img.reshape(4, 6, 7, bpp)[:, 1::2, ::2, bpp - 1] = 0
    args = (s, bleed, w_real, st["ofreq"], torch.as_tensor(img, device=cuda),
            st["qprev"], st["e0"], st["e1"], st["hist"])
    want = image.image_rows_ref(*args)
    _assert_same(image.image_rows(*args), want)
    # the plain version's CUDA-graph replay against its eager run on the CPU
    _assert_same(want, image.image_rows_ref(*(
        a.cpu() if isinstance(a, torch.Tensor) else a for a in args)))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_adaptive_image_kernel_matches_plain(cuda, bpp):
    """The image kernel's adaptive variant (embedding mode's speculation):
    rows, filters and ok, on inputs where some rows have no passing
    filter."""
    rng = np.random.default_rng(440 + bpp)
    s, w_real = _i32(STRENGTHS, cuda), _i32(W_REAL, cuda)
    oks = set()
    for bleed in (1, 2, 32767):
        st = _row_state(rng, bpp, cuda)
        img = rng.integers(0, 256, (4, 6, 7 * bpp), dtype=np.uint8)
        if bpp % 2 == 0:
            img.reshape(4, 6, 7, bpp)[:, 1::2, ::2, bpp - 1] = 0
        args = (s, bleed, w_real, st["ofreq"],
                torch.as_tensor(img, device=cuda), st["qprev"], st["e0"],
                st["e1"], st["hist"])
        want = image.image_rows_ref(*args, adaptive=True)
        _assert_same(image.image_rows(*args, adaptive=True), want)
        oks.update(want[2].tolist())
    assert 1 in oks


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_embedding_cuda_matches_cpu(cuda, bpp):
    rng = np.random.default_rng(450 + bpp)
    rows = rng.integers(0, 256, (4, 6, 7 * bpp), dtype=np.uint8)
    if bpp % 2 == 0:
        rows.reshape(4, 6, 7, bpp)[:, ::2, 1::3, bpp - 1] = 0
    kw = dict(bpp=bpp, use_row_filters=False, w_real=[7, 4, 7, 1],
              h_real=[6, 6, 1, 3])
    before = image.ADAPTIVE_LAUNCHES
    qg, fg = optimize_batch_auto(rows, [45, 19, 0, 255], 2, device=cuda,
                                 **kw)
    assert image.ADAPTIVE_LAUNCHES == before + 1
    qc, fc = optimize_batch_auto(rows, [45, 19, 0, 255], 2, device="cpu",
                                 **kw)
    np.testing.assert_array_equal(qg.cpu().numpy(), qc.numpy())
    np.testing.assert_array_equal(fg.cpu().numpy(), fc.numpy())


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_optimizer_cuda_matches_cpu(cuda, bpp):
    rng = np.random.default_rng(400 + bpp)
    rows = rng.integers(0, 256, (3, 9, 11 * bpp), dtype=np.uint8)
    if bpp % 2 == 0:
        rows.reshape(3, 9, 11, bpp)[:, ::2, 1::3, bpp - 1] = 0
    kw = dict(bpp=bpp, w_real=[11, 6, 1], h_real=[9, 1, 5])
    for s, bleed in (([19, 0, 255], 2), ([3, 40, 19], 1)):
        qg, fg = optimize_batch_auto(rows, s, bleed, device=cuda, **kw)
        qc, fc = optimize_batch_auto(rows, s, bleed, device="cpu", **kw)
        np.testing.assert_array_equal(qg.cpu().numpy(), qc.numpy())
        np.testing.assert_array_equal(fg.cpu().numpy(), fc.numpy())


def test_compress_many_cuda_matches_cpu(cuda):
    from pngloss_tpu.codec import encode
    from pngloss_tpu_torch.pipeline import compress_many

    rng = np.random.default_rng(410)
    rgba = rng.integers(0, 256, (3, 12, 17, 4), dtype=np.uint8)
    rgba[..., 3] = 255
    rgba[2, ::2, ::3, 3] = 0
    pngs = [encode(im, row_filters=None) for im in rgba]
    got = compress_many(pngs, [19, 0, 40], device=cuda)
    want = compress_many(pngs, [19, 0, 40], device="cpu")
    assert [r.unwrap() for r in got] == [r.unwrap() for r in want]


def _pngs(seed, n=3, h=12, w=17):
    from pngloss_tpu.codec import encode

    rgba = np.random.default_rng(seed).integers(0, 256, (n, h, w, 4),
                                                dtype=np.uint8)
    rgba[..., 3] = 255
    rgba[-1, ::2, ::3, 3] = 0
    return [encode(im, row_filters=None) for im in rgba]


def test_cli_on_the_card(cuda, tmp_path, monkeypatch):
    import io

    from pngloss_tpu_torch import cli

    pngs = _pngs(460)
    outs = {}
    for dev in (cuda, "cpu"):
        d = tmp_path / str(dev).replace(":", "_")
        d.mkdir()
        for k, png in enumerate(pngs):
            (d / f"i{k}.png").write_bytes(png)
        monkeypatch.chdir(d)
        assert cli.run(["-f", "-s", "19", "i0.png", "i1.png", "i2.png"],
                       device=dev) == 0
        stdout = io.BytesIO()
        assert cli.run(["-f", "-s", "40", "-"], stdin=io.BytesIO(pngs[1]),
                       stdout=stdout, device=dev) == 0
        outs[str(dev)] = ([(d / f"i{k}-loss.png").read_bytes()
                           for k in range(3)], stdout.getvalue())
    assert outs[str(cuda)] == outs["cpu"]


def test_mesh_of_one_card_twice(cuda):
    from pngloss_tpu_torch import pipeline
    from pngloss_tpu_torch.parallel import data_mesh

    mesh = data_mesh((cuda, cuda))
    pngs = _pngs(461, n=5)
    strengths = [19, 0, 40, 3, 255]
    got = pipeline.compress_many(pngs, strengths, mesh=mesh)
    want = pipeline.compress_many(pngs, strengths, device=cuda)
    assert [r.unwrap() for r in got] == [r.unwrap() for r in want]
    rgbas = list(np.random.default_rng(462).integers(
        0, 256, (5, 6, 7, 4), dtype=np.uint8))
    q2, f2 = pipeline.optimize_rgba_batch(rgbas, 45, use_row_filters=False,
                                          mesh=mesh)
    q1, f1 = pipeline.optimize_rgba_batch(rgbas, 45, use_row_filters=False,
                                          device=cuda)
    for a, b in zip(q2 + f2, q1 + f1):
        np.testing.assert_array_equal(a, b)


def test_device_trace_lists_the_kernels(cuda, tmp_path):
    import json
    import os

    from pngloss_tpu_torch import pipeline, tracing

    with tracing.device_trace(str(tmp_path)):
        pipeline.compress_many(_pngs(463), 19, device=cuda)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = " ".join(e.get("name", "") for e in events
                       if e.get("cat") == "kernel")
    for k in ("hist_kernel", "row_kernel", "image_kernel"):
        assert k in kernels, k


def test_kernels_launch_on_their_tensors_device(cuda):
    """Tensors on cuda:1 while cuda:0 is the current device: each wrapper
    launches on its tensor's device, and the pipeline records each copy's
    event on the stream of the device that did the copy. A machine with one
    card cannot show this fault."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices")
    from pngloss_tpu_torch import pipeline

    other = torch.device("cuda", 1)
    rng = np.random.default_rng(464)
    with torch.cuda.device(0):
        for bpp in (1, 3, 4):
            rows = torch.as_tensor(
                rng.integers(0, 256, (3, 8, 9 * bpp), dtype=np.uint8),
                device=other)
            got = hist.original_frequencies(rows, bpp)
            assert got.device == other
            _assert_same([got], [hist.original_frequencies_ref(rows.cpu(),
                                                               bpp)])
            st = _row_state(rng, bpp, other)
            s, w_real = _i32(STRENGTHS, other), _i32(W_REAL, other)
            args = (s, 2, st["orig"], st["qprev"], st["e0"], st["e1"],
                    st["hist"], st["ofreq"], w_real)
            _assert_same(row.row_attempt(*args), row.row_attempt_ref(
                *(a.cpu() if isinstance(a, torch.Tensor) else a
                  for a in args)))
            img = torch.as_tensor(
                rng.integers(0, 256, (4, 6, 7 * bpp), dtype=np.uint8),
                device=other)
            args = (s, 2, w_real, st["ofreq"], img, st["qprev"], st["e0"],
                    st["e1"], st["hist"])
            cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else a
                        for a in args]
            for adaptive in (False, True):
                _assert_same(image.image_rows(*args, adaptive=adaptive),
                             image.image_rows_ref(*cpu_args,
                                                  adaptive=adaptive))
        pngs = _pngs(465, n=4)
        want = [r.unwrap() for r in pipeline.compress_many(pngs, 19,
                                                           device="cpu")]
        for mesh in ((other,), (cuda, other)):
            got = pipeline.compress_many(pngs, 19, mesh=mesh)
            assert [r.unwrap() for r in got] == want
