"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a CUDA device. On the card (where JAX is not installed):

    PNGLOSS_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -q

(PNGLOSS_TEST_TPU=1 keeps tests/conftest.py from importing JAX.)
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from pngloss_tpu_torch.ops import (
    hist,
    image,
    ladder,
    optimize,
    optimize_batch_auto,
    optimize_gpu,
    row,
)
from pngloss_tpu_torch.ops.edges import (
    EDGES,
    GIVE_UP_H,
    HIST_EDGES,
    edge_inputs,
    give_up_inputs,
    hist_edge_inputs,
    row_retry_inputs,
    rows_by_step,
)

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


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(HIST_EDGES))
def test_hist_kernel_at_the_designs_edges(cuda, name, bpp):
    """Row pitches of 1 to 16396 bytes, bases and pitches aligned to 16, 4
    and 1 bytes, rows that share a warp, a constant image, real sizes of
    1 x 1, 1 image and 33: the kernel on the card against its plain
    version on the CPU."""
    for on_card, on_cpu in zip(hist_edge_inputs(name, bpp, cuda),
                               hist_edge_inputs(name, bpp, "cpu")):
        _assert_same([hist.original_frequencies(*on_card)],
                     [hist.original_frequencies_ref(*on_cpu)])


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
def test_retry_image_kernel_matches_plain(cuda, bpp):
    """The image kernel's retry variant (embedding mode's per-row path in
    one launch): rows, filters and attempts per image, on inputs where
    some rows retry; the plain version's CUDA-graph replay against its
    eager run on the CPU."""
    rng = np.random.default_rng(470 + bpp)
    s, w_real = _i32(STRENGTHS, cuda), _i32(W_REAL, cuda)
    most = 0
    for bleed in (1, 2, 32767):
        st = _row_state(rng, bpp, cuda)
        img = rng.integers(0, 256, (4, 6, 7 * bpp), dtype=np.uint8)
        if bpp % 2 == 0:
            img.reshape(4, 6, 7, bpp)[:, 1::2, ::2, bpp - 1] = 0
        args = (s, bleed, w_real, st["ofreq"],
                torch.as_tensor(img, device=cuda), st["qprev"], st["e0"],
                st["e1"], st["hist"])
        before = image.RETRY_LAUNCHES
        got = image.image_rows(*args, adaptive=True, retry=True)
        assert image.RETRY_LAUNCHES == before + 1
        want = image.image_rows_retry_ref(*args)
        _assert_same(got, want)
        _assert_same(want, image.image_rows_retry_ref(*(
            a.cpu() if isinstance(a, torch.Tensor) else a for a in args)))
        most = max(most, int(want[2].max()))
    assert most > 5, "no row retried"


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_optimize_rows_cuda_matches_the_loop_over_row_step(cuda, bpp):
    """The per-row path on the card: the row kernel's retry variant runs
    row 0 in one launch, the image kernel's retry variant the rows after
    it in one, and rows, filters and attempts per image equal the row
    kernel's one-attempt variant with the strength loop on the host; from
    a carry (no row 0) the row kernel is not launched at all."""
    rng = np.random.default_rng(492 + bpp)
    b, h, w = 5, 7, 9
    rows = rng.integers(0, 256, (b, h, w * bpp), dtype=np.uint8)
    if bpp % 2 == 0:
        rows.reshape(b, h, w, bpp)[:, ::2, 1::3, bpp - 1] = 0
    rows_d = torch.as_tensor(rows, device=cuda)
    s, wr = _i32([45, 19, 60, 3, 200], cuda), _i32([9, 9, 5, 9, 2], cuda)
    ofreq = hist.original_frequencies(rows_d, bpp, wr)
    orig = rows_d.view(b, h, w, bpp).to(torch.int32)

    *want, tries_host = rows_by_step(s, 2, orig, ofreq, wr)
    before = (row.LAUNCHES, row.RETRY_LAUNCHES)
    carry, _, tries = optimize_gpu.row_step(
        s, 2, orig[:, 0].contiguous(),
        optimize_gpu.zero_carry(b, w, bpp, cuda), ofreq, wr)
    assert (row.LAUNCHES, row.RETRY_LAUNCHES) == (before[0], before[1] + 1)
    tries = tries + image.image_rows(s, 2, wr, ofreq, rows_d, carry.qprev,
                                     carry.e0, carry.e1, carry.hist,
                                     adaptive=True, retry=True)[2]
    _assert_same([tries], [tries_host])
    assert int(tries.max()) > h, "no row retried"

    before = (row.LAUNCHES, row.RETRY_LAUNCHES, image.RETRY_LAUNCHES)
    got = optimize_gpu.optimize_rows(s, 2, orig, ofreq, wr)
    assert (row.LAUNCHES - before[0], row.RETRY_LAUNCHES - before[1],
            image.RETRY_LAUNCHES - before[2]) == (0, 1, 1)
    _assert_same(got, want)

    before = (row.LAUNCHES, row.RETRY_LAUNCHES, image.RETRY_LAUNCHES)
    q, f = optimize_gpu.optimize_rows(s, 2, orig[:, 1:], ofreq, wr,
                                      carry=carry)
    assert (row.LAUNCHES, row.RETRY_LAUNCHES, image.RETRY_LAUNCHES) == (
        before[0], before[1], before[2] + 1)
    _assert_same((q, f), (want[0][:, 1:], want[1][:, 1:]))


def test_embedding_fallback_is_one_retry_launch(cuda):
    """An embedding call on a batch whose speculation would fail some
    images: the row kernel's retry variant runs row 0 once, the image
    kernel's retry variant (the ladder) rows 1..H-1 of the whole batch
    once, and neither the one-attempt row kernel nor the adaptive image
    kernel runs."""
    rows = np.random.default_rng(700).integers(0, 256, (4, 6, 21),
                                               dtype=np.uint8)
    rows_d = torch.as_tensor(rows, device=cuda)
    s, wr = _i32([45] * 4, cuda), _i32([7] * 4, cuda)
    ofreq = hist.original_frequencies(rows_d, 3)
    orig0 = rows_d[:, 0].reshape(4, 7, 3).to(torch.int32)
    c0, _ = optimize_gpu.row0(s, 2, orig0, ofreq, wr)
    ok = image.image_rows(s, 2, wr, ofreq, rows_d, c0.qprev, c0.e0, c0.e1,
                          c0.hist, adaptive=True)[2]
    bad = (ok == 0).nonzero().squeeze(1)
    assert 0 < bad.numel() < 4
    counters = (lambda: (row.LAUNCHES, row.RETRY_LAUNCHES,
                         image.ADAPTIVE_LAUNCHES, image.RETRY_LAUNCHES))
    before = counters()
    qg, fg = optimize_batch_auto(rows, 45, 2, bpp=3, device=cuda,
                                 use_row_filters=False)
    assert tuple(a - b for a, b in zip(counters(), before)) == (0, 1, 0, 1)
    qc, fc = optimize_batch_auto(rows, 45, 2, bpp=3, device="cpu",
                                 use_row_filters=False)
    np.testing.assert_array_equal(qg.cpu().numpy(), qc.numpy())
    np.testing.assert_array_equal(fg.cpu().numpy(), fc.numpy())


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_embedding_cuda_matches_cpu(cuda, bpp):
    rng = np.random.default_rng(450 + bpp)
    rows = rng.integers(0, 256, (4, 6, 7 * bpp), dtype=np.uint8)
    if bpp % 2 == 0:
        rows.reshape(4, 6, 7, bpp)[:, ::2, 1::3, bpp - 1] = 0
    kw = dict(bpp=bpp, use_row_filters=False, w_real=[7, 4, 7, 1],
              h_real=[6, 6, 1, 3])
    before = image.RETRY_LAUNCHES
    qg, fg = optimize_batch_auto(rows, [45, 19, 0, 255], 2, device=cuda,
                                 **kw)
    assert image.RETRY_LAUNCHES == before + 1
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
    for k in ("hist_kernel", "row_ladder_kernel", "image_kernel"):
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
            _assert_same(image.image_rows(*args, adaptive=True, retry=True),
                         image.image_rows_retry_ref(*cpu_args))
        pngs = _pngs(465, n=4)
        want = [r.unwrap() for r in pipeline.compress_many(pngs, 19,
                                                           device="cpu")]
        for mesh in ((other,), (cuda, other)):
            got = pipeline.compress_many(pngs, 19, mesh=mesh)
            assert [r.unwrap() for r in got] == want


def _flat(retry_out):
    """row_retry's ((q, hist, e0n, e1n), filter, attempts) as one list."""
    state, best, tries = retry_out
    return [*state, best, tries]


@pytest.mark.parametrize("name", sorted(EDGES))
def test_kernels_at_the_designs_edges(cuda, name):
    """Each kernel on the card against its plain version on the CPU; the
    row kernel's retry variant on row 0 and on row 1 (which retries from
    strength 32, 255, 2 and 1 in the ``retry-`` cases)."""
    (row_args, image_args) = edge_inputs(name, cuda)
    (row_cpu, image_cpu) = edge_inputs(name, "cpu")
    _assert_same(row.row_attempt(*row_args), row.row_attempt_ref(*row_cpu))
    for on_card, on_cpu in zip(row_retry_inputs(image_args),
                               row_retry_inputs(image_cpu)):
        _assert_same(_flat(row.row_retry(*on_card)),
                     _flat(row.row_retry_ref(*on_cpu)))
    for adaptive in (False, True):
        _assert_same(image.image_rows(*image_args, adaptive=adaptive),
                     image.image_rows_ref(*image_cpu, adaptive=adaptive))
    _assert_same(image.image_rows(*image_args, adaptive=True, retry=True),
                 image.image_rows_retry_ref(*image_cpu))


def test_replayable_runs_its_first_call_eagerly(cuda):
    """The plain versions' repeated step (ops/optimize.replayable) runs
    eagerly on its first call, so a step run once (row 0 of a 4096-px photo
    that passes at once, one row of phase 14's cuts) pays no capture, which
    costs more than the eager call at full width; from the second call it
    replays one capture, with the same values."""
    x = torch.arange(8, dtype=torch.int32, device=cuda)
    seen = []

    def step():
        seen.append(torch.cuda.is_current_stream_capturing())
        return x * 2 + 1

    run = optimize.replayable(step, cuda)
    outs = [run().clone() for _ in range(4)]
    assert seen == [False, True]
    for out in outs:
        _assert_same([out], [x * 2 + 1])


def test_plain_versions_count_candidates_alike_on_the_card(cuda):
    """The plain versions' band-candidate count (chip_smoke.py's operation
    bound) on the card, where the image version replays a CUDA graph after
    its first eager calls, equals the count of their eager run on the
    CPU."""
    name = "equal-channels-bpp4"
    (row_args, image_args), (row_cpu, image_cpu) = (
        edge_inputs(name, cuda), edge_inputs(name, "cpu"))
    for fn, on_card, on_cpu in ((row.row_attempt_ref, row_args, row_cpu),
                                (image.image_rows_ref, image_args,
                                 image_cpu)):
        n_card = torch.zeros((), dtype=torch.int64, device=cuda)
        n_cpu = torch.zeros((), dtype=torch.int64)
        fn(*on_card, count=n_card)
        fn(*on_cpu, count=n_cpu)
        assert int(n_card) == int(n_cpu) > 0


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_give_up_branch_matches_plain(cuda, bpp):
    """The test-only never_pass flag on images at strengths 0, 1, 2 and 40
    beside unflagged images in one launch: the retry variant's give-up
    branch and the adaptive variant's ok against their plain versions on
    the same card tensors; flagged images take s + 1 attempts a row and get
    ok 0, unflagged ones equal themselves run alone."""
    args, flags = give_up_inputs(bpp, cuda)
    retry = image.image_rows(*args, adaptive=True, retry=True,
                             never_pass=flags)
    _assert_same(retry, image.image_rows_retry_ref(*args, never_pass=flags))
    adaptive = image.image_rows(*args, adaptive=True, never_pass=flags)
    _assert_same(adaptive, image.image_rows_ref(*args, adaptive=True,
                                                never_pass=flags))
    flagged = flags.bool()
    assert retry[2][flagged].tolist() == (
        (args[0][flagged] + 1) * (GIVE_UP_H - 1)).tolist()
    assert not adaptive[2][flagged].any()
    for k in (~flagged).nonzero().squeeze(1).tolist():
        one = [a[k:k + 1] if isinstance(a, torch.Tensor) else a
               for a in args]
        _assert_same(image.image_rows(*one, adaptive=True, retry=True),
                     [t[k:k + 1] for t in retry])


def _fuzz_tool():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "fuzz_torch.py")
    spec = importlib.util.spec_from_file_location("fuzz_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("mode", ["cli", "embed"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_slice(cuda, seed, mode):
    """A seeded slice of tools/fuzz_torch.py on the card: random images
    through the entry point against the scalar model, and each kernel
    against its plain version on a random bucket."""
    recs = _fuzz_tool().run_batch(7000 + seed, cuda, mode=mode, max_px=12)
    assert {r["check"] for r in recs} == {"end_to_end", "kernels"}
    assert [r for r in recs if not r["identical"]] == []


ROW_STRENGTHS = [0, 1, 2, 19, 40, 255]


def _mid_state(rng, b, w, bpp, device):
    """A mid-image row state with the previous row's originals."""
    from pngloss_tpu_torch.convert import Carry

    return Carry(_i32(rng.integers(0, 256, (b, w, bpp)), device),
                 _i32(rng.integers(0, 256, (b, w, bpp)), device),
                 _i32(rng.integers(-40, 41, (b, w + 5, 4)), device),
                 _i32(rng.integers(-40, 41, (b, w + 5, 4)), device),
                 _i32(rng.integers(0, 3, (b, 256)), device))


@pytest.mark.parametrize("bleed", [1, 2, 32767])
@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_row_retry_kernel_matches_plain(cuda, bpp, bleed):
    """The row kernel's retry variant (a row with its strength loop, one
    launch) against ``strength_loop`` around ``row_attempt_ref``: rows,
    histograms, dither rows, filters and attempts, at strengths 0, 1, 2,
    19, 40 and 255, from the zero state before row 0 (``row0_retry``) and
    from a mid-image state."""
    rng = np.random.default_rng(500 + 10 * bpp + bleed % 7)
    b, w = len(ROW_STRENGTHS), 9
    s, wr = _i32(ROW_STRENGTHS, cuda), _i32([9, 5, 9, 2, 9, 7], cuda)
    orig = rng.integers(0, 256, (b, w, bpp))
    if bpp % 2 == 0:
        orig[:, ::3, bpp - 1] = 0
    orig = _i32(orig, cuda)
    ofreq = _i32(rng.integers(0, 3, (b, 5, 256)), cuda)
    before = row.RETRY_LAUNCHES
    got = row.row0_retry(s, bleed, orig, ofreq, wr)
    assert row.RETRY_LAUNCHES == before + 1
    _assert_same(_flat(got), _flat(row.row_retry_ref(
        s, bleed, orig, optimize_gpu.zero_carry(b, w, bpp, cuda), ofreq,
        wr)))
    carry = _mid_state(rng, b, w, bpp, cuda)
    got = row.row_retry(s, bleed, orig, carry, ofreq, wr)
    _assert_same(_flat(got), _flat(row.row_retry_ref(s, bleed, orig, carry,
                                                     ofreq, wr)))


def _image_slice(args, k):
    """Image k of a tuple of batch arguments (tensors and Carrys)."""
    from pngloss_tpu_torch.convert import Carry

    return [Carry(*(t[k:k + 1] for t in a)) if isinstance(a, Carry)
            else a[k:k + 1] if isinstance(a, torch.Tensor) else a
            for a in args]


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_row_retry_give_up_branch_matches_plain(cuda, bpp):
    """The test-only never_pass flag on images at strengths 0, 1, 2 and 40
    beside unflagged images in one launch of the row kernel's retry
    variant, at row 0 and row 1: equal to its plain version, flagged images
    take s + 1 attempts, unflagged ones equal themselves run alone."""
    image_args, flags = give_up_inputs(bpp, cuda)
    flagged = flags.bool()
    for args in row_retry_inputs(image_args):
        got = row.row_retry(*args, never_pass=flags)
        _assert_same(_flat(got),
                     _flat(row.row_retry_ref(*args, never_pass=flags)))
        assert got[2][flagged].tolist() == (args[0][flagged] + 1).tolist()
        for k in (~flagged).nonzero().squeeze(1).tolist():
            _assert_same(_flat(row.row_retry(*_image_slice(args, k))),
                         [t[k:k + 1] for t in _flat(got)])


def _ragged_works(seed, n=14):
    """Working-format planes of mixed sizes and bpp 1-4 (several buckets)."""
    rng = np.random.default_rng(seed)
    works, bpps = [], []
    for _ in range(n):
        h, w, bpp = (int(v) for v in (rng.integers(3, 40),
                                      rng.integers(3, 40),
                                      rng.integers(1, 5)))
        works.append(rng.integers(0, 256, (h, w * bpp), dtype=np.uint8))
        bpps.append(bpp)
    return works, bpps


def _collected(pending):
    from pngloss_tpu_torch import pipeline

    out = []
    for p in pending:
        qs, fs = pipeline.collect_bucket(p)
        out += [(q.tobytes(), f.tobytes()) for q, f in zip(qs, fs)]
    return out


def test_dispatch_buckets_waits_for_nothing(cuda):
    """CLI mode on the card makes no host sync: ``dispatch_buckets`` runs
    under ``torch.cuda.set_sync_debug_mode("error")``, and it returns
    before a ~50 ms device-side spin, queued ahead of its work on every
    stream of the pool, has ended. Its output equals a run without the
    spin."""
    from pngloss_tpu_torch import pipeline
    from pngloss_tpu_torch.parallel import mesh

    works, bpps = _ragged_works(470)
    want = _collected(pipeline.dispatch_buckets(works, bpps, 19,
                                                device=cuda))
    spins = []
    for slot in range(mesh.STREAMS):
        with mesh.bucket_stream(cuda, slot):
            torch.cuda._sleep(100_000_000)     # ~50 ms at 1.98 GHz
            spins.append(torch.cuda.Event())
            spins[-1].record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = pipeline.dispatch_buckets(works, bpps, 19, device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not any(e.query() for e in spins)
    assert len(pending) > 3
    assert _collected(pending) == want


def test_dispatch_in_bands_waits_for_nothing(cuda, monkeypatch):
    """One image whose rows run in bands: ``dispatch_buckets`` makes no
    host sync and returns before a ~50 ms spin queued ahead of its work on
    every stream of the pool has ended; its bands land in order, and its
    rows and filters equal one launch's. A first banded call, unspun,
    leaves the process's one-time costs (the copy stream, the first use of
    each kernel) out of the timed one."""
    from pngloss_tpu_torch import pipeline
    from pngloss_tpu_torch.parallel import mesh

    rng = np.random.default_rng(472)
    work = rng.integers(0, 256, (150, 37 * 3), dtype=np.uint8)
    want = _collected(pipeline.dispatch_buckets([work], [3], 19,
                                                device=cuda))
    monkeypatch.setattr(pipeline, "band_rows", lambda wb: 16)
    assert _collected(pipeline.dispatch_buckets([work], [3], 19,
                                                device=cuda)) == want
    spins = []
    for slot in range(mesh.STREAMS):
        with mesh.bucket_stream(cuda, slot):
            torch.cuda._sleep(100_000_000)     # ~50 ms at 1.98 GHz
            spins.append(torch.cuda.Event())
            spins[-1].record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = pipeline.dispatch_buckets([work], [3], 19, device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not any(e.query() for e in spins)
    (p,) = pending
    assert [y for y, _ in p.bands] == list(range(16, 150, 16)) + [150]
    assert not p.bands[0][1].query()
    assert _collected(pending) == want


def test_dispatch_in_bands_at_the_photos_height_waits_for_nothing(cuda):
    """The photo's 143 bands (3000 x 4000 RGB, 21 rows a band) queue
    without a host sync and without filling the card's launch queue: when
    ``dispatch_buckets`` returns, at most the first few bands have run (a
    full queue would have held it back until tens of them had)."""
    from pngloss_tpu_torch import pipeline

    rng = np.random.default_rng(473)
    work = rng.integers(0, 256, (3000, 4000 * 3), dtype=np.uint8)
    work[:, ::2] //= 16
    torch.cuda.set_sync_debug_mode("error")
    try:
        (p,) = pipeline.dispatch_buckets([work], [3], 19, device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ran = sum(bool(e.query()) for _, e in p.bands)
    assert len(p.bands) == 143
    p.bands[-1][1].synchronize()
    assert ran <= 4, ran


@pytest.mark.parametrize("h, w", [(1080, 1920), (3000, 4000)])
def test_one_image_streamed_gives_the_one_shot_bytes(cuda, monkeypatch,
                                                     h, w):
    """One RGB image a call at the screenshot's and the photo's sizes: its
    rows in bands and its encode streamed as they land (counted), then in
    one launch and one encode after it: the same PNG."""
    from pngloss_tpu_torch import codec, pipeline, tracing

    rng = np.random.default_rng(h)
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([x * 255 // w, y * 255 // h, (x + y) * 255 // (w + h)],
                   -1) + rng.integers(-6, 7, (h, w, 3))
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :3] = np.clip(rgb, 0, 255)
    png = codec.encode(rgba, row_filters=None)

    def counted():
        first = max((s.id for s in tracing.records()["spans"]), default=0)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            (r,) = pipeline.compress_many([png], 19, device=cuda)
        roots = {s.id for s in tracing.records()["spans"]
                 if s.id > first and s.parent is None}
        got = {}
        for c in tracing.records()["counts"]:
            if c.request in roots:
                got[c.name] = got.get(c.name, 0) + c.n
        return r.unwrap(), got

    streamed, counts = counted()
    assert counts == {"pipeline.buckets": 1, "image.images": 1,
                      "image.split": 1, "encode.streamed": 1}
    monkeypatch.setattr(pipeline, "band_rows", lambda wb: 1 << 30)
    one, counts = counted()
    assert counts["encode.streamed"] == 0
    assert streamed == one


def test_verbose_one_image_in_bands_counts_its_landed_rows(cuda,
                                                            monkeypatch):
    """``-v`` on one image whose rows run in bands of 16 (its encode
    streamed as they land): the output and every line of the report, the
    symbol count read once every row has landed among them, equal the
    call's in one launch."""
    import contextlib
    import io

    from pngloss_tpu_torch import cli, codec, pipeline

    rgba = np.random.default_rng(474).integers(0, 256, (300, 64, 4),
                                               dtype=np.uint8)
    rgba[..., 3] = 255
    rgba[::2] //= 8
    png = codec.encode(rgba, row_filters=None)
    outs = []
    for band in (16, 1 << 30):
        monkeypatch.setattr(pipeline, "band_rows", lambda wb, n=band: n)
        stdout, stderr = io.BytesIO(), io.StringIO()
        with contextlib.redirect_stderr(stderr):
            assert cli.run(["-v", "-f", "-s", "19", "-"],
                           stdin=io.BytesIO(png), stdout=stdout,
                           device=cuda) == 0
        outs.append((stdout.getvalue(), stderr.getvalue()))
    assert "unique symbols" in outs[0][1]
    assert outs[0] == outs[1]


def test_pool_of_one_gives_the_pools_bytes(cuda, monkeypatch):
    """``compress_many`` with one stream a device, in the dispatch order
    of the bucket keys as they first appear, gives the bytes of the pool
    in longest-chain order."""
    from pngloss_tpu.codec import encode
    from pngloss_tpu_torch import pipeline
    from pngloss_tpu_torch.parallel import mesh

    rng = np.random.default_rng(471)
    pngs = []
    for _ in range(10):
        h, w = (int(v) for v in rng.integers(3, 60, 2))
        rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        rgba[..., 3] = 255 if h % 2 else rgba[..., 3]
        pngs.append(encode(rgba, row_filters=None))
    want = [r.unwrap() for r in pipeline.compress_many(pngs, 19,
                                                       device=cuda)]
    monkeypatch.setattr(mesh, "STREAMS", 1)
    monkeypatch.setattr(pipeline, "dispatch_order", list)
    got = [r.unwrap() for r in pipeline.compress_many(pngs, 19, device=cuda)]
    assert got == want


# the image kernel's retry variant (the ladder): inputs whose rows retry
# from strengths 0, 1, 2, 32 and 255 from carried states (ops/edges.EDGES)
# and the give-up batch (never_pass on images at 0, 1, 2 and 40)
LADDER_CASES = ["retry-s0-s1-s255-bpp4", "retry-to-s0-w64-bpp1",
                "retry-from-s32-bpp3", "retry-every-row-w64-s150-bpp2-e40",
                "give-up-bpp1", "give-up-bpp4"]


def _ladder_case(name, device):
    if name.startswith("give-up"):
        return give_up_inputs(int(name[-1]), device)
    return edge_inputs(name, device)[1], None


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("name", LADDER_CASES)
def test_ladder_kernel_matches_plain(cuda, name, k):
    """The ladder at cluster size k on the card: rows, filters and
    attempts equal the sequential plain version's on the CPU, and its
    rounds the plain ladder's."""
    args, flags = _ladder_case(name, cuda)
    cpu, cpu_flags = _ladder_case(name, "cpu")
    b = args[0].shape[0]
    rounds = torch.zeros(b, dtype=torch.int32, device=cuda)
    before = image.RETRY_LAUNCHES
    got = image.image_rows(*args, adaptive=True, retry=True, k=k,
                           never_pass=flags, rounds=rounds)
    assert image.RETRY_LAUNCHES == before + 1
    _assert_same(got, image.image_rows_retry_ref(*cpu, never_pass=cpu_flags))
    want_rounds = torch.zeros(b, dtype=torch.int32)
    image.image_rows_ladder_ref(*cpu, k=k, never_pass=cpu_flags,
                                rounds=want_rounds)
    _assert_same([rounds], [want_rounds])


def test_ladder_size_on_the_card(cuda):
    """The cluster sizes the card keeps resident, and the size picked:
    one of LADDER_SIZES, with an SM for every block."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for bpp in (1, 2, 3, 4):
        resident = ladder.resident_clusters(image.clusters, bpp, cuda)
        assert sorted(resident) == sorted(ladder.LADDER_SIZES)
        assert all(n >= 1 for n in resident.values())
        for b in (1, 2, 16, 33, 132, 1000):
            k = image.ladder_size(b, bpp, cuda)
            assert k == ladder.pick_ladder(b, resident, sms)
            assert k == 1 or (b * k <= sms and resident[k] >= b)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_ladders_keep_one_rung_to_an_sm(cuda, bpp):
    """Both ladders claim more than half of an SM's shared memory a rung
    (csrc/quantize.cuh, kRungClaim), so their occupancy queries count no
    more clusters of k than the SMs hold k rungs one to an SM, at every bpp:
    on an H100's 132 SMs 15 clusters of 8, 30 of 4, 66 of 2 and 132 of 1
    (without the claim the image ladder counted 30 clusters of 8 at bpp
    1), and 16 images get k = 4 from both."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for mod in (image, row):
        resident = ladder.resident_clusters(mod.clusters, bpp, cuda)
        assert resident[1] == sms
        assert all(n * k <= sms for k, n in resident.items()), resident
        if sms == 132:
            assert resident == {8: 15, 4: 30, 2: 66, 1: 132}
            assert mod.ladder_size(16, bpp, cuda) == 4


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("name", LADDER_CASES)
def test_row_ladder_kernel_matches_plain(cuda, name, k):
    """Row 0's ladder (the row kernel's retry variant) at cluster size k on
    the card, on rows 0 and 1 of each case (rows that retry from 255, 32,
    2 and 1, and the give-up batch): row, histogram, dither rows, filter
    and attempts equal the sequential plain version's on the CPU, and its
    rounds the plain ladder's."""
    args, flags = _ladder_case(name, cuda)
    cpu, cpu_flags = _ladder_case(name, "cpu")
    for on_card, on_cpu in zip(row_retry_inputs(args),
                               row_retry_inputs(cpu)):
        b = on_card[0].shape[0]
        rounds = torch.zeros(b, dtype=torch.int32, device=cuda)
        before = row.RETRY_LAUNCHES
        got = row.row_retry(*on_card, never_pass=flags, k=k, rounds=rounds)
        assert row.RETRY_LAUNCHES == before + 1
        _assert_same(_flat(got), _flat(row.row_retry_ref(
            *on_cpu, never_pass=cpu_flags)))
        want_rounds = torch.zeros(b, dtype=torch.int32)
        row.row_retry_ladder_ref(*on_cpu, never_pass=cpu_flags, k=k,
                                 rounds=want_rounds)
        _assert_same([rounds], [want_rounds])


def test_row_ladder_size_on_the_card(cuda):
    """The row ladder's cluster sizes the card keeps resident, and the
    size picked: one of LADDER_SIZES, with an SM for every block."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for bpp in (1, 2, 3, 4):
        resident = ladder.resident_clusters(row.clusters, bpp, cuda)
        assert sorted(resident) == sorted(ladder.LADDER_SIZES)
        assert all(n >= 1 for n in resident.values())
        for b in (1, 2, 16, 33, 132, 1000):
            k = row.ladder_size(b, bpp, cuda)
            assert k == ladder.pick_ladder(b, resident, sms)
            assert k == 1 or (b * k <= sms and resident[k] >= b)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_every_variant_stops_at_the_last_real_row_on_the_card(cuda, bpp):
    """h_real on the card: the CLI, adaptive and ladder variants equal
    their plain versions on a ragged give-up batch (rows after the last
    real one are 0, and count in neither ok nor attempts)."""
    args, flags = give_up_inputs(bpp, cuda)
    hr = _i32([4, 2, 1, 3, 4, 2], cuda)
    _assert_same(image.image_rows(*args, h_real=hr),
                 image.image_rows_ref(*args, h_real=hr))
    _assert_same(image.image_rows(*args, adaptive=True, never_pass=flags,
                                  h_real=hr),
                 image.image_rows_ref(*args, adaptive=True,
                                      never_pass=flags, h_real=hr))
    want = image.image_rows_retry_ref(*args, never_pass=flags, h_real=hr)
    for k in (None, 1, 2, 8):
        _assert_same(image.image_rows(*args, adaptive=True, retry=True,
                                      k=k, never_pass=flags, h_real=hr),
                     want)
