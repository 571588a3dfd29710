"""``bench_torch.py``, the port's benchmark, on the CPU: every case's
inputs are seeded (the same when built twice) and have the shapes, bpp
and strengths its table states; the gate on a cut-down case passes with
device="cpu" and fails on one flipped output byte; the bench case's
batch and megapixels are ``bench.py``'s; and without CUDA ``main``
returns non-zero, names CUDA and times nothing."""

import os

import numpy as np
import pytest

import bench
import bench_torch
import chip_smoke
from pngloss_tpu_torch.codec import encode
from pngloss_tpu_torch.pipeline import reduce_colorspace

SIDE = chip_smoke.SIDE
# case: (images, jobs, strength, bpp of each image, (H, W) of each image);
# None where the images differ (the corpus, checked on its own)
TABLE = {
    "batch16_s19": (16, 16, 19, [3] * 16, (SIDE, SIDE)),
    "full_card_s19": (132, 132, 19, [3] * 132, (SIDE, SIDE)),
    "corpus_ragged": (104, 104, 19, None, None),
    "textured_s90": (16, 16, 90, [3] * 16, (SIDE, SIDE)),
    "lossless_s0": (16, 16, 0, [3] * 16, (SIDE, SIDE)),
    "rgba_s19": (16, 16, 19, [4] * 16, (SIDE, SIDE)),
    "suite_mixed": (12, 48, (0, 19, 40, 90), [1, 2, 3, 4] * 3, (SIDE, SIDE)),
    "photo_s19": (1, 1, 19, [3], (3000, 4000)),
    "screenshot_s19": (1, 1, 19, [3], (1080, 1920)),
    "embed16": (16, 16, 19, [3] * 16, (SIDE, SIDE)),
    "embed_gray16": (16, 16, 19, [1] * 16, (SIDE, SIDE)),
}


def test_table_names_every_case():
    assert set(TABLE) == set(bench_torch.CASES)
    assert bench_torch.NAMES == ("bench", *TABLE)


@pytest.mark.parametrize("name", sorted(TABLE))
def test_case_inputs_repeat_and_have_their_shapes(name):
    """Each case's images, built twice, are equal and have the stated
    shapes, bpp and strengths (generated only: no PNG is encoded and no
    optimizer runs here)."""
    case = bench_torch.CASES[name]
    first, second = case.images(), case.images()
    assert len(first) == len(second)
    for a, b in zip(first, second):
        assert a.dtype == np.uint8 and np.array_equal(a, b)
    n, jobs, strength, bpps, hw = TABLE[name]
    assert len(first) == n and case.strength == strength
    assert (n * (1 if isinstance(strength, int) else len(strength))) == jobs
    if hw is not None:
        assert all(im.shape == (*hw, 4) for im in first)
    if bpps is not None:
        assert [reduce_colorspace(im)[1] for im in first] == bpps
    assert case.entry == ("embedding" if name.startswith("embed")
                          else "compress_many")
    assert all(j < jobs for j in case.cut)


def test_corpus_is_phase_13s():
    """corpus_ragged's images encode to chip_smoke.py phase 13's PNGs: 100
    of 40-400 px at bpp 1-4 in turn, then four 512x512 RGB."""
    images = bench_torch.CASES["corpus_ragged"].images()
    pngs = [encode(im, row_filters=None) for im in images]
    assert pngs == chip_smoke.dispatch_corpus(
        np.random.default_rng(chip_smoke.DISPATCH_SEED))
    bpps = [reduce_colorspace(im)[1] for im in images]
    assert bpps == [1, 2, 3, 4] * 25 + [3] * 4
    assert all(40 <= s <= 400 for im in images[:100] for s in im.shape[:2])
    assert all(im.shape == (SIDE, SIDE, 4) for im in images[100:])


def test_shared_images_are_the_phases():
    """The full card begins with phase 5's 16 images (batch16_s19 and
    lossless_s0), textured_s90 and embed16 share phase 6's batch, and the
    RGBA case holds fully and partly transparent pixels in every cut-down
    crop."""
    p5 = bench_torch.CASES["batch16_s19"].images()
    card = bench_torch.CASES["full_card_s19"].images()[:16]
    assert all(np.array_equal(a, b) for a, b in zip(p5, card))
    assert all(np.array_equal(a, b) for a, b in zip(
        bench_torch.CASES["textured_s90"].images(),
        bench_torch.CASES["embed16"].images()))
    for im in bench_torch.CASES["rgba_s19"].images():
        alpha = im[:bench_torch.CUT_SIDE, :bench_torch.CUT_SIDE, 3]
        assert (alpha == 0).any() and (alpha == 255).any()
        assert ((alpha > 0) & (alpha < 255)).any()


def test_suite_mixed_lays_out_jobs_as_run_suite():
    case = bench_torch.CASES["suite_mixed"]
    images = case.images()
    inp = bench_torch.case_inputs(case, images)
    assert inp.strength == [s for s in (0, 19, 40, 90) for _ in range(12)]
    assert inp.files == inp.files[:12] * 4 and len(set(inp.files)) == 12
    cut = bench_torch.case_inputs(case, images, cut=True)
    assert cut.strength == [0, 19, 40, 90]
    assert [reduce_colorspace(im)[1] for im in
            (images[j % 12][:32, :32] for j in case.cut)] == [1, 2, 3, 4]


@pytest.fixture(scope="module")
def cut_batch16():
    case = bench_torch.CASES["batch16_s19"]
    return bench_torch.cut_outputs(case, case.images(), "cpu")


def test_gate_passes_on_a_cut_down_case_on_the_cpu(cut_batch16):
    got, cpu, ref = cut_batch16
    assert len(got) == bench_torch.CUT_JOBS
    bench_torch.gate_cut("batch16_s19", "cpu", got, cpu, ref)


@pytest.mark.parametrize("against", ["cpu", "reference"])
def test_gate_fails_on_one_flipped_byte(cut_batch16, against):
    got, cpu, ref = cut_batch16
    bad = list(cpu if against == "cpu" else ref)
    png = bytearray(bad[2])
    png[len(png) // 2] ^= 0x01
    bad[2] = bytes(png)
    args = (got, bad, ref) if against == "cpu" else (got, cpu, bad)
    with pytest.raises(bench_torch.GateError, match="job 2"):
        bench_torch.gate_cut("batch16_s19", "cpu", *args)


def test_embedding_gate_passes_and_fails_on_a_flipped_byte():
    """embed16's cut-down copy (two smooth and two noise images) on the
    CPU against the scalar model; one flipped plane byte fails it."""
    case = bench_torch.CASES["embed16"]
    got, cpu, ref = bench_torch.cut_outputs(case, case.images(), "cpu")
    bench_torch.gate_cut("embed16", "cpu", got, cpu, ref)
    q = got[3][0].copy()
    q[5, 7, 1] ^= 0x80
    bad = got[:3] + [(q, got[3][1])]
    with pytest.raises(bench_torch.GateError, match="job 3"):
        bench_torch.gate_cut("embed16", "cpu", bad, cpu, ref)


def test_bench_gates_pass_on_the_cpu():
    """The bench case's two entry points on its cut-down planes, on the
    CPU, against the scalar model."""
    batch, bpp, _ = bench_torch.bench_batch(bench_torch.bench_base())
    works, _, _ = bench_torch.stream_works(bench_torch.bench_base())
    cut = batch[:2, :16, :16 * bpp]
    planes = bench_torch.planes_entry(cut, bpp, "cpu")
    bench_torch.gate_cut("bench", "cpu", planes, planes,
                         bench_torch.plane_reference(cut, bpp))
    cut_works = [w[:16, :16 * bpp].copy() for w in works[:2]]
    stream = bench_torch.per_image(bench_torch.stream_call(cut_works, bpp,
                                                           "cpu"))
    bench_torch.gate_cut("bench", "cpu", stream, stream,
                         bench_torch.plane_reference(cut_works, bpp))


def test_bench_batch_and_megapixels_are_bench_pys(tmp_path):
    """bench.make_bench_batch, given the stand-in image as its lena.png,
    builds the same batch, bpp and megapixels; the stream's megapixels
    follow the same arithmetic."""
    base = bench_torch.bench_base()
    (tmp_path / "lena.png").write_bytes(encode(base, row_filters=None))
    want, want_bpp, want_mp = bench.make_bench_batch(str(tmp_path), 25)
    got, bpp, mp = bench_torch.bench_batch(base)
    assert (bpp, mp) == (want_bpp, want_mp) == (3, 25 * 512 * 512 / 1e6)
    np.testing.assert_array_equal(got, want)
    works, _, stream_mp = bench_torch.stream_works(base)
    assert len(works) == 100 and stream_mp == 100 * 512 * 512 / 1e6
    assert bench_torch.megapixels(4, 3000, 4000 * 4, 4) == 48.0
    inp = bench_torch.case_inputs(bench_torch.Case("compress_many", None, 0),
                                  [np.zeros((3, 5, 4), np.uint8)] * 2)
    assert inp.mp == bench_torch.megapixels(2, 3, 5 * 2, 2)


def test_main_without_cuda_times_nothing(capsys, monkeypatch):
    """No CUDA: non-zero, CUDA named on stderr, no metric line, no case
    run or input built."""
    def refuse(*a, **k):
        raise AssertionError("a case ran without CUDA")

    for fn in ("run_case", "run_bench", "run_setup", "case_inputs"):
        monkeypatch.setattr(bench_torch, fn, refuse)
    assert bench_torch.main(["--case", "batch16_s19", "--runs", "3"]) != 0
    assert bench_torch.main([]) != 0
    out, err = capsys.readouterr()
    assert "CUDA" in err
    assert not [ln for ln in out.splitlines() if ln.startswith("{")]
    assert "metric" not in out


def test_cold_copy_holds_the_package_and_no_build(tmp_path):
    """The set-up case's copy: the package and native/, no build/, so a
    process importing it builds its kernels under the copy."""
    bench_torch.cold_copy(str(tmp_path))
    names = set(os.listdir(tmp_path))
    assert names == {"pngloss_tpu_torch", "native"}
    assert os.path.exists(tmp_path / "pngloss_tpu_torch" / "csrc" / "image.cu")
    assert not list(tmp_path.rglob("__pycache__"))
    assert bench_torch.tree_state(str(tmp_path / "build")) is None
    state = bench_torch.tree_state(str(tmp_path / "native"))
    assert state and all(len(s) == 3 for s in state)
