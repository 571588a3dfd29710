"""The configuration ``suite_s19`` and the mixes ``suite11`` and ``photo``:
the suite entry's files in each colour type, read back by the plain
reader to the plan's pixels; the two readers of the suite's spans and
counter; a tiny suite-shaped cell on the CPU, correct, and not correct
under a planted fault; the mixes at their stated sizes."""

import json
import os

import numpy as np
import pytest

from benchmark.harness import cells, spans, traffic
from benchmark.reference import formats, png, scalar
from benchmark.tests.test_bench_cells import SEED, _plant, run_cell

TINY = "suite_s19.tiny_suite"
# upstream's suite/ (BASELINE.md, SURVEY.md section 4): name, kind, colour
# type, height, width
SUITE = [("barbara", "photo", 0, 512, 512), ("david", "photo", 0, 215, 180),
         ("ssr", "screenshot", 0, 645, 900), ("girl", "photo", 2, 503, 755),
         ("lena", "photo", 2, 512, 512), ("parrots", "photo", 2, 512, 768),
         ("rose", "photo", 2, 46, 70), ("tenko", "photo", 2, 382, 554),
         ("dice", "synthetic", 6, 600, 800),
         ("redbrush", "synthetic", 6, 480, 512),
         ("tux", "screenshot", 3, 314, 265)]


def _mix(name):
    with open(os.path.join(cells.BENCH_DIR, "traffic", name + ".json")) as fh:
        return json.load(fh)


def _entry_module():
    return cells._module(cells.ROOT, "entries", "suite")


def tiny_mix():
    """suite11 at about 1/50 of each side, 4-px alpha tiles."""
    mix = _mix("suite11")
    for g in mix["groups"]:
        g["height"] = max(3, g["height"] // 50)
        g["width"] = max(3, g["width"] // 50)
    return dict(mix, alpha_tile=4, full_rows=4)


@pytest.fixture
def suite_root(tiny_root):
    """tiny_root with a tiny suite11-shaped cell added as files."""
    with open(os.path.join(tiny_root, "benchmark", "traffic",
                           "tiny_suite.json"), "w") as fh:
        json.dump(tiny_mix(), fh)
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as fh:
        spec = json.load(fh)
    spec["workloads"].append({"name": TINY, "config": "suite_s19",
                              "traffic": "tiny_suite", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "suite_s19.suite11" in m.get("workloads", ()):
            m["workloads"].append(TINY)
    with open(path, "w") as fh:
        json.dump(spec, fh)
    return tiny_root


def test_suite11_holds_upstreams_sizes_and_colour_types():
    mix = _mix("suite11")
    got = [(g["name"], g["kind"], g["color_type"], g["height"], g["width"])
           for g in mix["groups"]]
    assert got == SUITE
    assert all(g["count"] == 1 for g in mix["groups"])
    assert (mix["per_call"], mix["delivery"], mix["warmup_calls"],
            mix["alpha_tile"], mix["full_rows"]) == (11, "files", 1, 16, 128)
    assert sum(h * w for *_, h, w in SUITE) == 2940287


def test_photo_mix_loads_at_its_size():
    mix = _mix("photo")
    plan = traffic.plan(mix, SEED)
    (im,) = plan.images
    assert im.shape == (3000, 4000, 4) and (im[..., 3] == 255).all()
    assert plan.call(0) == plan.call(3) == [0]
    assert plan.megapixels([0]) == 12.0
    assert (mix["delivery"], mix["warmup_calls"], mix["full_rows"]) == (
        "stdin", 1, 100)


@pytest.mark.parametrize("cell,sizes", [
    ("suite_s19.suite11", [(h, w) for *_, h, w in SUITE]),
    ("cli_s19.photo", [(3000, 4000)])])
def test_new_cells_inputs_follow_the_seed(cell, sizes):
    """The two cells of BENCHMARK.json found by name: one seed gives the
    same images at the stated sizes, another seed others, and one call
    takes every image."""
    mix = cells.load(cell).mix
    a, b = traffic.plan(mix, SEED), traffic.plan(mix, SEED)
    assert [im.shape[:2] for im in a.images] == sizes
    assert a.order == b.order
    assert all(np.array_equal(x, y) for x, y in zip(a.images, b.images))
    c = traffic.plan(mix, SEED + 1)
    assert not any(np.array_equal(x, y) for x, y in zip(a.images, c.images))
    assert sorted(a.call(0)) == list(range(len(sizes)))


def test_entry_writes_each_colour_type(tmp_path):
    """Each file's IHDR has its group's colour type, and the plain reader
    gives back the plan's pixels, which the entry set in place: gray
    R = G = B and opaque, RGB opaque, RGBA under the tiles, the palette's
    PLTE and tRNS with one fully transparent entry."""
    mix = tiny_mix()
    plan = traffic.plan(mix, SEED)
    drawn = [im.copy() for im in plan.images]
    entry = _entry_module().Entry(
        {"strength": 19, "bleed": 2}, plan, str(tmp_path), "cpu")
    assert [os.path.basename(p) for p in entry.paths] == [
        n + ".png" for n, *_ in SUITE]
    bpps = []
    for path, im, was, (name, _, ctype, _, _) in zip(
            entry.paths, plan.images, drawn, SUITE):
        with open(path, "rb") as fh:
            data = fh.read()
        assert formats.color_type(data) == ctype, name
        np.testing.assert_array_equal(formats.read_rgba(data), im)
        bpps.append(scalar.reduce_colorspace(im)[1])
        if ctype in (0, 2):
            assert (im[..., 3] == 255).all()
        if ctype == 0:
            assert (im[..., 0] == im[..., 1]).all()
            assert (im[..., 1] == im[..., 2]).all()
        if ctype == 6:
            np.testing.assert_array_equal(im, was)
        if ctype == 3:
            indices, entries = formats.read_palette(data)
            used = entries[np.unique(indices)]
            assert len(used) <= 256
            assert set(np.unique(used[:, 3])) == {0, 255}
            clear = used[used[:, 3] == 0]
            assert clear.tolist() == [[0, 0, 0, 0]]
            assert set(np.unique(used[:, :3])) <= set(range(0, 256, 51))
            np.testing.assert_array_equal(im[..., 3] == 0, was[..., 3] == 0)
    assert bpps == [1, 1, 1, 3, 3, 3, 3, 3, 4, 4, 4]


def test_entry_refuses_another_bleed(tmp_path):
    plan = traffic.plan(tiny_mix(), SEED)
    with pytest.raises(ValueError, match="bleed"):
        _entry_module().Entry({"strength": 19, "bleed": 3}, plan,
                              str(tmp_path), "cpu")


def test_palette_writer_round_trips_and_reader_refuses_faults():
    rng = np.random.default_rng(5)
    entries = rng.integers(0, 256, (7, 4)).astype(np.uint8)
    entries[-1, 3] = 255
    indices = rng.integers(0, 7, (5, 9)).astype(np.uint8)
    data = formats.write_palette(indices, entries)
    got_idx, got = formats.read_palette(data)
    np.testing.assert_array_equal(got_idx, indices)
    np.testing.assert_array_equal(got[:7], entries)
    np.testing.assert_array_equal(formats.read_rgba(data), entries[indices])
    opaque = entries.copy()
    opaque[:, 3] = 255
    assert b"tRNS" not in formats.write_palette(indices, opaque)
    with pytest.raises(png.PngError):
        formats.read_palette(data[:-20])
    broken = bytearray(data)
    broken[40] ^= 1
    with pytest.raises(png.PngError):
        formats.read_palette(bytes(broken))
    with pytest.raises(png.PngError):
        formats.read_palette(png.write(np.zeros((2, 2, 3), np.uint8)))


def _view(spans_, counts):
    from pngloss_tpu_torch.tracing import Count, Span

    view = type("Run", (), {})()
    view.calls = [dict(t0=1.0, t1=2.0, ok=True, mp=2.0),
                  dict(t0=2.0, t1=3.0, ok=True, mp=2.0),
                  dict(t0=3.0, t1=4.0, ok=False, mp=2.0)]
    return view, ([Span(*s) for s in spans_], [Count(*c) for c in counts])


def test_suite_readers_on_synthetic_spans(monkeypatch):
    """report_s_per_mp: suite.report seconds over the returned calls'
    megapixels; buckets_per_call: pipeline.buckets over those requests;
    a failed call's request is left out."""
    from pngloss_tpu_torch import tracing

    view, rec = _view(
        [(1, None, 1, "suite.run_suite", 1.1, 1.9, 0),
         (2, 1, 1, "pipeline.compress_many", 1.2, 1.5, 0),
         (3, 1, 1, "suite.report", 1.5, 1.6, 0),
         (4, 1, 1, "suite.report", 1.6, 1.8, 0),
         (5, None, 5, "suite.run_suite", 2.1, 2.9, 0),
         (6, 5, 5, "suite.report", 2.5, 2.6, 0),
         (7, None, 7, "suite.run_suite", 3.1, 3.9, 0),     # failed call
         (8, 7, 7, "suite.report", 3.2, 3.8, 0)],
        [(1, "pipeline.buckets", 10, 1.3), (5, "pipeline.buckets", 9, 2.3),
         (7, "pipeline.buckets", 50, 3.3), (5, "ladder.rows", 4, 2.4)])
    monkeypatch.setattr(tracing, "records", lambda: dict(
        spans=rec[0], counts=rec[1], dropped=0))
    assert len(spans.requests(view)) == 2
    assert cells.reader("report_s_per_mp")(view) == pytest.approx(0.4 / 4)
    assert cells.reader("buckets_per_call")(view) == pytest.approx(9.5)


def test_suite_readers_find_nothing_in_a_parents_records(monkeypatch):
    """A program without the suite's request and the bucket counter (the
    parent's): both readers give None, without an error."""
    from pngloss_tpu_torch import tracing

    view, rec = _view([(1, None, 1, "pipeline.compress_many", 1.1, 1.9, 0),
                       (2, 1, 1, "host_encode", 1.5, 1.6, 0)], [])
    monkeypatch.setattr(tracing, "records", lambda: dict(
        spans=rec[0], counts=rec[1], dropped=0))
    for name in ("report_s_per_mp", "buckets_per_call"):
        assert cells.reader(name)(view) is None
    monkeypatch.delattr(tracing, "records")
    for name in ("report_s_per_mp", "buckets_per_call"):
        assert cells.reader(name)(view) is None


def test_tiny_suite_cell_is_correct_and_reads_its_spans(suite_root):
    res = run_cell(suite_root, TINY, trace=1)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert got["report_s_per_mp"]["value"] > 0
    # 8 buckets of the 11 files at this size: girl, lena and parrots
    # share one, dice and redbrush another
    assert got["buckets_per_call"]["value"] == 8
    assert got["encode_concurrency"]["value"] >= 1


def _drop_palette_alpha(monkeypatch):
    """The program reads every palette file as opaque: its decode loses
    tRNS."""
    from pngloss_tpu_torch import codec

    real = codec.decode

    def decode(data, *a, **kw):
        img = real(data, *a, **kw)
        if formats.color_type(data) == 3:
            img.rgba[..., 3] = 255
        return img

    monkeypatch.setattr(codec, "decode", decode)


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered",
                                   "palette_alpha_dropped"])
def test_tiny_suite_cell_with_a_planted_fault_is_not_correct(
        suite_root, monkeypatch, fault):
    if fault == "palette_alpha_dropped":
        _drop_palette_alpha(monkeypatch)
    else:
        _plant(monkeypatch, fault)
    res = run_cell(suite_root, TINY)
    assert not res["correct"], res["checks"]
