"""The port's suite runner on a corpus shaped like upstream's suite/: its
11 files at 1/20 of each side, in all four colour types the command reads
(gray, RGB, RGBA, palette with tRNS), written by the benchmark's own
``suite`` entry. Held byte for byte to ``pngloss_tpu.suite`` and judged
row by row by the benchmark's frozen scalar model (``benchmark/reference``).
Also: the port's codec decode of palette (with and without tRNS) and 8-bit
gray files against ``pngloss_tpu.codec``, and the runner's spans and
bucket counter."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness import cells, traffic
from benchmark.reference import formats, judge, png
from pngloss_tpu import codec as jax_codec
from pngloss_tpu import suite as jax_suite
from pngloss_tpu_torch import codec, pipeline, suite, tracing

SCALE = 20
STRENGTH = 19
TIMING_KEYS = ("mp_per_s", "seconds")


def _suite_entry():
    return cells._module(cells.ROOT, "entries", "suite")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(plan, entry): suite11 at 1/SCALE of each side, 4-px alpha tiles,
    its files written in their colour types."""
    with open(os.path.join(cells.BENCH_DIR, "traffic", "suite11.json")) as fh:
        mix = json.load(fh)
    for g in mix["groups"]:
        g["height"] = max(2, g["height"] // SCALE)
        g["width"] = max(2, g["width"] // SCALE)
    plan = traffic.plan(dict(mix, alpha_tile=4), 2 ** 33 + 17)
    entry = _suite_entry().Entry({"strength": STRENGTH, "bleed": 2}, plan,
                                 str(tmp_path_factory.mktemp("suite")), "cpu")
    return plan, entry


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """{"port": ..., "jax": ...}: (rows, summary, output directory) of each
    package's suite runner on the corpus. The JAX package's runs on a
    second thread meanwhile: its time is mostly XLA's compiles, which
    leave the interpreter free for the port's plain versions."""
    import concurrent.futures

    _, entry = corpus
    out = {k: tmp_path_factory.mktemp(k) for k in ("port", "jax")}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(jax_suite.run_suite, entry.paths, [STRENGTH],
                              out_dir=str(out["jax"]), verbose=False)
        port = suite.run_suite(entry.paths, [STRENGTH],
                               out_dir=str(out["port"]), device="cpu",
                               verbose=False)
        return {"port": (*port, out["port"]),
                "jax": (*jax_run.result(), out["jax"])}


def _outputs(d):
    return {p: (d / p).read_bytes() for p in sorted(os.listdir(d))}


def test_corpus_holds_every_colour_type(corpus):
    _, entry = corpus
    types = []
    for path in entry.paths:
        with open(path, "rb") as fh:
            types.append(formats.color_type(fh.read()))
    assert types == [0, 0, 0, 2, 2, 2, 2, 2, 6, 6, 3]
    with open(entry.paths[-1], "rb") as fh:
        assert b"tRNS" in fh.read()


def test_run_suite_equals_the_jax_suite(runs):
    rows, summary, out = runs["port"]
    want_rows, want, want_out = runs["jax"]
    assert rows == want_rows
    summary, want = dict(summary), dict(want)
    for k in TIMING_KEYS:
        summary.pop(k)
        want.pop(k)
    assert summary == want
    assert not [r for r in rows if "error" in r] and len(rows) == 11
    assert _outputs(out) == _outputs(want_out)
    assert len(_outputs(out)) == 11


def test_outputs_are_the_scalar_models_on_every_row(corpus, runs):
    """Every row of every output judged, and every row searched whole by
    the frozen scalar model: none wrong."""
    plan, entry = corpus
    _, _, out = runs["port"]
    rows = searched = 0
    for i, (im, name) in enumerate(zip(plan.images, entry.names)):
        data = (out / f"{name}-s{STRENGTH}.png").read_bytes()
        res = judge.first_pass(dict(index=i, original=im, output=data,
                                    mode="cli", strength=STRENGTH, bleed=2,
                                    full_rows=im.shape[0], seed=[7, 0, i]))
        assert not res["malformed"], (name, res.get("why"))
        assert res["wrong"] == 0, (name, res["first_wrong"])
        assert len(res["states"]) == im.shape[0]
        for st in res["states"]:
            assert judge.search((st, STRENGTH, "cli")), (name, st["y"])
        rows += res["rows"]
        searched += len(res["states"])
    assert rows == searched == sum(im.shape[0] for im in plan.images)


# ---- the codec's decode of palette and gray files


def _palette_rgba(h, w, seed, transparent):
    """Pixels of at most 256 (colour, alpha) entries: a palette image,
    with one fully transparent entry where ``transparent``."""
    rng = np.random.default_rng(seed)
    colors = rng.integers(0, 256, (40, 3)).astype(np.uint8)
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :3] = colors[rng.integers(0, 40, (h, w))]
    if transparent:
        rgba[rng.random((h, w)) < 0.3] = 0
    return rgba


# a few of upstream's suite shapes (H, W): rose, david, tux
SHAPES = [(46, 70), (215, 180), (314, 265)]
FORMATS = ("palette_trns", "palette", "gray")


def _file(kind, h, w):
    if kind == "gray":
        rng = np.random.default_rng(h)
        y, x = np.mgrid[0:h, 0:w]
        gray = ((x + y) * 255 // (h + w) + rng.integers(-9, 10, (h, w)))
        return formats.write_gray(np.clip(gray, 0, 255).astype(np.uint8))
    rgba = _palette_rgba(h, w, h + w, kind == "palette_trns")
    return formats.write_palette(*formats.palette_of(rgba))


@pytest.mark.parametrize("kind", FORMATS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_codec_decodes_like_the_original(kind, shape):
    """The port's codec (its default route and its pure-Python one) and the
    JAX package's give the same RGBA, gamma, transform and chunks, and the
    pixels the plain reader reads."""
    data = _file(kind, *shape)
    assert formats.color_type(data) == (0 if kind == "gray" else 3)
    assert (b"tRNS" in data) == (kind == "palette_trns")
    want = jax_codec.decode(data)
    np.testing.assert_array_equal(want.rgba, formats.read_rgba(data))
    for mine in (codec.decode(data), codec.pypng.decode(data),
                 jax_codec.pypng.decode(data)):
        np.testing.assert_array_equal(mine.rgba, want.rgba)
        assert (mine.gamma, mine.color_transform) == (
            want.gamma, want.color_transform)
        assert [(c.name, c.data) for c in mine.chunks] == [
            (c.name, c.data) for c in want.chunks]
    assert codec.detect_colorspace(want.rgba) == \
        jax_codec.detect_colorspace(want.rgba)


# ---- the runner's spans and counter


def _tiny_files(tmp_path):
    rng = np.random.default_rng(48)
    paths = []
    for k, (h, w) in enumerate(((4, 5), (3, 9))):
        rgba = rng.integers(0, 256, (h, w, 4), np.uint8)
        rgba[..., 3] = 255
        paths.append(str(tmp_path / f"f{k}.png"))
        with open(paths[-1], "wb") as fh:
            fh.write(png.write(rgba[..., :3]))
    return paths


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_run_suite_is_one_request_with_compress_many_under_it(tmp_path):
    """suite.run_suite is the request: the reads, compress_many, each job's
    report and write are its children, and the buckets of its one
    dispatch, and its two images' encodes as not streamed (two images a
    call), are counted to it."""
    paths = _tiny_files(tmp_path)
    first = max((s.id for s in tracing.records()["spans"]), default=0)
    with _profiled():
        suite.run_suite(paths, [19], out_dir=str(tmp_path / "o"),
                        device="cpu", verbose=False)
    spans = [s for s in tracing.records()["spans"] if s.id > first]
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "suite.run_suite" and root.request == root.id
    assert all(s.request == root.id for s in spans)
    children = {}
    for s in spans:
        if s.parent == root.id:
            children[s.name] = children.get(s.name, 0) + 1
    assert children == {"host_read": 1, "pipeline.compress_many": 1,
                        "suite.report": 2, "host_write": 2}
    (many,) = [s for s in spans if s.name == "pipeline.compress_many"]
    assert {s.parent for s in spans if s.name in ("host_decode",
                                                  "host_encode")} == {
        many.id}
    order = sorted((s.t0, s.name) for s in spans if s.parent == root.id)
    assert order[0][1] == "host_read" and order[1][1] == "pipeline.compress_many"
    counts = [(c.name, c.n) for c in tracing.records()["counts"]
              if c.request == root.id]
    assert counts == [("pipeline.buckets", 2), ("encode.streamed", 0),
                      ("encode.streamed", 0)]


def test_run_suite_records_nothing_untraced(tmp_path, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function opened with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    paths = _tiny_files(tmp_path)
    before = tracing.records()
    assert not tracing.on()
    rows, _ = suite.run_suite(paths, [19], out_dir=str(tmp_path / "o"),
                              device="cpu", verbose=False)
    assert tracing.records() == before
    assert len(rows) == 2 and sorted(os.listdir(tmp_path / "o")) == [
        "f0-s19.png", "f1-s19.png"]
    assert pipeline.tracing is tracing
