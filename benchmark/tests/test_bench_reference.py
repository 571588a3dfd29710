"""The benchmark's frozen reference: equal to the port's scalar model; its
faster row search equal to the frozen model, in C's division and in the
control's floor division; its check accepts the scalar model's outputs
and refuses altered ones, rows kept at too low a strength, and the
control's outputs; the plain PNG reader reads the port's encoder."""

import numpy as np
import pytest

from benchmark.reference import check, judge, png, rowsearch, scalar
from pngloss_tpu_torch import codec
from pngloss_tpu_torch import reference as port_reference


def image(rng, h, w, bpp):
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :3] = rng.integers(0, 256, (h, w, 3))
    if bpp in (1, 2):
        rgba[..., 0] = rgba[..., 2] = rgba[..., 1]
    if bpp in (2, 4):
        rgba[::3, ::2, 3] = 0
        rgba[1::3, 1::2, 3] = 128
    return rgba


CASES = [(bpp, rows, s) for bpp in (1, 2, 3, 4) for rows in (True, False)
         for s in (0, 19, 90)]


@pytest.mark.parametrize("bpp,use_row_filters,strength", CASES)
def test_frozen_model_equals_the_ports(bpp, use_row_filters, strength):
    rgba = image(np.random.default_rng(bpp * 7 + strength), 7, 9, bpp)
    got = scalar.optimize_rgba(rgba, strength, 2, use_row_filters)
    want = port_reference.optimize_rgba(rgba, strength, 2, use_row_filters)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("bpp,use_row_filters,strength", CASES)
def test_check_accepts_the_model_and_refuses_changes(bpp, use_row_filters,
                                                     strength):
    rgba = image(np.random.default_rng(bpp + strength), 8, 10, bpp)
    work, b, _, _ = scalar.reduce_colorspace(rgba)
    assert b == bpp
    q, f = scalar.optimize_image(work, bpp, strength, 2, use_row_filters)
    assert np.array_equal(rowsearch.original_frequencies(work, bpp),
                          scalar.original_frequencies(work, bpp))
    filters = f if use_row_filters else check.msad_filters(q, bpp)
    assert np.array_equal(filters, f)
    mode = "first" if use_row_filters else "all"
    walk = check.Walk(work, q, filters, bpp, 2)
    assert len(check.judge_rows(walk, strength, mode, keep=range(8))) == 0
    for y in range(8):
        assert check.search_row(check.row_state(walk, y), strength,
                                not use_row_filters or y == 0)
    bad = q.copy()
    bad[5, 3] ^= 0x21
    walk = check.Walk(work, bad, filters, bpp, 2)
    assert 5 in check.judge_rows(walk, strength, mode, keep={5})
    assert not check.search_row(check.row_state(walk, 5), strength,
                                not use_row_filters)


@pytest.mark.parametrize("bpp,use_row_filters,strength", CASES)
@pytest.mark.parametrize("division", ["trunc", "floor"])
def test_row_search_equals_the_frozen_model(monkeypatch, bpp,
                                            use_row_filters, strength,
                                            division):
    rgba = image(np.random.default_rng(bpp * 5 + strength), 7, 9, bpp)
    work, _, _, _ = scalar.reduce_colorspace(rgba)
    if division == "floor":
        monkeypatch.setattr(scalar, "trunc_div", lambda a, b: a // b)
    want = scalar.optimize_image(work, bpp, strength, 2, use_row_filters)
    got = rowsearch.optimize_image(work, bpp, strength, 2, use_row_filters,
                                   division)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("mode", ["cli", "embed"])
def test_control_output_is_judged_wrong(mode):
    rgba = image(np.random.default_rng(3), 8, 12, 4 if mode == "embed"
                 else 3)
    task = dict(original=rgba, output=None, mode=mode, strength=19,
                bleed=2, full_rows=3, seed=[1], control=True)
    res = judge.first_pass(task)
    searched_wrong = sum(not judge.search((st, 19, mode))
                         for st in res["states"])
    assert res["malformed"] == 0
    assert res["wrong"] + searched_wrong > 0


def test_rows_kept_at_too_low_a_strength_are_searched():
    """Embedding mode accepts a row at any strength whose picks it
    matches; every row that matches only below the configuration's
    strength is searched whole, and there the higher strength wins."""
    rgba = image(np.random.default_rng(9), 10, 12, 4)
    q, _ = scalar.optimize_rgba(rgba, 15, 2, False)
    res = judge.first_pass(dict(original=rgba, output=q, mode="embed",
                                strength=19, bleed=2, full_rows=0,
                                seed=[2], control=False))
    assert res["wrong"] == 0 and res["fell_back"] > 0
    assert len(res["states"]) >= res["fell_back"]
    assert not all(judge.search((st, 19, "embed")) for st in res["states"])


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_plain_reader_reads_the_ports_encoder(bpp):
    rgba = image(np.random.default_rng(bpp), 11, 13, bpp)
    q, f = scalar.optimize_rgba(rgba, 19, 2, True)
    data = codec.encode(q, row_filters=f)
    rows, filters, ctype = png.read(data)
    assert ctype == {1: 0, 2: 4, 3: 2, 4: 6}[bpp]
    assert np.array_equal(judge.to_rgba(rows, ctype, 13), q)
    assert np.array_equal(filters[1:], f[1:])


def test_first_pass_judges_a_png():
    rgba = image(np.random.default_rng(5), 9, 11, 3)
    q, f = scalar.optimize_rgba(rgba, 19, 2, True)
    task = dict(original=rgba, output=codec.encode(q, row_filters=f),
                mode="cli", strength=19, bleed=2, full_rows=3, seed=[1],
                control=False)
    res = judge.first_pass(task)
    assert res["malformed"] == 0 and res["wrong"] == 0
    assert all(judge.search((st, 19, "cli")) for st in res["states"])
    res = judge.first_pass(dict(task, output=task["output"][:-20]))
    assert res["malformed"] == 1
