"""Every cell's inputs: drawn from the seed alone, at the stated sizes,
working formats and counts, and read back from the PNGs the harness
writes for them."""

import json
import os

import numpy as np
import pytest

from benchmark.harness import cells, traffic
from benchmark.reference import png, scalar

with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as _fh:
    SPEC = json.load(_fh)
CELLS = [w["name"] for w in SPEC["workloads"]]
# (count, height, width, working bpp) of each cell's images
EXPECTED = {
    "cli_s19.screenshot": [(4, 1080, 1920, 3)],
    "cli_s19.kodak24": [(18, 512, 768, 3), (6, 768, 512, 3)],
    "embed_s19.assets_textured": [(16, 256, 256, 4)],
    "embed_s19.assets_flat": [(16, 256, 256, 4)],
}


def test_every_cell_is_listed_here():
    assert sorted(CELLS) == sorted(EXPECTED)


@pytest.mark.parametrize("cell", CELLS)
def test_inputs_follow_the_seed(cell):
    mix = cells.load(cell).mix
    seed = 2 ** 31 + 99
    a, b = traffic.plan(mix, seed), traffic.plan(mix, seed)
    assert a.order == b.order
    assert all(np.array_equal(x, y) for x, y in zip(a.images, b.images))
    c = traffic.plan(mix, seed + 1)
    assert not all(np.array_equal(x, y) for x, y in zip(a.images, c.images))
    shapes = {}
    for im in a.images:
        assert im.dtype == np.uint8 and im.shape[2] == 4
        key = (im.shape[0], im.shape[1], scalar.reduce_colorspace(im)[1])
        shapes[key] = shapes.get(key, 0) + 1
    assert shapes == {(h, w, bpp): n for n, h, w, bpp in EXPECTED[cell]}
    # every call takes per_call images, and all are used in turn
    calls = [a.call(k) for k in range(len(a.images))]
    assert all(len(ids) == mix["per_call"] for ids in calls)
    assert sorted({i for ids in calls for i in ids}) == list(
        range(len(a.images)))


def test_negative_and_huge_seeds():
    mix = cells.load("embed_s19.assets_flat").mix
    for seed in (-5, 0, 2 ** 40 + 3, 2 ** 70):
        assert len(traffic.plan(mix, seed).images) == 16


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_writer_round_trip(channels):
    rng = np.random.default_rng(channels)
    px = rng.integers(0, 256, (9, 13, channels)).astype(np.uint8)
    px[3:6] = px[3]                       # rows that UP and SUB favour
    rows, filters, ctype = png.read(png.write(px))
    assert ctype == {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    assert np.array_equal(rows, px.reshape(9, -1))
    assert set(filters.tolist()) <= set(range(5))


def test_png_reader_refuses_damage():
    data = bytearray(png.write(np.zeros((4, 4, 3), np.uint8)))
    data[40] ^= 0xFF
    with pytest.raises(png.PngError):
        png.read(bytes(data))
    with pytest.raises(png.PngError):
        png.read(b"not a png")
