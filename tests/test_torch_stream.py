"""A one-image call in bands: its rows run band by band and its PNG is
encoded as they land, with the bytes of one launch and one encode.

* ``ops/image.image_rows``' carry-out: band by band, each band from the
  state the one before it left, equals one call (the plain version here,
  the split kernel on the card);
* ``pipeline``: a one-image ``compress_many`` in bands, with its encode
  streamed, equals the one-shot bytes; an output whose colour type
  collapses (all gray, all opaque) is encoded one-shot and counted;
  ``skip_if_larger`` raises ``TooLargeFile`` as before;
* ``codec.stream.EncodeStream`` against ``codec.native.encode`` for every
  bpp and random band splits; where the deflate clone is off
  (``PNGLOSS_NO_FAST_DEFLATE=1``) no stream begins and ``finish`` gives
  ``encode``'s bytes one-shot.

No JAX here: the card's tests run in this file too
(``PNGLOSS_TEST_TPU=1 python -m pytest tests/test_torch_stream.py``).
"""

import numpy as np
import pytest
import torch

from pngloss_tpu_torch import codec, pipeline, tracing
from pngloss_tpu_torch.codec import native
from pngloss_tpu_torch.codec import stream as stream_codec
from pngloss_tpu_torch.ops import image

H, W = 13, 7                                     # an odd width


def _state(b, bpp, device, seed):
    """``image_rows``' positional arguments for b images of H x W at bpp
    from a mid-image state, transparent pixels at bpp 2 and 4."""
    rng = np.random.default_rng(seed + 100 * bpp)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    img = rng.integers(0, 256, (b, H, W, bpp), dtype=np.uint8)
    img[:, 3:6, 2:5] = img[:, 3:4, 2:3]          # a flat patch
    if bpp % 2 == 0:
        img[:, 1::2, ::3, bpp - 1] = 0
    return (i32([19, 40][:b]), 2, i32([W, W - 2][:b]),
            i32(rng.integers(0, 40, (b, 5, 256))),
            torch.as_tensor(img.reshape(b, H, W * bpp), device=device),
            i32(rng.integers(0, 256, (b, W, bpp))),
            i32(rng.integers(-40, 41, (b, W + 5, 4))),
            i32(rng.integers(-40, 41, (b, W + 5, 4))),
            i32(rng.integers(0, 40, (b, 256))))


def _banded(run, args, h_real, band):
    """Rows 1..H-1 of ``args`` through ``run`` (``image_rows`` or its plain
    version) band by band, each from the carry of the band before it:
    (qrows, filt, the last carry)."""
    s, bleed, w_real, ofreq, rows, *carry = args
    qs, fs = [], []
    for lo in range(1, H, band):
        hi = min(lo + band, H)
        hr = (h_real - (lo - 1)).clamp(1, hi - lo + 1)
        q, f, carry = run(s, bleed, w_real, ofreq, rows[:, lo - 1:hi],
                          *carry, h_real=hr, carry_out=True)
        qs.append(q)
        fs.append(f)
    return torch.cat(qs, 1), torch.cat(fs, 1), carry


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


@pytest.mark.parametrize("band", [1, 2, 7])
@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_plain_version_band_by_band_is_one_call(bpp, band):
    """Two images, one of them ending at row 9 of 13 (h_real < H): the
    bands' rows, filters and last carry equal one call's, the rows past
    h_real 0 in both."""
    args = _state(2, bpp, "cpu", seed=band)
    h_real = torch.tensor([H, 9], dtype=torch.int32)
    want = image.image_rows_ref(*args, h_real=h_real, carry_out=True)
    got = _banded(image.image_rows_ref, args, h_real, band)
    _same(got[:2], want[:2])
    _same(got[2], want[2])
    assert not want[0][1, 8:].any() and not want[1][1, 8:].any()
    # the carry is the last real row's state: its row is that row
    _same([want[2][0][0], want[2][0][1]], [want[0][0, -1], want[0][1, 7]])


def test_carry_out_is_cli_modes():
    with pytest.raises(ValueError, match="carry_out"):
        image.image_rows(*_state(1, 3, "cpu", 0), adaptive=True,
                         carry_out=True)


def _png(h, w, bpp, seed, gray=False, opaque=False):
    """A PNG of h x w whose working plane takes ``bpp`` bytes a pixel."""
    rng = np.random.default_rng(seed)
    rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    rgba[::3] //= 16
    if bpp in (1, 2) or gray:
        rgba[..., 0] = rgba[..., 2] = rgba[..., 1]
    if bpp in (1, 3) or opaque:
        rgba[..., 3] = 255
    return codec.encode(rgba, row_filters=None)


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _counts(first):
    """Counter totals of the requests whose root span came after id
    ``first``."""
    roots = {s.id for s in tracing.records()["spans"]
             if s.id > first and s.parent is None}
    got = {}
    for c in tracing.records()["counts"]:
        if c.request in roots:
            got[c.name] = got.get(c.name, 0) + c.n
    return got


def _last_id():
    return max((s.id for s in tracing.records()["spans"]), default=0)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_compress_many_in_bands_gives_the_one_shot_bytes(monkeypatch, bpp):
    """One image in bands of 3 rows (``band_rows`` forced small), its
    encode streamed: the bytes of one launch and ``finish``'s one-shot
    encode; counted as streamed, with no fallback."""
    png = _png(14, 7, bpp, seed=bpp)
    prep = pipeline.prepare(png)
    (whole,) = pipeline.dispatch_buckets([prep.work], [prep.bpp], 19,
                                         device="cpu")
    assert not whole.bands
    (q,), (f,) = pipeline.collect_bucket(whole)
    want = pipeline.finish(prep, q, f)
    monkeypatch.setattr(pipeline, "band_rows", lambda wb: 3)
    (banded,) = pipeline.dispatch_buckets([prep.work], [prep.bpp], 19,
                                          device="cpu")
    assert [y for y, _ in banded.bands] == [3, 6, 9, 12, 14]
    first = _last_id()
    with _profiled():
        (got,) = pipeline.compress_many([png], 19, device="cpu")
    assert got.unwrap() == want
    assert _counts(first) == {"pipeline.buckets": 1, "encode.streamed": 1}


def _fallback(bpp, collapse):
    """``finish`` of a plane of ``bpp`` whose output collapses
    (``collapse`` turns the optimized plane gray or opaque), once with a
    stream fed in bands and once one-shot: (streamed, one-shot, counts)."""
    png = _png(21, 8, bpp, seed=10 + bpp)
    prep = pipeline.prepare(png)
    assert prep.bpp == bpp
    (p,) = pipeline.dispatch_buckets([prep.work], [prep.bpp], 19,
                                     device="cpu")
    (q,), (f,) = pipeline.collect_bucket(p)
    q = collapse(q.reshape(q.shape[0], -1, bpp).copy()).reshape(q.shape)
    want = pipeline.finish(prep, q, f)
    first = _last_id()
    with _profiled(), tracing.request("test.finish"):
        got = pipeline.finish(prep, q, f, landing=iter([4, 8, 12, 16, 20,
                                                        21]))
    return got, want, _counts(first)


def _gray(px):
    px[..., 0] = px[..., 2] = px[..., 1]
    return px


def _opaque(px):
    px[..., -1] = 255
    return px


@pytest.mark.parametrize("bpp,collapse", [(3, _gray), (4, _opaque),
                                          (4, _gray), (2, _opaque)])
def test_an_output_of_another_colour_type_is_encoded_one_shot(bpp,
                                                              collapse):
    got, want, counts = _fallback(bpp, collapse)
    assert got == want
    assert counts == {"encode.streamed": 1, "encode.stream_fallbacks": 1}


def test_skip_if_larger_raises_as_before(monkeypatch):
    """An input the optimizer cannot shrink (a flat image at -s 0): the
    same ``TooLargeFile``, with the same oversized bytes, in bands and
    in one launch."""
    rgba = np.full((40, 6, 4), 7, np.uint8)
    rgba[..., 3] = 255
    png = codec.encode(rgba, row_filters=None)
    (one,) = pipeline.compress_many([png], 0, device="cpu",
                                    skip_if_larger=True)
    monkeypatch.setattr(pipeline, "band_rows", lambda wb: 5)
    (banded,) = pipeline.compress_many([png], 0, device="cpu",
                                       skip_if_larger=True)
    for r in (one, banded):
        assert isinstance(r.error, codec.TooLargeFile) and r.data is None
    assert banded.error.data == one.error.data
    assert str(banded.error) == str(one.error)


def _splits(rng, h):
    """Random band ends over h rows: bands of one row, and bands past
    32 KiB of filtered rows."""
    ends, y = [], 0
    while y < h:
        y = min(h, y + int(rng.choice([1, 2, 7, 150])))
        ends.append(y)
    return ends


@pytest.mark.parametrize("zlib", [False, True])
@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_encode_stream_is_encode(monkeypatch, bpp, zlib):
    """``EncodeStream`` over random band splits equals ``encode`` of the
    plane restored to RGBA, with the input's gamma and chunks. Where the
    deflate clone is off (``zlib``: ``PNGLOSS_NO_FAST_DEFLATE=1``, under
    which ``encode`` deflates through the system zlib) no stream begins,
    and ``finish`` of rows that land in bands encodes them one-shot, with
    ``encode``'s bytes."""
    if zlib:
        monkeypatch.setenv("PNGLOSS_NO_FAST_DEFLATE", "1")
    rng = np.random.default_rng(50 + bpp)
    chunks = [codec.Chunk(name=b"tEXt", data=b"k\x00v", location=1),
              codec.Chunk(name=b"zTXt", data=b"z\x00\x00x", location=8)]
    for h, w in ((1, 5), (2, 1), (37, 11), (300, 61)):
        work = rng.integers(0, 256, (h, w * bpp), dtype=np.uint8)
        work[h // 3:] //= 8                             # runs to match
        if bpp % 2 == 0:
            work.reshape(h, w, bpp)[:, 1::2, bpp - 1] = 255
        filters = rng.integers(0, 5, h).astype(np.int8)
        rgba = pipeline.restore_colorspace(work, bpp, w)
        want = native.encode(rgba, row_filters=filters, gamma=0.5,
                             color_transform="srgb", chunks=chunks)
        ends = _splits(rng, h)
        if zlib:
            assert stream_codec.begin(w, h, bpp, 0.5, "srgb", chunks) is None
            img = codec.DecodedImage(rgba=rgba, gamma=0.5,
                                     color_transform="srgb", chunks=chunks)
            prep = pipeline.Prepared(b"", img, work, bpp)
            got = pipeline.finish(prep, work, filters, landing=iter(ends))
        else:
            with stream_codec.begin(w, h, bpp, 0.5, "srgb", chunks) as st:
                y = 0
                for y1 in ends:
                    st.rows(work[y:y1], filters[y:y1])
                    y = y1
                got = st.end()
        assert got == want, (h, w)


def test_encode_stream_checks_its_rows():
    with stream_codec.begin(4, 3, 2) as st:
        with pytest.raises(ValueError, match="do not fit"):
            st.rows(np.zeros((1, 7), np.uint8), np.zeros(1, np.int8))
        st.rows(np.zeros((2, 8), np.uint8), np.zeros(2, np.int8))
        with pytest.raises(ValueError):
            st.rows(np.zeros((2, 8), np.uint8), np.zeros(2, np.int8))
    with stream_codec.begin(4, 3, 2) as st:
        st.rows(np.zeros((2, 8), np.uint8), np.zeros(2, np.int8))
        with pytest.raises(ValueError, match="last row"):
            st.end()


# --- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("band", [1, 2, 7])
@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_split_kernel_band_by_band_is_one_launch(cuda, bpp, band):
    """The split kernel's carry-out: its bands equal its one launch and
    the plain version's one call (rows, filters, carry)."""
    args = _state(1, bpp, cuda, seed=band)
    h_real = torch.tensor([H], dtype=torch.int32, device=cuda)
    assert image.takes_split(1, bpp, cuda)
    got = _banded(image.image_rows, args, h_real, band)
    one = image.image_rows(*args, h_real=h_real, carry_out=True)
    cpu = [t.cpu() if torch.is_tensor(t) else t
           for t in _state(1, bpp, "cpu", seed=band)]
    want = image.image_rows_ref(*cpu, h_real=h_real.cpu(), carry_out=True)
    for g in (got, one):
        _same(g[:2], want[:2])
        _same(g[2], want[2])
