"""CLI mode's two layouts of the image kernel.

On the CPU: the layout rule ``ops/image.pick_split`` as a pure function of
the images in flight, the resident clusters and the SM count, and the
in-flight count that ``pipeline.dispatch_buckets`` hands every bucket's
image stage (all the call's images, in CLI mode only).

On the card (marked ``cuda``, skipped without one; this file imports no
JAX, so it runs there as ``PNGLOSS_TEST_TPU=1 python -m pytest
tests/test_torch_split.py -q``): the split layout (a cluster of 2 SMs an
image, filters 0-3 on one, filter 4 on the other) against the one-block
kernel and the
plain version ``image_rows_ref``, byte for byte, at bpp 1-4, -s 19 and 40
(the wide-band loop), ragged real widths and heights (1 and 2 among
them), B = 1 and 2 in one launch, and a B that falls back to the one-block
kernel; and the ``image.images`` and ``image.split`` counters against what
was launched.
"""

import numpy as np
import pytest
import torch

from pngloss_tpu_torch import codec, pipeline, tracing
from pngloss_tpu_torch.ops import image

# the most images any card keeps in flight at once (forces one block)
ONE_BLOCK = 1 << 20


@pytest.mark.parametrize("buckets,resident,sms,want", [
    ([1], 66, 132, True),                 # fits
    ([66], 66, 132, True),                # exactly full: clusters and SMs
    ([61], 60, 132, False),               # one image over the clusters
    ([67], 70, 132, False),               # one image over the SMs
    ([1], 0, 132, False),                 # no cluster stays resident
    ([40, 30], 66, 132, False),           # two buckets: each fits alone
])
def test_pick_split(buckets, resident, sms, want):
    assert image.pick_split(sum(buckets), resident, sms) == want
    if len(buckets) > 1:                  # each bucket alone would fit
        assert all(image.pick_split(n, resident, sms) for n in buckets)
    assert not image.pick_split(0, resident, sms)


def _pngs(seed, shapes):
    rng = np.random.default_rng(seed)
    return [codec.encode(rng.integers(0, 256, (h, w, 4), dtype=np.uint8))
            for h, w in shapes]


@pytest.mark.parametrize("use_row_filters", [True, False])
def test_every_bucket_is_told_the_calls_images(monkeypatch,
                                               use_row_filters):
    """Three shape buckets of 2, 1 and 2 images: each bucket's image stage
    is told the call's 5 images in CLI mode, and nothing in embedding
    mode, where the ladder runs."""
    seen = []
    real = image.image_rows

    def record(*args, in_flight=None, **kw):
        seen.append((args[4].shape[0], in_flight))
        return real(*args, in_flight=in_flight, **kw)

    monkeypatch.setattr(image, "image_rows", record)
    pngs = _pngs(7, [(6, 9), (6, 9), (12, 5), (5, 20), (5, 20)])
    works, bpps = zip(*(pipeline.reduce_colorspace(codec.decode(p).rgba)
                        for p in pngs))
    pending = pipeline.dispatch_buckets(list(works), list(bpps), 19,
                                        use_row_filters=use_row_filters,
                                        device="cpu")
    assert sorted(len(p.idxs) for p in pending) == [1, 2, 2]
    assert sorted(b for b, _ in seen) == [1, 2, 2]
    assert {n for _, n in seen} == {5 if use_row_filters else None}


def test_in_flight_is_cli_modes():
    with pytest.raises(ValueError, match="in_flight"):
        image.image_rows(*_inputs(1, 3, [H], [W], 19, "cpu")[0],
                         adaptive=True, in_flight=4)


# --- on the card ---------------------------------------------------------

H, W = 6, 37


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(b, bpp, heights, widths, s, device, seed=0):
    """A mid-image state of b images of H x W at bpp, real sizes
    ``heights`` x ``widths``, transparent pixels at bpp 2 and 4:
    ``image_rows``' positional arguments, and h_real."""
    rng = np.random.default_rng(seed + 1000 * bpp + s)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    img = rng.integers(0, 256, (b, H, W, bpp), dtype=np.uint8)
    img[:, 2:4, 10:20] = img[:, 2:3, 10:11]         # a flat patch
    if bpp % 2 == 0:
        img[:, 1::2, ::3, bpp - 1] = 0
    args = (i32([s] * b), 2, i32(widths),
            i32(rng.integers(0, 40, (b, 5, 256))),
            torch.as_tensor(img.reshape(b, H, W * bpp), device=device),
            i32(rng.integers(0, 256, (b, W, bpp))),
            i32(rng.integers(-40, 41, (b, W + 5, 4))),
            i32(rng.integers(-40, 41, (b, W + 5, 4))),
            i32(rng.integers(0, 40, (b, 256))))
    return args, i32(heights)


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("heights,widths", [
    ([H], [W]), ([1], [W - 5]), ([2], [W - 2]),
    ([H - 1, 2], [W, W - 9]), ([1, H], [W - 4, W]),
])
@pytest.mark.parametrize("s", [19, 40])
@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_split_matches_one_block_and_plain(cuda, bpp, s, heights, widths):
    b = len(heights)
    args, h_real = _inputs(b, bpp, heights, widths, s, cuda)
    cpu_args, cpu_h = _inputs(b, bpp, heights, widths, s, "cpu")
    assert image.takes_split(b, bpp, cuda)
    before = image.SPLIT_LAUNCHES
    split = image.image_rows(*args, h_real=h_real)
    assert image.SPLIT_LAUNCHES == before + 1
    one = image.image_rows(*args, h_real=h_real, in_flight=ONE_BLOCK)
    assert image.SPLIT_LAUNCHES == before + 1
    _same(split, one)
    _same(split, image.image_rows_ref(*cpu_args, h_real=cpu_h))


@pytest.mark.cuda
@pytest.mark.parametrize("bpp", [1, 3])
def test_a_launch_that_does_not_fit_takes_one_block(cuda, bpp):
    """One image more than the SMs take at SPLIT_SMS a cluster: the
    one-block kernel, equal to the plain version."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    b = sms // image.SPLIT_SMS + 1
    heights = [1 + k % H for k in range(b)]
    widths = [W - k % 9 for k in range(b)]
    args, h_real = _inputs(b, bpp, heights, widths, 19, cuda)
    cpu_args, cpu_h = _inputs(b, bpp, heights, widths, 19, "cpu")
    assert not image.takes_split(b, bpp, cuda)
    before = image.SPLIT_LAUNCHES, image.LAUNCHES
    got = image.image_rows(*args, h_real=h_real)
    assert (image.SPLIT_LAUNCHES, image.LAUNCHES) == (before[0],
                                                      before[1] + 1)
    _same(got, image.image_rows_ref(*cpu_args, h_real=cpu_h))


@pytest.mark.cuda
def test_counters_count_what_was_launched(cuda):
    """Inside a request, while a profiler records: a launch of 2 images
    that takes the split layout, one told of more images in flight than
    fit, and an embedding-mode launch, which counts nothing."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    args, h_real = _inputs(2, 3, [H, 3], [W, W - 1], 19, cuda)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.on()
        with tracing.request("test.split"):
            before = image.SPLIT_LAUNCHES
            image.image_rows(*args, h_real=h_real)
            image.image_rows(*args, h_real=h_real, in_flight=sms)
            image.image_rows(*args, h_real=h_real, adaptive=True,
                             retry=True)
            split_launches = image.SPLIT_LAUNCHES - before
    torch.cuda.synchronize()
    req = [s for s in tracing.records()["spans"]
           if s.name == "test.split"][-1].id
    counts = {}
    for c in tracing.records()["counts"]:
        if c.request == req:
            counts[c.name] = counts.get(c.name, 0) + c.n
    assert split_launches == 1
    assert counts == {"image.images": 4, "image.split": 2}
