"""The port's dispatch of shape buckets, on the CPU.

``pipeline.dispatch_buckets`` queues the buckets longest chain first, each
on the stream of its slot in its device's pool (``parallel.mesh``), and
``compress_many`` encodes each bucket as its copy lands (``landed``). None
of that may change a byte: the output equals ``pngloss_tpu.pipeline``'s
whatever the pool size and the order. On the CPU there are no streams, so
these tests hold the order, the slots and the drain; the card tests
(``tests/test_torch_cuda.py``) hold the streams.
"""

import random
import types

import numpy as np
import pytest

from pngloss_tpu import pipeline as jax_pipeline
from pngloss_tpu.codec import encode
from pngloss_tpu_torch import pipeline, tracing
from pngloss_tpu_torch.parallel import mesh

STRENGTHS = (19, 0, 40, 3)


def _corpus():
    """Ragged PNGs of 8-24 px a side in the four colour types (bpp 1-4),
    in at least 6 buckets of the pad ladder, and their strengths."""
    rng = np.random.default_rng(88)
    pngs, strengths = [], []
    for k in range(12):
        h, w = (int(v) for v in rng.integers(8, 25, 2))
        rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        if k % 4 < 2:                                   # gray, gray+alpha
            rgba[..., 0] = rgba[..., 2] = rgba[..., 1]
        if k % 2 == 0:                                  # gray, RGB
            rgba[..., 3] = 255
        pngs.append(encode(rgba, row_filters=None))
        strengths.append(STRENGTHS[k % len(STRENGTHS)])
    return pngs, strengths


def _bucket_keys(pngs):
    from pngloss_tpu_torch import codec

    keys = []
    for png in pngs:
        work, bpp = pipeline.reduce_colorspace(codec.decode(png).rgba)
        h, wb = work.shape
        keys.append((pipeline.pad_dim(h), pipeline.pad_dim(wb // bpp) * bpp,
                     bpp))
    return keys


def _bytes(results):
    return [r.unwrap() for r in results]


@pytest.fixture(scope="module")
def corpus():
    pngs, strengths = _corpus()
    assert len(set(_bucket_keys(pngs))) >= 6
    return pngs, strengths, _bytes(pipeline.compress_many(pngs, strengths,
                                                          device="cpu"))


def test_compress_many_matches_jax_over_ragged_buckets(corpus):
    pngs, strengths, got = corpus
    want = _bytes(jax_pipeline.compress_many(pngs, strengths))
    assert got == want


@pytest.mark.parametrize("order,pool", [("reversed", 1), ("reversed", 4),
                                        ("shuffled", 1), ("shuffled", 4)])
def test_bytes_do_not_depend_on_order_or_pool(corpus, monkeypatch, order,
                                              pool):
    pngs, strengths, want = corpus
    shuffle = random.Random(5).shuffle

    def reorder(keys):
        keys = list(keys)
        if order == "reversed":
            keys.reverse()
        else:
            shuffle(keys)
        return keys

    monkeypatch.setattr(pipeline, "dispatch_order", reorder)
    monkeypatch.setattr(mesh, "STREAMS", pool)
    assert _bytes(pipeline.compress_many(pngs, strengths,
                                         device="cpu")) == want


def test_buckets_dispatch_longest_chain_first(corpus, monkeypatch):
    """Each bucket goes to the device in order of its chain, h_pad * w_pad
    * bpp, longest first, the k-th with slot k; the pending buckets come
    back in the order their shapes first appear (as the JAX package's)."""
    pngs = corpus[0]
    from pngloss_tpu_torch import codec

    works, bpps = zip(*(pipeline.reduce_colorspace(codec.decode(p).rgba)
                        for p in pngs))
    calls = []
    real = pipeline.optimize_batch_sharded

    def record(batch, *args, slot=None, **kw):
        calls.append((batch.shape[1] * batch.shape[2], slot))
        return real(batch, *args, slot=slot, **kw)

    monkeypatch.setattr(pipeline, "optimize_batch_sharded", record)
    pending = pipeline.dispatch_buckets(list(works), list(bpps), 19,
                                        device="cpu")
    chains = [c for c, _ in calls]
    assert chains == sorted(chains, reverse=True) and len(set(chains)) > 2
    assert [slot for _, slot in calls] == list(range(len(calls)))
    first_seen = list(dict.fromkeys(_bucket_keys(pngs)))
    assert [(p.q.shape[1], p.q.shape[2], p.bpp) for p in pending] == \
        first_seen
    assert pipeline.dispatch_order([(8, 24, 3), (16, 16, 1), (8, 64, 4),
                                    (24, 16, 2), (16, 24, 1)]) == [
        (8, 64, 4), (24, 16, 2), (16, 24, 1), (16, 16, 1), (8, 24, 3)]


class _Event:
    """An event that completes after ``polls`` queries."""

    def __init__(self, polls):
        self.polls = polls

    def query(self):
        self.polls -= 1
        return self.polls < 0


def test_drain_takes_the_bucket_that_landed_first(monkeypatch):
    monkeypatch.setattr(pipeline, "POLL_S", 0.0)
    slow = types.SimpleNamespace(name="slow", done=[_Event(50)])
    fast = types.SimpleNamespace(name="fast", done=[_Event(0), _Event(3)])
    host = types.SimpleNamespace(name="host", done=[])
    tracing.snapshot(reset=True)
    assert [p.name for p in pipeline.landed([slow, fast, host])] == [
        "host", "fast", "slow"]
    assert tracing.snapshot(reset=True)["device_fetch"]["calls"] == 3
    done = [types.SimpleNamespace(name=n, done=[_Event(0)]) for n in "abc"]
    assert [p.name for p in pipeline.landed(done)] == ["a", "b", "c"]


def test_stream_pool_is_the_current_stream_on_the_cpu():
    """The CPU, or a bucket with no slot, runs where it is: no stream."""
    import contextlib

    for device, slot in (("cpu", 0), ("cpu", None), ("cuda", None)):
        assert isinstance(mesh.bucket_stream(device, slot),
                          contextlib.nullcontext)
