"""The port's tracing: the stage accumulators are ``pngloss_tpu.tracing``'s,
and ``device_trace`` writes a torch.profiler trace only when asked."""

import json
import os

import numpy as np
import torch

from pngloss_tpu import tracing as jax_tracing
from pngloss_tpu.codec import encode
from pngloss_tpu_torch import pipeline, tracing


def _png():
    rgba = np.random.default_rng(41).integers(0, 256, (6, 7, 4), np.uint8)
    return encode(rgba, row_filters=None)


def test_stages_are_shared_and_recorded():
    assert tracing.stage is jax_tracing.stage
    assert tracing.snapshot is jax_tracing.snapshot
    tracing.snapshot(reset=True)
    pipeline.compress_many([_png(), b"not a png"], 19, device="cpu")
    snap = jax_tracing.snapshot(reset=True)
    assert snap["host_decode"]["calls"] == 2
    assert snap["host_encode"]["calls"] == 1
    assert snap["device_dispatch_8x8x4"]["calls"] == 1
    assert snap["device_fetch"]["calls"] == 1


def test_device_trace_off_without_a_path(monkeypatch, tmp_path):
    monkeypatch.delenv("PNGLOSS_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with tracing.device_trace():
        assert not torch.autograd._profiler_enabled()
    assert os.listdir(tmp_path) == []


def _trace_events(d):
    names = os.listdir(d)
    assert len(names) == 1 and names[0].endswith(".pt.trace.json"), names
    with open(os.path.join(d, names[0])) as fh:
        return json.load(fh)["traceEvents"]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    d = tmp_path / "trace"
    with tracing.device_trace(str(d)):
        assert torch.autograd._profiler_enabled()
        pipeline.compress_many([_png()], 19, device="cpu")
    assert not torch.autograd._profiler_enabled()
    names = {e.get("name", "") for e in _trace_events(d)}
    assert any(n.startswith("aten::") for n in names)


def test_device_trace_reads_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("PNGLOSS_PROFILE_DIR", str(tmp_path / "env"))
    with tracing.device_trace():
        torch.ones(3).sum()
    assert _trace_events(tmp_path / "env")
