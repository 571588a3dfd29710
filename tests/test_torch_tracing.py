"""The port's tracing: the pipeline records into the port's own stage
accumulators (a copy of ``pngloss_tpu.tracing``'s, apart from it), and
``device_trace`` writes a torch.profiler trace only when asked."""

import json
import os

import numpy as np
import pytest
import torch

from pngloss_tpu import tracing as jax_tracing
from pngloss_tpu.codec import encode
from pngloss_tpu_torch import pipeline, tracing


def _png():
    rgba = np.random.default_rng(41).integers(0, 256, (6, 7, 4), np.uint8)
    return encode(rgba, row_filters=None)


def test_stages_are_shared_and_recorded():
    """The pipeline and ``tracing`` share one set of accumulators, the
    port's own: the JAX package's sees nothing of a port run."""
    assert tracing.stage is not jax_tracing.stage
    assert pipeline.tracing is tracing
    tracing.snapshot(reset=True)
    jax_tracing.snapshot(reset=True)
    pipeline.compress_many([_png(), b"not a png"], 19, device="cpu")
    assert jax_tracing.snapshot(reset=True) == {}
    snap = tracing.snapshot(reset=True)
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


# ---- spans, requests and counters (tracing on while a profiler records)

def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _last_id():
    return max((s.id for s in tracing.records()["spans"]), default=0)


def _spans_after(first):
    return [s for s in tracing.records()["spans"] if s.id > first]


def _distinct_pngs(n):
    rng = np.random.default_rng(43)
    return [encode(rng.integers(0, 256, (6, 7 + k, 4), np.uint8),
                   row_filters=None) for k in range(n)]


def test_spans_nest_under_one_request_across_pool_threads(monkeypatch):
    """compress_many is one request: the decode and encode pools' spans
    carry its id and its root as parent, the ops spans sit under their
    bucket's dispatch, and each span is on the profiler's clock."""
    import threading

    monkeypatch.setattr(pipeline, "host_workers", lambda: 4)
    first = _last_id()
    with _profiled():
        pipeline.compress_many(_distinct_pngs(3), 19, device="cpu")
    spans = _spans_after(first)
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "pipeline.compress_many" and root.request == root.id
    assert all(s.request == root.id for s in spans)
    by_id = {s.id: s for s in spans}
    for name in ("host_decode", "host_reduce", "host_pack", "device_fetch",
                 "host_restore", "host_encode"):
        got = [s for s in spans if s.name == name]
        assert got and all(s.parent == root.id for s in got), name
    pooled = [s for s in spans if s.name in ("host_decode", "host_encode")]
    assert len(pooled) == 6
    assert {s.thread for s in pooled} - {threading.get_ident()}
    for s in spans:
        assert root.t0 <= s.t0 <= s.t1 <= root.t1
        if s.name.startswith("ops.") or s.name == "host_gather":
            assert by_id[s.parent].name.startswith("device_dispatch_")
    ops = [s.name for s in spans if s.name.startswith("ops.")]
    assert {"ops.upload", "ops.prepare", "ops.hist", "ops.row0",
            "ops.image"} <= set(ops)


def test_nested_entry_points_are_one_request():
    first = _last_id()
    rgba = np.random.default_rng(44).integers(0, 256, (5, 6, 4), np.uint8)
    with _profiled():
        pipeline.optimize_for_average_filter(rgba, 19, device="cpu")
        pipeline.optimize_rgba_batch([rgba], 19, device="cpu")
    spans = _spans_after(first)
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["pipeline.optimize_for_average_filter",
                                       "pipeline.optimize_rgba_batch"]
    inner = [s for s in spans if s.name == "pipeline.optimize_rgba_batch"
             and s.parent is not None]
    assert len(inner) == 1 and inner[0].parent == roots[0].id
    assert inner[0].request == roots[0].id


def test_untraced_calls_open_no_span_and_copy_no_counter(monkeypatch):
    """With no profiler running: no record_function, no record, no
    ``rounds=`` for the ladder and no device counter to copy back."""
    import io

    from pngloss_tpu_torch import cli
    from pngloss_tpu_torch.ops import image as image_op

    def refuse(*a, **kw):
        raise AssertionError("record_function opened with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.delenv("PNGLOSS_PROFILE_DIR", raising=False)
    real_rows, real_dispatch = image_op.image_rows, pipeline.dispatch_buckets
    seen, pending = [], []

    def rows(*a, **kw):
        seen.append(kw.get("rounds"))
        return real_rows(*a, **kw)

    def dispatch(*a, **kw):
        out = real_dispatch(*a, **kw)
        pending.extend(out)
        return out

    monkeypatch.setattr(image_op, "image_rows", rows)
    monkeypatch.setattr(pipeline, "dispatch_buckets", dispatch)
    before = tracing.records()
    assert not tracing.on()
    out = io.BytesIO()
    assert cli.run(["-"], io.BytesIO(_png()), out, device="cpu") == 0
    rgba = np.random.default_rng(45).integers(0, 256, (5, 6, 4), np.uint8)
    pipeline.optimize_for_average_filter(rgba, 19, device="cpu")
    tracing.count("ladder.rows", 3)
    assert tracing.records() == before
    assert seen == [None, None] and len(pending) == 2
    assert all(p.counts == [] for p in pending)
    fn = len
    assert tracing.carry(fn) is fn


def test_chrome_trace_holds_the_programs_spans(tmp_path):
    """The spans of the thread that started the profiler are in its trace
    (a pool thread's, such as compress_many's host_encode of several
    files, are in ``records()`` only)."""
    d = tmp_path / "trace"
    rgba = np.random.default_rng(46).integers(0, 256, (5, 6, 4), np.uint8)
    with tracing.device_trace(str(d)):
        pipeline.compress_many([_png()], 19, device="cpu")
        pipeline.optimize_for_average_filter(rgba, 19, device="cpu")
    names = {e.get("name", "") for e in _trace_events(d)
             if e.get("cat") == "user_annotation"}
    assert {"pipeline.compress_many", "host_decode", "host_reduce",
            "host_pack", "device_dispatch_8x8x4", "ops.upload",
            "ops.prepare", "ops.hist", "ops.row0", "ops.image",
            "host_gather", "device_fetch", "host_restore",
            "pipeline.optimize_for_average_filter",
            "pipeline.optimize_rgba_batch"} <= names


def test_cli_run_writes_a_trace_where_asked(monkeypatch, tmp_path):
    """``cli.run`` runs under ``device_trace``: with PNGLOSS_PROFILE_DIR
    set a call writes a Chrome trace of its spans; without, nothing."""
    from pngloss_tpu_torch import cli

    src = tmp_path / "in.png"
    src.write_bytes(_png())
    monkeypatch.delenv("PNGLOSS_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    assert cli.run(["-f", str(src)], device="cpu") == 0
    assert sorted(os.listdir(tmp_path)) == ["in-loss.png", "in.png"]
    monkeypatch.setenv("PNGLOSS_PROFILE_DIR", str(tmp_path / "prof"))
    assert cli.run(["-f", str(src)], device="cpu") == 0
    names = {e.get("name", "") for e in _trace_events(tmp_path / "prof")}
    assert {"cli.run", "host_read", "host_decode", "host_encode",
            "host_write", "device_fetch"} <= names


@pytest.mark.parametrize("n", [1, 2])
def test_batched_cli_spans_its_host_stages(n, tmp_path, monkeypatch):
    """The command is one request: each file's read, decode, reduce,
    restore and encode on the host pool's threads where it has several
    files, in the calling thread where it has one, its write in the
    calling thread, and the shape buckets counted once."""
    import threading

    from pngloss_tpu_torch import cli

    monkeypatch.setattr(pipeline, "host_workers", lambda: 4)
    paths = []
    for k, data in enumerate(_distinct_pngs(n)):
        paths.append(tmp_path / f"in{k}.png")
        paths[-1].write_bytes(data)
    first = _last_id()
    with _profiled():
        assert cli.run(["-f", *map(str, paths)], device="cpu") == 0
    spans = _spans_after(first)
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "cli.run"
    count = {}
    for s in spans:
        if s.parent == root.id:
            count[s.name] = count.get(s.name, 0) + 1
    assert count == {"host_read": n, "host_decode": n, "host_reduce": n,
                     "host_pack": 1, "device_dispatch_8x8x4": 1,
                     "device_fetch": 1, "host_restore": n, "host_encode": n,
                     "host_write": n}
    here = threading.get_ident()
    for s in spans:
        pooled = n > 1 and s.name in ("host_read", "host_decode",
                                      "host_reduce", "host_restore",
                                      "host_encode")
        assert (s.thread != here) == pooled, s.name
    assert [(c.name, c.n) for c in tracing.records()["counts"]
            if c.request == root.id] == [("pipeline.buckets", 1)]


def test_ladder_counters_equal_the_plain_ladders_sums(monkeypatch):
    """Embedding mode on the CPU route, two buckets whose rows retry: the
    request's ladder counters are the sums of image_rows_ladder_ref's
    attempts and rounds, and of the real rows 1..H-1."""
    from pngloss_tpu_torch.ops import image as image_op

    real = image_op.image_rows_ladder_ref
    sums = {"ladder.rows": 0, "ladder.attempts": 0, "ladder.rounds": 0}

    def ladder(*a, **kw):
        out = real(*a, **kw)
        h_real, rounds = a[11], a[12]
        sums["ladder.rows"] += int((h_real - 1).sum())
        sums["ladder.attempts"] += int(out[2].sum())
        sums["ladder.rounds"] += int(rounds.sum())
        return out

    monkeypatch.setattr(image_op, "image_rows_ladder_ref", ladder)
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, (h, w, 4), np.uint8)
            for h, w in ((5, 6), (4, 6), (7, 9))]
    first = _last_id()
    with _profiled():
        pipeline.optimize_rgba_batch(imgs, 90, use_row_filters=False,
                                     device="cpu")
    (root,) = [s for s in _spans_after(first) if s.parent is None]
    got = dict.fromkeys(sums, 0)
    for c in tracing.records()["counts"]:
        if c.request == root.id and c.name.startswith("ladder."):
            got[c.name] += c.n
    assert got == sums
    assert got["ladder.rows"] == 4 + 3 + 6
    assert got["ladder.attempts"] > got["ladder.rows"]     # a row retried


def test_cli_mode_counts_nothing():
    """CLI mode counts no ladder counter: a request's only counter is its
    shape buckets."""
    first = _last_id()
    with _profiled():
        pipeline.compress_many([_png()], 19, device="cpu")
    (root,) = [s for s in _spans_after(first) if s.parent is None]
    assert [(c.name, c.n) for c in tracing.records()["counts"]
            if c.request == root.id] == [("pipeline.buckets", 1)]


def test_snapshot_reset_leaves_records():
    first = _last_id()
    with _profiled():
        with tracing.request("test.request"):
            with tracing.stage("test.stage"):
                tracing.count("test.count", 2)
    assert tracing.snapshot(reset=True)["test.stage"]["calls"] == 1
    assert tracing.snapshot() == {}
    spans = _spans_after(first)
    assert [s.name for s in spans] == ["test.stage", "test.request"]
    assert spans[0].parent == spans[1].id == spans[0].request
    assert tracing.records()["counts"][-1][:3] == (spans[1].id,
                                                   "test.count", 2)


def test_records_are_bounded_and_count_what_they_drop(monkeypatch):
    monkeypatch.setattr(tracing, "RECORD_LIMIT", 3)
    dropped = tracing.records()["dropped"]
    with _profiled():
        for k in range(5):
            with tracing.stage(f"test.bounded{k}"):
                pass
    rec = tracing.records()
    assert [s.name for s in rec["spans"]] == [
        "test.bounded2", "test.bounded3", "test.bounded4"]
    assert rec["dropped"] > dropped


def test_a_stage_outside_any_request_has_none():
    first = _last_id()
    with _profiled():
        with tracing.stage("test.alone"):
            pass
    (s,) = _spans_after(first)
    assert s.parent is None and s.request is None
