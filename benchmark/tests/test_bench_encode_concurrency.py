"""The ``encode_concurrency`` reader: the mean number of ``host_encode``
spans in flight while any is. Traced tiny cells on the CPU read above 1
where a call's files encode side by side on the host pool and exactly 1
where a call encodes one image, and a program that keeps no record gives
the metric nothing to read, without an error."""

import pytest

from benchmark.harness import cells
from benchmark.tests.conftest import NEW_CONFIG
from benchmark.tests.test_bench_cells import run_cell


def test_files_cell_encodes_side_by_side(tiny_root):
    res = run_cell(tiny_root, f"{NEW_CONFIG}.tiny_files", trace=1)
    assert res["correct"], res["checks"]
    got = res["metrics"]["encode_concurrency"]
    assert got["value"] > 1.0
    assert got["unit"] == "encodes"


def test_stdin_cell_encodes_one_at_a_time(tiny_root):
    res = run_cell(tiny_root, "cli_s19.tiny_stdin", trace=1)
    assert res["correct"], res["checks"]
    assert res["metrics"]["encode_concurrency"]["value"] == 1.0


def test_a_program_without_records_gives_no_concurrency(tiny_root,
                                                        monkeypatch):
    from pngloss_tpu_torch import tracing

    monkeypatch.delattr(tracing, "records")
    res = run_cell(tiny_root, f"{NEW_CONFIG}.tiny_files", trace=1)
    assert res["correct"], res["checks"]
    assert "encode_concurrency" not in res["metrics"]


def test_concurrency_is_span_seconds_over_their_union(monkeypatch):
    """Two requests in the window: one with two encodes that overlap by
    half, one with a single encode; another span name does not count."""
    from pngloss_tpu_torch import tracing
    from pngloss_tpu_torch.tracing import Span

    sp = [Span(1, None, 1, "r", 1.1, 1.9, 0),
          Span(2, 1, 1, "host_encode", 1.2, 1.6, 1),
          Span(3, 1, 1, "host_encode", 1.4, 1.8, 2),
          Span(4, 1, 1, "host_decode", 1.1, 1.5, 1),
          Span(5, None, 5, "r", 2.1, 2.9, 0),
          Span(6, 5, 5, "host_encode", 2.2, 2.4, 0)]
    monkeypatch.setattr(tracing, "records", lambda: dict(
        spans=sp, counts=[], dropped=0))
    view = type("Run", (), {})()
    view.calls = [dict(t0=1.0, t1=2.0, ok=True, mp=1.0),
                  dict(t0=2.0, t1=3.0, ok=True, mp=1.0)]
    read = cells.reader("encode_concurrency")
    assert read(view) == pytest.approx((0.4 + 0.4 + 0.2) / (0.6 + 0.2))
