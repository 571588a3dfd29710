"""The readers of the program's own spans and counters
(``harness.spans``): traced tiny cells on the CPU read each of them, and
a program that keeps no record gives them nothing to read, without an
error."""

import pytest

from benchmark.harness import cells, spans
from benchmark.tests.test_bench_cells import run_cell

SPAN_METRICS = {"cli_s19.tiny_stdin": ("encode_s_per_mp",),
                "embed_s19.tiny_assets": ("pipeline_host_ms", "ops_host_ms",
                                          "attempts_per_row",
                                          "rounds_per_row")}


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_traced_run_reads_the_programs_spans(tiny_root, cell):
    res = run_cell(tiny_root, cell, trace=1)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    for name in SPAN_METRICS[cell]:
        assert got[name]["value"] > 0, name
    if cell.startswith("embed"):
        assert (got["attempts_per_row"]["value"]
                >= got["rounds_per_row"]["value"] >= 1.0)
        assert got["ops_host_ms"]["unit"] == "ms"


def test_untraced_run_reads_no_span_metric(tiny_root):
    res = run_cell(tiny_root, "embed_s19.tiny_assets", trace=0)
    assert not set(res["metrics"]) & set(SPAN_METRICS["embed_s19.tiny_assets"])


def test_a_program_without_records_gives_nothing(tiny_root, monkeypatch):
    """A parent tree's program keeps no spans: the readers find nothing,
    the run leaves those metrics out and still reads the others."""
    from pngloss_tpu_torch import tracing

    monkeypatch.delattr(tracing, "records")
    res = run_cell(tiny_root, "cli_s19.tiny_stdin", trace=1)
    assert res["correct"], res["checks"]
    assert "encode_s_per_mp" not in res["metrics"]
    assert "fetch_s_per_mp" in res["metrics"]


def test_requests_keep_the_windows_returned_calls(monkeypatch):
    """Requests are matched to calls by the clock: one outside the window
    and one in a failed call are left out, and counters go to their
    request."""
    from pngloss_tpu_torch.tracing import Count, Span

    sp = [Span(1, None, 1, "r", 0.5, 0.9, 0),       # before the window
          Span(2, None, 2, "r", 1.1, 1.9, 0),
          Span(3, 2, 2, "ops.hist", 1.2, 1.4, 0),
          Span(4, 2, 2, "ops.image", 1.3, 1.6, 0),
          Span(5, None, 5, "r", 2.1, 2.8, 0)]        # a failed call
    cn = [Count(2, "ladder.rows", 4, 1.5), Count(2, "ladder.rounds", 4, 1.5),
          Count(2, "ladder.attempts", 6, 1.5), Count(5, "ladder.rows", 9, 2.5)]
    from pngloss_tpu_torch import tracing

    monkeypatch.setattr(tracing, "records", lambda: dict(
        spans=sp, counts=cn, dropped=0))
    view = type("Run", (), {})()
    view.calls = [dict(t0=1.0, t1=2.0, ok=True, mp=2.0),
                  dict(t0=2.0, t1=3.0, ok=False, mp=2.0)]
    reqs = spans.requests(view)
    assert [r.root.id for r in reqs] == [2]
    assert reqs[0].seconds(spans.is_ops) == pytest.approx(0.4)
    assert spans.per_row(view, "ladder.attempts") == 1.5
    read = {m: cells.reader(m) for m in ("ops_host_ms", "pipeline_host_ms",
                                         "rounds_per_row")}
    assert read["ops_host_ms"](view) == pytest.approx(400)
    assert read["pipeline_host_ms"](view) == pytest.approx(400)
    assert read["rounds_per_row"](view) == 1.0
