"""The ``stream_share`` reader: the program's ``encode.streamed`` counter
over its ``image.images`` counter, summed over the window's requests, on
synthetic records; a program that counts no streamed encodes (as one
before the counter), or keeps no record, gives the metric nothing to read,
without an error."""

import pytest

from benchmark.harness import cells


def _view():
    view = type("Run", (), {})()
    view.calls = [dict(t0=1.0, t1=2.0, ok=True, mp=1.0),
                  dict(t0=2.0, t1=3.0, ok=True, mp=1.0)]
    return view


def _records(monkeypatch, counts):
    """Two requests in the window (roots 1 and 5) and one outside it
    (root 9), with the counters ``counts``: (request, name, n)."""
    from pngloss_tpu_torch import tracing
    from pngloss_tpu_torch.tracing import Count, Span

    sp = [Span(1, None, 1, "cli.run", 1.1, 1.9, 0),
          Span(5, None, 5, "cli.run", 2.1, 2.9, 0),
          Span(9, None, 9, "cli.run", 3.5, 3.9, 0)]
    monkeypatch.setattr(tracing, "records", lambda: dict(
        spans=sp, counts=[Count(r, n, k, 0.0) for r, n, k in counts],
        dropped=0))


@pytest.mark.parametrize("counts,want", [
    # one image a call, streamed: the screenshot's and the photo's calls
    ([(1, "image.images", 1), (1, "encode.streamed", 1),
      (5, "image.images", 1), (5, "encode.streamed", 1)], 1.0),
    # many images a call, none streamed: counted as 0 each
    ([(1, "image.images", 24)] + [(1, "encode.streamed", 0)] * 24 +
     [(5, "image.images", 24)] + [(5, "encode.streamed", 0)] * 24, 0.0),
    # one call streamed, one not; the request outside the window does not
    # count
    ([(1, "image.images", 1), (1, "encode.streamed", 1),
      (5, "image.images", 3)] + [(5, "encode.streamed", 0)] * 3 +
     [(9, "image.images", 1), (9, "encode.streamed", 1)], 1 / 4),
    # a program that launches images but counts no streamed encode
    ([(1, "image.images", 1), (1, "image.split", 1)], None),
    # no image launched in CLI mode (embedding mode's calls)
    ([(1, "ladder.rows", 255)], None),
    ([], None),
])
def test_stream_share_on_synthetic_counters(monkeypatch, counts, want):
    _records(monkeypatch, counts)
    got = cells.reader("stream_share")(_view())
    assert got == (None if want is None else pytest.approx(want))


def test_a_program_without_records_gives_no_stream_share(monkeypatch):
    from pngloss_tpu_torch import tracing

    monkeypatch.delattr(tracing, "records")
    assert cells.reader("stream_share")(_view()) is None
