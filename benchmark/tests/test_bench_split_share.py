"""The ``split_share`` reader: the program's ``image.split`` counter over
its ``image.images`` counter, summed over the window's requests, on
synthetic records; a program that keeps no such counter, or no record,
gives the metric nothing to read, without an error."""

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
    # every image split: the screenshot's one image a call
    ([(1, "image.images", 1), (1, "image.split", 1),
      (5, "image.images", 1), (5, "image.split", 1)], 1.0),
    # a mix: one call's 3 images split, the other's 5 not; the request
    # outside the window does not count
    ([(1, "image.images", 3), (1, "image.split", 3),
      (5, "image.images", 5), (5, "image.split", 0),
      (9, "image.images", 4), (9, "image.split", 4)], 3 / 8),
    # no image launched in CLI mode (embedding mode's calls)
    ([(1, "ladder.rows", 255)], None),
    # no counter at all (a program without them, as the parent)
    ([], None),
])
def test_split_share_on_synthetic_counters(monkeypatch, counts, want):
    _records(monkeypatch, counts)
    got = cells.reader("split_share")(_view())
    assert got == (None if want is None else pytest.approx(want))


def test_a_program_without_records_gives_no_split_share(monkeypatch):
    from pngloss_tpu_torch import tracing

    monkeypatch.delattr(tracing, "records")
    assert cells.reader("split_share")(_view()) is None
