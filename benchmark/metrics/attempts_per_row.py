"""attempts_per_row: ladder_kernel's row attempts (``ladder.attempts``:
the strengths tried until one passes, as the sequential loop counts them)
over its real rows (``ladder.rows``: rows 1..H-1), the program's counters
over the window's requests (``harness.spans``); 1 where every row passes
at full strength."""

from benchmark.harness import spans


def read(run):
    return spans.per_row(run, "ladder.attempts")
