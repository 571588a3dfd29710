"""rounds_per_row: ladder_kernel's rounds (``ladder.rounds``: k strengths
tried at once a round) over its real rows (``ladder.rows``), the
program's counters over the window's requests (``harness.spans``); above 1
only where a retry takes a row past its first round."""

from benchmark.harness import spans


def read(run):
    return spans.per_row(run, "ladder.rounds")
