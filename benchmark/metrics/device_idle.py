"""device_idle (``device_idle.cli``, ``device_idle.embed``): the share of
the traced window in which no kernel runs on the card (the union of the
kernels' intervals in the profiler's trace)."""


def read(run):
    if run.trace is None:
        return None
    return 100 * (1 - run.trace.busy_s(kernels_only=True)
                  / run.trace.window_s)
