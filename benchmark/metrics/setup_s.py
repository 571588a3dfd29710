"""setup_s: seconds from the benchmark's first line to the window's first
call (imports, inputs, the kernels' load or build, warm-up calls)."""


def read(run):
    return run.setup_s
