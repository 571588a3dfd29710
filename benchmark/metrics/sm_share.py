"""sm_share (``sm_share.cli``, ``sm_share.embed``): the time-weighted share
of the card's SMs that the running kernels' blocks take over the traced
window, one SM a block (a kernel whose blocks share an SM is counted as if
they did not)."""


def read(run):
    if run.trace is None:
        return None
    return 100 * run.trace.sm_share()
