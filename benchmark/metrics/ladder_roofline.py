"""ladder_roofline: the least time an H100 could take for the window's
ladder_kernel work (rows 1..H-1 of every image, one attempt a row, counted from the inputs by
benchmark/reference/bounds.py), as a share of the kernel's traced time."""

from benchmark.reference import bounds


def read(run):
    if run.trace is None:
        return None
    kernel_s = run.trace.kernel_seconds("ladder_kernel")
    if kernel_s <= 0:
        return None
    ops = nbytes = 0
    for c in run.calls:
        for i in c["ids"]:
            h, w = run.plan.images[i].shape[:2]
            if h > 1:
                o, b = bounds.image_work(h, w, run.bpp[i], ladder=True)
                ops, nbytes = ops + o, nbytes + b
    return 100 * bounds.bound_s(ops, nbytes) / kernel_s
