"""split_share: the share of the window's CLI-mode images whose image
kernel ran in the split layout (a thread-block cluster an image, each
block on an SM of its own), the program's ``image.split`` counter over its
``image.images`` counter, summed over the window's requests of calls that
returned (``harness.spans``); None where the program keeps no such
counter."""

from benchmark.harness import spans


def read(run):
    reqs = spans.requests(run)
    if not reqs:
        return None
    images = sum(r.total("image.images") for r in reqs)
    if not images:
        return None
    return sum(r.total("image.split") for r in reqs) / images
