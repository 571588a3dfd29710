"""stream_share: the share of the window's CLI-mode images whose PNG was
encoded as their rows landed (a one-image call's rows in bands, each band
deflated while the next is on the card), the program's ``encode.streamed``
counter over its ``image.images`` counter, summed over the window's
requests of calls that returned (``harness.spans``); None where the
program keeps no such counter."""

from benchmark.harness import spans


def read(run):
    reqs = spans.requests(run)
    if not reqs:
        return None
    if not any(c.name == "encode.streamed" for r in reqs for c in r.counts):
        return None
    images = sum(r.total("image.images") for r in reqs)
    if not images:
        return None
    return sum(r.total("encode.streamed") for r in reqs) / images
