"""fetch_s_per_mp: the program's device_fetch stage seconds (the host
waiting for the card's results) per input megapixel."""


def read(run):
    ok = [c for c in run.calls if c["ok"]]
    mp = sum(c["mp"] for c in ok)
    fetch = sum(c["stages"].get("device_fetch", 0.0) for c in ok)
    return fetch / mp if mp else None
