"""cli_host_s_per_mp: the command's host seconds per input megapixel: the
calls' wall time, less the program's own device stages
(device_dispatch_*: uploads and launches; device_fetch: the wait for the
card), per megapixel: reading, decoding, reducing, encoding, writing."""


def read(run):
    ok = [c for c in run.calls if c["ok"]]
    host = sum(c["t1"] - c["t0"] - sum(
        v for n, v in c["stages"].items()
        if n == "device_fetch" or n.startswith("device_dispatch"))
        for c in ok)
    mp = sum(c["mp"] for c in ok)
    return host / mp if mp else None
