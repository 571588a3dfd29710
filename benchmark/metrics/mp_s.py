"""mp_s (``cli_mp_s``, ``embed_mp_s``): megapixels of input of every call
that returned its outputs (a compressed PNG written, an RGBA array), over
the window's wall seconds, from the first call's start to the last call's
end."""


def read(run):
    calls = run.calls
    span = calls[-1]["t1"] - calls[0]["t0"]
    return sum(c["mp"] for c in calls if c["ok"]) / span
