"""The check of one run's outputs, in tasks for a pool of worker
processes: a first pass per distinct output (``first_pass``: read it,
judge every row's bytes, keep the states of the rows to search), then one
task per such row (``search``: the scalar model's whole row search).

With ``control`` set, the first pass judges the control's output in the
program's place: the reference with floor division in the dither
(``rowsearch``, ``division="floor"``), worked out from the original row by
row from its own rows, and for the command written as the command writes
it (colour type and each row's filter).

Imports numpy and the benchmark's frozen copies only.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import check, png, rowsearch, scalar

# the encoder's colour type for (grayscale, opaque) pixels (rwpng.c:576-624)
COLOR_TYPE = {(True, True): 0, (True, False): 4, (False, True): 2,
              (False, False): 6}
WORK_CHANNELS = {1: (1,), 2: (1, 3), 3: (0, 1, 2), 4: (0, 1, 2, 3)}


def to_rgba(rows: np.ndarray, ctype: int, w: int) -> np.ndarray:
    """Unfiltered PNG rows of colour type 0, 2, 4 or 6 as (H, W, 4) RGBA."""
    px = rows.reshape(len(rows), w, png.CHANNELS[ctype])
    out = np.full((len(rows), w, 4), 255, np.uint8)
    if ctype in (0, 4):
        out[..., :3] = px[..., :1]
        if ctype == 4:
            out[..., 3] = px[..., 1]
    else:
        out[..., :px.shape[2]] = px
    return out


def color_type(rgba: np.ndarray) -> int:
    """The colour type the command writes ``rgba`` in."""
    gray = bool((rgba[..., 0] == rgba[..., 1]).all()
                and (rgba[..., 1] == rgba[..., 2]).all())
    return COLOR_TYPE[gray, bool((rgba[..., 3] == 255).all())]


def sample_rows(h: int, count: int, seed) -> list[int]:
    """The rows the whole row search runs on: the first, the second, the
    last, then rows drawn from ``seed`` until ``count``."""
    rows = {0, min(1, h - 1), h - 1}
    rng = np.random.default_rng(seed)
    while len(rows) < min(count, h):
        rows.add(int(rng.integers(0, h)))
    return sorted(rows)


def control_output(original: np.ndarray, mode: str, strength: int,
                   bleed: int):
    """The control's output for ``original``: PNG bytes for the command,
    an RGBA array for the library."""
    work, bpp, _, _ = scalar.reduce_colorspace(original)
    q, filters = rowsearch.optimize_image(work, bpp, strength, bleed,
                                          use_row_filters=mode == "cli",
                                          division="floor")
    rgba = scalar.restore_colorspace(q, bpp, original.shape[1])
    if mode != "cli":
        return rgba
    channels = {0: (1,), 4: (1, 3), 2: (0, 1, 2), 6: (0, 1, 2, 3)}
    return png.write(np.ascontiguousarray(rgba[..., channels[color_type(
        rgba)]]),
                     filters=filters)


def first_pass(task: dict) -> dict:
    """task: ``original`` (H, W, 4) RGBA, ``output`` (PNG bytes for the
    command, RGBA for the library), ``mode`` ("cli" or "embed"),
    ``strength``, ``bleed``, ``full_rows``, ``seed``, ``control`` (judge
    the control's output instead of ``output``). Returns counts and the
    states of the rows to search: those drawn from the seed and those
    that kept a strength below the configuration's."""
    original, output = task["original"], task["output"]
    if task.get("control"):
        output = control_output(original, task["mode"], task["strength"],
                                task["bleed"])
    h, w = original.shape[:2]
    work, bpp, _, _ = scalar.reduce_colorspace(original)
    out = dict(index=task.get("index"), rows=h, malformed=0, wrong=0,
               fell_back=0, states=[])
    if task["mode"] == "cli":
        try:
            rows, filters, ctype = png.read(output)
        except png.PngError as e:
            return dict(out, malformed=1, why=str(e))
        if rows.shape != (h, w * png.CHANNELS[ctype]):
            return dict(out, malformed=1, why=f"shape {rows.shape}")
        q = to_rgba(rows, ctype, w)
        if color_type(q) != ctype:
            return dict(out, malformed=1, why=f"colour type {ctype}")
    else:
        q = np.asarray(output)
        if q.shape != (h, w, 4) or q.dtype != np.uint8:
            return dict(out, malformed=1, why=f"array {q.shape} {q.dtype}")
        filters = None
    q_work = np.ascontiguousarray(q[..., WORK_CHANNELS[bpp]]).reshape(h, -1)
    if not np.array_equal(scalar.restore_colorspace(q_work, bpp, w), q):
        return dict(out, malformed=1, why="channels outside the working "
                                          "format changed")
    if filters is None:
        filters = check.msad_filters(q_work, bpp)
    walk = check.Walk(work, q_work, filters, bpp, task["bleed"])
    keep = sample_rows(h, task["full_rows"], task["seed"])
    fell_back = []
    wrong = check.judge_rows(walk, task["strength"],
                             "first" if task["mode"] == "cli" else "all",
                             keep=set(keep), fell_back=fell_back)
    out.update(wrong=len(wrong), first_wrong=wrong[:5].tolist(),
               fell_back=len(fell_back),
               states=[check.row_state(walk, y)
                       for y in sorted(set(keep) | set(fell_back))])
    return out


def search(args) -> bool:
    """(state, strength, mode): the scalar model's search of one row from
    ``state``; True when it gives the output's pixels and filter."""
    state, strength, mode = args
    adaptive = mode == "embed" or state["y"] == 0
    return check.search_row(state, strength, adaptive)
