"""Entry ``suite``: upstream's benchmark suite as its runner runs it,
``pngloss_tpu_torch.suite.run_suite``, in process: every file of the
suite named on one run at the configuration's strength, each output
written to a directory (``suite/run_suite.sh``: ``pngloss -fv -sN -o
compressed/...``).

Each group of the mix is one file of the suite: ``name`` names it and
``color_type`` gives the colour type it is written in (PNG's IHDR codes):

* 0, gray: R = G = B, the luma of the drawn colours by a fixed rule
  (``GRAY_WEIGHTS``, rounded), opaque;
* 2, RGB: the drawn colours, opaque;
* 6, RGBA: the drawn colours under the mix's alpha tiles;
* 3, palette with tRNS: the drawn colours on a cube of 6 levels a
  channel and the tiles' alpha made binary (0 where the tile is fully
  transparent, else 255), every transparent pixel the one entry (0, 0, 0,
  0): at most 217 entries.

The plan's images are set to these pixels in place, so the check judges
each output against exactly what the program reads. The files are
written once to the run's temporary directory as ``<name>.png``; a call
runs the suite on the call's files and reads back ``<name>-s<N>.png``.
Outputs are PNG bytes. The runner has no bleed option (its
``compress_many`` takes the default, 2), so a configuration with any other
bleed is refused.
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np

from benchmark.reference import formats, png

MODE = "cli"

# the gray rule: ITU-R BT.601's luma weights, in thousandths
GRAY_WEIGHTS = (299, 587, 114)
# palette colours: levels 0, 51, ..., 255 in each channel
CUBE_LEVELS = 6
COLOR_TYPES = (0, 2, 3, 6)


def names(mix: dict) -> list[str]:
    """The file name of each image of the plan, in the plan's order: a
    group's ``name``, with ``_<k>`` after it where the group counts more
    than one."""
    out = []
    for g in mix["groups"]:
        n = int(g["count"])
        out += [g["name"]] if n == 1 else [f"{g['name']}_{k}"
                                           for k in range(n)]
    return out


def color_types(mix: dict) -> list[int]:
    return [int(g["color_type"]) for g in mix["groups"]
            for _ in range(int(g["count"]))]


def as_color_type(rgba: np.ndarray, ctype: int) -> np.ndarray:
    """``rgba`` set, in place, to the pixels a file of colour type
    ``ctype`` holds (module docstring)."""
    if ctype not in COLOR_TYPES:
        raise ValueError(f"suite: unknown colour type {ctype}")
    if ctype == 0:
        wr, wg, wb = GRAY_WEIGHTS
        px = rgba[..., :3].astype(np.int32)
        luma = (wr * px[..., 0] + wg * px[..., 1] + wb * px[..., 2]
                + 500) // 1000
        rgba[..., :3] = luma[..., None].astype(np.uint8)
    if ctype in (0, 2):
        rgba[..., 3] = 255
    elif ctype == 3:
        step = 255 // (CUBE_LEVELS - 1)
        px = rgba[..., :3].astype(np.int32)
        rgba[..., :3] = ((px * (CUBE_LEVELS - 1) + 127) // 255 * step
                         ).astype(np.uint8)
        clear = rgba[..., 3] == 0
        rgba[..., 3] = np.where(clear, 0, 255)
        rgba[clear] = 0
    return rgba


def encode(rgba: np.ndarray, ctype: int) -> bytes:
    """``rgba``, already of ``ctype``'s pixels, as a PNG of that type."""
    if ctype == 0:
        return formats.write_gray(rgba[..., 1])
    if ctype == 2:
        return png.write(np.ascontiguousarray(rgba[..., :3]))
    if ctype == 3:
        return formats.write_palette(*formats.palette_of(rgba))
    return png.write(rgba)


class Entry:
    def __init__(self, config: dict, plan, workdir: str, device):
        from pngloss_tpu_torch import suite

        if int(config["bleed"]) != 2:
            raise ValueError("suite: the suite runner has no bleed option; "
                             f"its bleed is 2, not {config['bleed']}")
        if plan.mix["delivery"] != "files":
            raise ValueError(f"suite: unknown delivery "
                             f"{plan.mix['delivery']!r}")
        self.suite, self.device = suite, device
        self.strength = int(config["strength"])
        self.names = names(plan.mix)
        ctypes = color_types(plan.mix)
        for im, ctype in zip(plan.images, ctypes):
            as_color_type(im, ctype)
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            pngs = list(pool.map(encode, plan.images, ctypes))
        src = os.path.join(workdir, "suite")
        self.out_dir = os.path.join(workdir, "compressed")
        os.makedirs(src)
        self.paths = []
        for name, data in zip(self.names, pngs):
            self.paths.append(os.path.join(src, name + ".png"))
            with open(self.paths[-1], "wb") as fh:
                fh.write(data)

    def call(self, ids: list[int]) -> dict:
        """One suite run on images ``ids``; returns {id: PNG bytes}."""
        rows, _ = self.suite.run_suite(
            [self.paths[i] for i in ids], [self.strength],
            out_dir=self.out_dir, device=self.device, verbose=False)
        errors = [r for r in rows if "error" in r]
        if errors:
            raise RuntimeError(f"suite: {len(errors)} jobs failed, first "
                               f"{errors[0]}")
        got = {}
        for i in ids:
            with open(os.path.join(self.out_dir, f"{self.names[i]}"
                                   f"-s{self.strength}.png"), "rb") as fh:
                got[i] = fh.read()
        return got
