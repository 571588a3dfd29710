"""Entry ``cli``: the pngloss command, ``pngloss_tpu_torch.cli.run``, in
process: a user's ``pngloss`` call without the interpreter's start-up.

The mix's ``delivery`` says how the PNGs reach it: ``stdin`` (one image a
call, ``pngloss -s N -b B - < in.png > out.png``) or ``files`` (the
call's images as PNG files in the run's temporary directory, named on
the command line: ``pngloss -s N -b B -f --ext .out.png in_0.png ...``;
each call overwrites the outputs, which are read back after it).
Outputs are PNG bytes.
"""

from __future__ import annotations

import concurrent.futures
import io
import os

from benchmark.reference import png

MODE = "cli"


def _pixels(rgba):
    """Opaque images go to the program as RGB PNGs, others as RGBA."""
    return rgba[..., :3] if (rgba[..., 3] == 255).all() else rgba


class Entry:
    def __init__(self, config: dict, plan, workdir: str, device):
        from pngloss_tpu_torch import cli

        self.cli, self.plan, self.device = cli, plan, device
        self.delivery = plan.mix["delivery"]
        if self.delivery not in ("stdin", "files"):
            raise ValueError(f"cli: unknown delivery {self.delivery!r}")
        self.argv = ["-s", str(config["strength"]),
                     "-b", str(config["bleed"])]
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            self.pngs = list(pool.map(lambda im: png.write(_pixels(im)),
                                      plan.images))
        self.paths = []
        if self.delivery == "files":
            for i, data in enumerate(self.pngs):
                path = os.path.join(workdir, f"in_{i}.png")
                with open(path, "wb") as fh:
                    fh.write(data)
                self.paths.append(path)

    def call(self, ids: list[int]) -> dict:
        """One pngloss call on images ``ids``; returns {id: PNG bytes}."""
        if self.delivery == "stdin":
            (i,) = ids
            out = io.BytesIO()
            rc = self.cli.run([*self.argv, "-"], io.BytesIO(self.pngs[i]),
                              out, device=self.device)
            if rc:
                raise RuntimeError(f"pngloss exited with {rc}")
            return {i: out.getvalue()}
        rc = self.cli.run([*self.argv, "-f", "--ext", ".out.png",
                           *(self.paths[i] for i in ids)],
                          io.BytesIO(), io.BytesIO(), device=self.device)
        if rc:
            raise RuntimeError(f"pngloss exited with {rc}")
        got = {}
        for i in ids:
            with open(self.paths[i][:-4] + ".out.png", "rb") as fh:
                got[i] = fh.read()
        return got
