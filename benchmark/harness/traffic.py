"""The one generator of every traffic mix: a mix file's parameters and a
seed in, the run's images and the order its calls use them out.

A mix (``benchmark/traffic/<name>.json``) holds:

* ``groups``: lists of ``{"kind", "count", "height", "width"}``; ``kind``
  names a generator of ``harness.images.KINDS``. The images are drawn in
  the listed order from one ``numpy`` Generator seeded with the run's seed,
  so one seed gives the same images, and every seed the same sizes;
* ``alpha_tile``: null, or the tile side of ``images.alpha_tiles``,
  applied to every image;
* ``per_call``: how many images one call takes. Calls take the images in
  turn, in an order shuffled by the seed, ``per_call`` at a time;
* ``delivery``: how the config's entry hands them to the program (read by
  the entry: ``stdin`` or ``files`` for the command, ``array`` for the
  library);
* ``full_rows``: rows of each distinct output that the check runs the
  scalar model's whole row search on (the first, second and last, then
  rows drawn from the seed; the height or more: every row). Rows that
  kept a strength below the configuration's are searched besides.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.harness import images as gen


@dataclasses.dataclass
class Plan:
    """A run's inputs: RGBA images, the order calls take them in."""
    images: list[np.ndarray]
    order: list[int]
    per_call: int
    mix: dict

    def call(self, k: int) -> list[int]:
        """The indices of the images call k takes."""
        n = len(self.order)
        start = (k * self.per_call) % n
        return [self.order[(start + i) % n] for i in range(self.per_call)]

    def megapixels(self, ids) -> float:
        return sum(self.images[i].shape[0] * self.images[i].shape[1]
                   for i in ids) / 1e6


def rng_for(seed: int, stream: int = 0) -> np.random.Generator:
    """A Generator for any whole seed, negative or past 64 bits too."""
    return np.random.default_rng([abs(int(seed)) % (1 << 64),
                                  int(seed < 0), stream])


def plan(mix: dict, seed: int) -> Plan:
    rng = rng_for(seed)
    images = []
    for group in mix["groups"]:
        make = gen.KINDS[group["kind"]]
        for _ in range(group["count"]):
            im = make(rng, group["height"], group["width"])
            if mix.get("alpha_tile"):
                gen.alpha_tiles(rng, im, mix["alpha_tile"])
            images.append(im)
    order = [int(i) for i in rng.permutation(len(images))]
    return Plan(images, order, int(mix["per_call"]), mix)
