"""Entry ``embed``: the embedding API,
``pngloss_tpu_torch.pipeline.optimize_for_average_filter``: RGBA in and
out, bleed 2, every row passing libpng's MSAD heuristic; one image a call
(the mix's ``delivery`` is ``array``). Outputs are RGBA arrays."""

from __future__ import annotations

MODE = "embed"


class Entry:
    def __init__(self, config: dict, plan, workdir: str, device):
        from pngloss_tpu_torch import pipeline

        if plan.mix["delivery"] != "array" or plan.per_call != 1:
            raise ValueError("embed: one array a call")
        if config["bleed"] != 2:
            raise ValueError("embed: the API's bleed divider is 2")
        self.fn, self.plan = pipeline.optimize_for_average_filter, plan
        self.strength, self.device = config["strength"], device

    def call(self, ids: list[int]) -> dict:
        (i,) = ids
        return {i: self.fn(self.plan.images[i], self.strength,
                           device=self.device)}
