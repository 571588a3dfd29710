"""Find a cell's parts by name: ``BENCHMARK.json`` at the root of the
checkout names the cell's configuration and traffic mix and the metrics it
reports; each lives in a file of its own:

* ``benchmark/configs/<config>.json`` (the path in the config's ``file``):
  the deployment, whose ``entry`` names ``benchmark/entries/<entry>.py``;
* ``benchmark/traffic/<traffic>.json``: the mix (``harness.traffic``);
* ``benchmark/metrics/<metric>.py``: a reader, ``read(run)``, which
  returns the metric's value or None where it finds nothing to read.
  Metrics of one quantity split by the cells they move share a reader,
  named by the metric's name before its first ``.`` (``device_idle.cli``
  reads with ``device_idle.py``) or after its first ``_`` (``cli_mp_s``
  reads with ``mp_s.py``), where no file has the whole name.

A cell, configuration, mix or metric is added by adding its files and its
entries in ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    entry: object               # benchmark/entries/<entry>.py
    end_to_end: list[dict]
    per_layer: list[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: str = ROOT) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(root, "benchmark", "traffic",
                           cell["traffic"] + ".json")) as fh:
        mix = json.load(fh)
    entry = _module(root, "entries", config["entry"])
    return Cell(name, int(cell["chips"]), config, mix, entry,
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)])


def _module(root: str, folder: str, name: str):
    """benchmark/<folder>/<name>.py of ``root``, loaded from its path (a
    name may hold dots)."""
    path = os.path.join(root, "benchmark", folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: str = ROOT):
    """The ``read`` function of the metric's reader in benchmark/metrics/:
    the file of its whole name, else of its name before the first ``.``,
    else of its name after the first ``_``."""
    for name in (metric, metric.split(".")[0], metric.split("_", 1)[-1]):
        if os.path.exists(os.path.join(root, "benchmark", "metrics",
                                       name + ".py")):
            return _module(root, "metrics", name).read
    raise FileNotFoundError(f"no reader for the metric {metric!r} in "
                            f"benchmark/metrics/")
