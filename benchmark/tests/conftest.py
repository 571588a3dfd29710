"""Fixtures of the benchmark's CPU tests: a temporary checkout holding
``BENCHMARK.json`` and ``benchmark/`` with tiny cells added as files, and
the ``cuda`` marker for the tests that need the card."""

import json
import os
import shutil

import pytest

from benchmark.harness import cells

TINY_MIXES = {
    "tiny_stdin": {"groups": [{"kind": "screenshot", "count": 2,
                               "height": 12, "width": 16}],
                   "alpha_tile": None, "per_call": 1, "delivery": "stdin",
                   "warmup_calls": 1, "full_rows": 4},
    "tiny_files": {"groups": [{"kind": "photo", "count": 2, "height": 10,
                               "width": 14},
                              {"kind": "photo", "count": 1, "height": 14,
                               "width": 10}],
                   "alpha_tile": None, "per_call": 3, "delivery": "files",
                   "warmup_calls": 1, "full_rows": 3},
    "tiny_assets": {"groups": [{"kind": "synthetic", "count": 1,
                                "height": 12, "width": 12},
                               {"kind": "noise", "count": 1, "height": 12,
                                "width": 12}],
                    "alpha_tile": 4, "per_call": 1, "delivery": "array",
                    "warmup_calls": 2, "full_rows": 4},
}
# a configuration, a metric and cells that exist only as the files the
# fixture adds
NEW_CONFIG = "cli_s40"
NEW_METRIC = "calls_made"
TINY_CELLS = {"cli_s19.tiny_stdin": ("cli_s19", "tiny_stdin"),
              f"{NEW_CONFIG}.tiny_files": (NEW_CONFIG, "tiny_files"),
              "embed_s19.tiny_assets": ("embed_s19", "tiny_assets")}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skipped without one)")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout of BENCHMARK.json and benchmark/ to which a
    configuration, three mixes, a metric and three cells were added as
    new files and entries; no file that was there is edited."""
    root = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(cells.ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    with open(os.path.join(root, "benchmark", "configs",
                           "cli_s19.json")) as fh:
        config = dict(json.load(fh), name=NEW_CONFIG, strength=40)
    path = f"benchmark/configs/{NEW_CONFIG}.json"
    with open(os.path.join(root, path), "w") as fh:
        json.dump(config, fh)
    spec["configs"].append({"name": NEW_CONFIG, "source": "a test",
                            "file": path, "reduced": ["strength"],
                            "why": "a test"})
    for name, mix in TINY_MIXES.items():
        with open(os.path.join(root, "benchmark", "traffic",
                               name + ".json"), "w") as fh:
            json.dump(mix, fh)
    with open(os.path.join(root, "benchmark", "metrics",
                           NEW_METRIC + ".py"), "w") as fh:
        fh.write("def read(run):\n    return len(run.calls)\n")
    spec["per_layer"].append({"name": NEW_METRIC, "unit": "calls",
                              "better": "higher",
                              "source": "program_counter", "layer": "cli",
                              "moves": "cli_mp_s"})
    for cell, (config_name, mix) in TINY_CELLS.items():
        spec["workloads"].append({"name": cell, "config": config_name,
                                  "traffic": mix, "chips": 1,
                                  "why": "a test"})
        family = "cli_s19" if config_name == NEW_CONFIG else config_name
        for m in spec["end_to_end"] + spec["per_layer"]:
            if any(w.startswith(family + ".") for w in
                   m.get("workloads", ())):
                m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return root
