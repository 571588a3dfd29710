"""Runs of tiny cells on the CPU (the port's plain versions), through the
whole harness but its look for a card: cells, configurations, mixes and
metrics found as files; correct outputs judged correct; and each fault a
cell can have, planted under the timed path, judged not correct."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.harness import cells
from benchmark.tests.conftest import NEW_METRIC, TINY_CELLS

SEED = 2 ** 31 + 12345


def run_cell(root, cell, trace=0, control=0, seconds=1.0):
    args = run.parse(["--workload", cell, "--seed", str(SEED), "--seconds",
                      str(seconds), "--trace", str(trace), "--control",
                      str(control)])
    return run.run(args, device="cpu", root=root)


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_cells_added_as_files_run_and_are_correct(tiny_root, cell):
    before = {p: open(os.path.join(cells.ROOT, p), "rb").read()
              for p in _files(os.path.join(cells.ROOT, "benchmark"))}
    res = run_cell(tiny_root, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    spec = cells.load(cell, tiny_root)
    assert set(res["metrics"]) == {m["name"] for m in spec.end_to_end}
    assert list(res)[-1] == "checks"
    for path, data in before.items():        # nothing that was there moved
        with open(os.path.join(tiny_root, path), "rb") as fh:
            assert fh.read() == data, path


def test_traced_run_reads_per_layer_metrics(tiny_root):
    res = run_cell(tiny_root, "cli_s19.tiny_stdin", trace=1)
    assert res["correct"], res["checks"]
    assert res["metrics"][NEW_METRIC]["value"] == res["attempted"]
    # no card: the metrics of the device trace find nothing to read
    assert "image_roofline" not in res["metrics"]
    assert res["metrics"]["fetch_s_per_mp"]["value"] >= 0
    assert res["device"]["window_s"] > 0 and "breakdown" in res


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_control_is_not_correct(tiny_root, cell):
    """The reference with floor division in the dither, judged in the
    program's place."""
    res = run_cell(tiny_root, cell, control=1)
    assert not res["correct"], res["checks"]


def _plant(monkeypatch, fault):
    """``fault`` under the timed path: every bucket the program optimizes
    goes through it."""
    from pngloss_tpu_torch import pipeline

    real = pipeline.optimize_batch_sharded

    def broken(rows, *a, **kw):
        if fault == "state_unchanged":       # the input comes back as is
            q = torch.from_numpy(np.ascontiguousarray(rows))
            return [q], [torch.zeros(q.shape[:2], dtype=torch.int8)], len(q)
        if fault == "lower_rung_wins":       # a strength below the first
            return real(rows, a[0] - 4, *a[1:], **kw)   # that passes
        if fault == "half_batch_left_out":   # the rest copies the first
            half = (len(rows) + 1) // 2
            qs, fs, _ = real(rows[:half], *a, **_cut(kw, half))
            q, f = torch.cat(qs), torch.cat(fs)
            idx = torch.arange(len(rows)) % half
            return [q[idx]], [f[idx]], len(rows)
        qs, fs, b = real(rows, *a, **kw)     # one answer altered
        q = torch.cat(qs)
        q[:, q.shape[1] // 2, 0] ^= 0x40
        return [q], fs, b

    monkeypatch.setattr(pipeline, "optimize_batch_sharded", broken)


def _cut(kw, n):
    return {k: (v[:n] if k in ("w_real", "h_real") and v is not None
                and np.ndim(v) else v) for k, v in kw.items()}


@pytest.mark.parametrize("cell,fault", [
    ("cli_s19.tiny_stdin", "state_unchanged"),
    ("cli_s19.tiny_stdin", "answer_altered"),
    ("cli_s40.tiny_files", "state_unchanged"),
    ("cli_s40.tiny_files", "half_batch_left_out"),
    ("cli_s40.tiny_files", "answer_altered"),
    ("embed_s19.tiny_assets", "state_unchanged"),
    ("embed_s19.tiny_assets", "answer_altered"),
    ("embed_s19.tiny_assets", "lower_rung_wins"),
])
def test_planted_faults_are_not_correct(tiny_root, monkeypatch, cell,
                                        fault):
    _plant(monkeypatch, fault)
    res = run_cell(tiny_root, cell)
    assert not res["correct"], res["checks"]


def test_without_cuda_exits_nonzero_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, os.path.join(cells.BENCH_DIR, "run.py"),
         "--workload", "cli_s19.screenshot", "--seed", str(SEED),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cells.ROOT)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert "metrics" not in proc.stdout and proc.stdout.strip() == ""


def test_without_the_program_exits_nonzero(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/."""
    import shutil

    shutil.copytree(cells.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "cli_s19.screenshot", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(cuda_card, tiny_root):
    args = run.parse(["--workload", "cli_s19.tiny_stdin", "--seed",
                      str(SEED), "--seconds", "2", "--trace", "1"])
    res = run.run(args, root=tiny_root)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
    assert 0 < res["metrics"]["image_roofline"]["value"] < 100


def _files(top):
    for d, _, names in os.walk(top):
        if "__pycache__" in d:
            continue
        for n in names:
            yield os.path.relpath(os.path.join(d, n), cells.ROOT)


def test_every_metric_has_a_reader():
    with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(cells.reader(m["name"])), m["name"]


def test_a_module_loaded_after_the_run_withholds_the_result(monkeypatch,
                                                            capsys):
    """The look for JAX modules is made again just before the result is
    printed, after the check and the metric readers have run."""
    import types

    def fake_run(args, **kw):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return {"correct": True}

    monkeypatch.setattr(run, "run", fake_run)
    for name in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        monkeypatch.setenv(name, "")         # main sets them; undone after
    rc = run.main(["--workload", "cli_s19.screenshot", "--seed", "1",
                   "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out.strip() == "" and "jax" in err


def test_a_run_leaves_no_process_behind(tiny_root):
    """The check's pool and multiprocessing's resource tracker end with
    the run, before the result is printed."""
    res = run_cell(tiny_root, "embed_s19.tiny_assets")
    assert res["correct"], res["checks"]
    run.stop_processes()
    assert run._descendants() == {}


def test_processes_left_running_are_stopped_and_waited_for():
    child = subprocess.Popen(
        [sys.executable, "-c", "import subprocess, time; "
         "subprocess.Popen(['sleep', '60']); time.sleep(60)"])
    try:
        deadline = time.monotonic() + 30
        while len(run._descendants()) < 2:
            assert time.monotonic() < deadline
        run.stop_processes(grace=5.0)
        assert run._descendants() == {}
        assert child.poll() is not None
    finally:
        child.kill()
        child.wait()
