"""The port's suite runner against ``pngloss_tpu.suite.run_suite``: the
same rows, summary and output files, on synthetic 8x8 PNGs."""

import json
import os

import numpy as np
import pytest
import torch

from pngloss_tpu import suite as jax_suite
from pngloss_tpu.codec import encode
from pngloss_tpu_torch import suite

TIMING_KEYS = ("mp_per_s", "seconds")


@pytest.fixture
def suite_files(tmp_path):
    rng = np.random.default_rng(31)
    d = tmp_path / "in"
    d.mkdir()
    for name, kind in (("a.png", "rgb"), ("b.png", "gray"), ("c.png", "rgba")):
        rgba = rng.integers(0, 256, (8, 8, 4), dtype=np.uint8)
        if kind == "gray":
            rgba[..., 0] = rgba[..., 2] = rgba[..., 1]
        if kind != "rgba":
            rgba[..., 3] = 255
        (d / name).write_bytes(encode(rgba, row_filters=None))
    (d / "d.png").write_bytes(b"not a png")
    return d


def _outputs(d):
    return {p: (d / p).read_bytes() for p in sorted(os.listdir(d))}


def test_run_suite_matches_jax(suite_files, tmp_path):
    paths = sorted(str(p) for p in suite_files.iterdir())
    rows, summary = suite.run_suite(paths, [0, 19], out_dir=str(tmp_path / "p"),
                                    device="cpu", verbose=False)
    want_rows, want = jax_suite.run_suite(
        paths, [0, 19], out_dir=str(tmp_path / "j"), verbose=False)
    assert rows == want_rows
    for k in TIMING_KEYS:
        summary.pop(k)
        want.pop(k)
    assert summary == want
    assert summary["files"] == 4 and len(rows) == 8
    assert sum("error" in r for r in rows) == 2       # d.png at each strength
    assert {r["psnr_db"] for r in rows if r.get("strength") == 0
            and "error" not in r} == {"inf"}
    assert _outputs(tmp_path / "p") == _outputs(tmp_path / "j")
    assert len(_outputs(tmp_path / "p")) == 6


def test_main_prints_summary(suite_files, tmp_path, capsys):
    rc = suite.main(["--dir", str(suite_files), "--strengths", "0,19",
                     "--files", "a.png,b.png", "--out", str(tmp_path / "o")],
                    device="cpu")
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    summary = json.loads(out[-1])
    assert summary["files"] == 2 and summary["strengths"] == [0, 19]
    assert sorted(os.listdir(tmp_path / "o")) == [
        "a-s0.png", "a-s19.png", "b-s0.png", "b-s19.png"]


def test_main_without_cuda_names_cuda(suite_files, tmp_path, capsys,
                                      monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = suite.main(["--dir", str(suite_files), "--out", str(tmp_path / "o")])
    assert rc == 2
    cap = capsys.readouterr()
    assert "CUDA is not available" in cap.err and cap.out == ""
    assert not (tmp_path / "o").exists()
