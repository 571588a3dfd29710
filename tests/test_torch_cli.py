"""The port's CLI (``pngloss_tpu_torch.cli``) against ``pngloss_tpu.cli.run``:
for each case the same exit codes, stdout bytes, output files and stderr
lines, apart from the version header. Inputs are synthetic PNGs made from
numpy seeds, at most 8x8, so the JAX side compiles once per batch size."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from pngloss_tpu import cli as jax_cli
from pngloss_tpu.codec import encode
from pngloss_tpu.codec.pypng import Chunk
from pngloss_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _png(seed: int, kind: str = "rgb", chunks=None) -> bytes:
    rng = np.random.default_rng(seed)
    rgba = rng.integers(0, 256, (8, 8, 4), dtype=np.uint8)
    if kind == "flat":
        rgba[:] = (10, 200, 30, 255)
    if kind in ("gray", "gray_alpha"):
        rgba[..., 0] = rgba[..., 2] = rgba[..., 1]
    if kind in ("gray", "rgb"):
        rgba[..., 3] = 255
    return encode(rgba, row_filters=None, chunks=chunks)


INPUTS = {
    "a.png": _png(11),
    "b.png": _png(12, "gray"),
    "c.png": _png(13, "rgba"),
    "m.png": _png(14, chunks=[Chunk(b"tEXt", b"Comment\x00seeded", 1)]),
    "bad.png": b"this is not a png",
    # its output is not smaller at -s 19: skipped under --skip-if-larger
    "f.png": _png(15, "flat"),
}

# name -> (files present before the runs, [(argv, stdin file or None,
# expected exit code), ...]) run in order in one directory
CASES = {
    "stdin_s19": ([], [(["-f", "-s", "19", "-b", "2", "-"], "a.png", 0)]),
    "stdin_s0": ([], [(["-f", "-s", "0", "-"], "b.png", 0)]),
    "output_and_guard": ([], [
        (["-s", "19", "-o", "out.png", "a.png"], None, 0),
        (["-s", "19", "-o", "out.png", "a.png"], None, 15),
        (["-f", "--no-force", "-s", "19", "-o", "out.png", "a.png"], None, 15),
        (["-f", "-s", "40", "-o", "out.png", "c.png"], None, 0),
    ]),
    "extensions": ([], [
        (["-f", "-s", "19", "a.png"], None, 0),
        (["-f", "-s", "19", "--ext", "_x.png", "a.png"], None, 0),
    ]),
    "batched": (["c-loss.png"], [
        (["-v", "-s", "19", "a.png", "missing.png", "b.png", "c.png",
          "m.png"], None, 15),
        (["-f", "-s", "19", "a.png", "c.png"], None, 0),
    ]),
    # every per-file outcome of the batched path in one list: an
    # existing output without -f, a file that cannot be read, one that
    # does not decode, one skipped as larger, good files in two buckets
    "batched_mixed": (["c-loss.png"], [
        (["-v", "-s", "19", "--skip-if-larger", "a.png", "c.png",
          "missing.png", "b.png", "bad.png", "f.png", "m.png"], None, 98),
        (["-f", "-s", "19", "--skip-if-larger", "f.png", "bad.png",
          "a.png"], None, 25),
    ]),
    "skip_if_larger": ([], [
        (["-f", "-s", "0", "--skip-if-larger", "-"], "a.png", 98),
        (["-fv", "-s", "0", "--skip-if-larger", "a.png"], None, 98),
    ]),
    "verbose": ([], [
        (["-fv", "-s", "19", "-b", "2", "-"], "a.png", 0),
        (["-fv", "-s", "19", "c.png"], None, 0),
    ]),
    # one file's name before its read and decode errors, for stdin too
    "verbose_errors": ([], [
        (["-fv", "missing.png"], None, 2),
        (["-fv", "bad.png"], None, 25),
        (["-fv", "-"], "bad.png", 25),
    ]),
    # one file's verbose lines around the stdout fallback and an -o write
    "verbose_outputs": ([], [
        (["-fv", "-s", "0", "--skip-if-larger", "-"], "a.png", 98),
        (["-v", "-s", "19", "-o", "out.png", "c.png"], None, 0),
    ]),
    "strip": ([], [
        (["-fv", "-s", "19", "--strip", "-"], "m.png", 0),
        (["-fv", "-s", "19", "-"], "m.png", 0),
    ]),
    "not_a_png": ([], [
        (["-f", "bad.png"], None, 25),
        (["-f", "bad.png", "a.png"], None, 25),
        (["-f", "-"], "bad.png", 25),
    ]),
    # tests/test_cli.py's option-error table, and two getopt errors
    "options": ([], [
        (["-s", "300", "-o", "x.png", "a.png"], None, 4),
        (["-b", "0", "-o", "x.png", "a.png"], None, 4),
        (["--ext", "x", "-o", "y", "a.png"], None, 4),
        (["-o", "x", "a.png", "b.png"], None, 4),
        ([], None, 1),
        (["-v"], None, 1),
        (["-V"], None, 0),
        (["-h"], None, 0),
        (["-f", "missing.png"], None, 2),
        (["--bogus"], None, 4),
        (["-s", "abc", "a.png"], None, 4),
    ]),
}


def _header_lines(module) -> set[str]:
    buf = io.StringIO()
    module._print_full_version(buf)
    return set(buf.getvalue().splitlines())


def _drive(run, root, case, monkeypatch, capsys, **kw):
    """Run a case's argvs in a fresh directory ``root``; returns the
    per-run (rc, stdout bytes, stdout text, stderr lines) with the module's
    version header taken out, and the directory's files afterwards."""
    present, runs = CASES[case]
    os.makedirs(root)
    for name, data in INPUTS.items():
        with open(os.path.join(root, name), "wb") as fh:
            fh.write(data)
    for name in present:
        with open(os.path.join(root, name), "wb") as fh:
            fh.write(b"already here")
    monkeypatch.chdir(root)
    header = _header_lines(jax_cli if run is jax_cli.run else cli)
    got = []
    for argv, stdin_name, _ in runs:
        stdin = io.BytesIO(INPUTS[stdin_name] if stdin_name else b"")
        stdout = io.BytesIO()
        rc = run(list(argv), stdin=stdin, stdout=stdout, **kw)
        cap = capsys.readouterr()
        got.append((rc, stdout.getvalue(),
                    [ln for ln in cap.out.splitlines() if ln not in header],
                    [ln for ln in cap.err.splitlines() if ln not in header]))
    files = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as fh:
            files[name] = fh.read()
    return got, files


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_matches_jax_cli(case, tmp_path, monkeypatch, capsys):
    ours, our_files = _drive(cli.run, str(tmp_path / "port"), case,
                             monkeypatch, capsys, device="cpu")
    theirs, their_files = _drive(jax_cli.run, str(tmp_path / "jax"), case,
                                 monkeypatch, capsys)
    assert [r[0] for r in ours] == [rc for _, _, rc in CASES[case][1]]
    for k, (mine, ref) in enumerate(zip(ours, theirs)):
        assert mine == ref, f"run {k} of {case}"
    assert our_files == their_files


def _batched(argv) -> bool:
    """Whether ``argv`` takes the batched path: several files, no stdio,
    no -o."""
    o, _ = cli.parse_options(argv)
    return len(o.files) > 1 and not (o.using_stdin or o.using_stdout
                                     or o.output_file_path)


BATCHED = sorted(c for c, (_, runs) in CASES.items()
                 if any(_batched(argv) for argv, _, _ in runs))


@pytest.mark.parametrize("case", BATCHED)
def test_batched_cli_on_a_pool_of_4_matches_jax_cli(case, tmp_path,
                                                     monkeypatch, capsys):
    """The batched path on a host pool of 4 threads: the same exit codes,
    stdout, stderr lines in their order, and files as the JAX CLI."""
    from pngloss_tpu_torch import pipeline

    monkeypatch.setattr(pipeline, "host_workers", lambda: 4)
    ours, our_files = _drive(cli.run, str(tmp_path / "port"), case,
                             monkeypatch, capsys, device="cpu")
    theirs, their_files = _drive(jax_cli.run, str(tmp_path / "jax"), case,
                                 monkeypatch, capsys)
    assert [r[0] for r in ours] == [rc for _, _, rc in CASES[case][1]]
    assert ours == theirs
    assert our_files == their_files


def test_batched_encodes_overlap(tmp_path, monkeypatch, capsys):
    """The first two encodes each wait at a barrier of two before they
    run, so a run whose encodes went one after another would break it:
    the batched case finishes, with the JAX CLI's output and files."""
    import itertools
    import threading

    from pngloss_tpu_torch import codec, pipeline

    monkeypatch.setattr(pipeline, "host_workers", lambda: 4)
    barrier, real = threading.Barrier(2, timeout=10), codec.encode
    calls = itertools.count()

    def encode(*a, **kw):
        if next(calls) < 2:
            barrier.wait()
        return real(*a, **kw)

    monkeypatch.setattr(codec, "encode", encode)
    ours, our_files = _drive(cli.run, str(tmp_path / "port"), "batched",
                             monkeypatch, capsys, device="cpu")
    monkeypatch.setattr(codec, "encode", real)
    theirs, their_files = _drive(jax_cli.run, str(tmp_path / "jax"),
                                 "batched", monkeypatch, capsys)
    assert next(calls) > 2 and not barrier.broken
    assert ours == theirs
    assert our_files == their_files


def test_verbose_batched_reports_buckets(tmp_path, monkeypatch, capsys):
    """The per-bucket line comes from the port's host-side bucket shape."""
    ours, _ = _drive(cli.run, str(tmp_path / "port"), "batched",
                     monkeypatch, capsys, device="cpu")
    err = ours[0][3]
    assert "  optimizing bucket 1/2: 2 image(s) at 8x8x3bpp" in err
    assert "  optimizing bucket 2/2: 1 image(s) at 8x8x1bpp" in err
    assert err[-1] == ("There were errors compressing 2 files out of a "
                       "total of 5 files.")


def test_version_header_names_the_port(capsys):
    cli._print_full_version(sys.stdout)
    out = capsys.readouterr().out
    assert out.startswith("pngloss-tpu-torch ")
    assert "torch " in out and "zlib " in out
    assert "jax" not in out.lower()


def _python_m(args, cwd, **env):
    return subprocess.run(
        [sys.executable, "-m", "pngloss_tpu_torch", *args], cwd=cwd,
        env=dict(os.environ, PYTHONPATH=REPO, **env), capture_output=True,
        text=True, timeout=300)


def test_module_entry_point(tmp_path):
    from pngloss_tpu.version import __version__

    proc = _python_m(["-V"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == __version__
    proc = _python_m(["-h"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("pngloss-tpu-torch ")
    assert "usage:  pngloss [options]" in proc.stdout

    # with CUDA hidden a compress fails, names CUDA and writes nothing
    (tmp_path / "a.png").write_bytes(INPUTS["a.png"])
    proc = _python_m(["-f", "-s", "19", "a.png"], tmp_path,
                     CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == cli.NO_CUDA, proc.stderr
    assert "CUDA is not available" in proc.stderr
    assert sorted(os.listdir(tmp_path)) == ["a.png"]
