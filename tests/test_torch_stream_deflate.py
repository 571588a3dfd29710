"""Differential gate for the port's stream deflate
(``pngloss_tpu_torch/csrc/host/stream_deflate.cpp``).

The clone fed in random segments must give the bytes of zlib's
deflate(level=9, Z_FILTERED, memLevel=9) over the whole input, the
configuration the reference encodes with. ``stream_test.cpp`` runs 211
cases a seed (the generators of ``native/fd_test.cpp``: stored, static and
dynamic blocks, window slides, MAX_DIST-straddling matches, run-heavy
lossy-like data), each cut into segments whose ends fall anywhere, inside
byte runs and closer together than MIN_LOOKAHEAD, and compares them with
the system libz. The stream's own canary guard is checked as
``native/``'s is: where the clone fails it, no stream begins.
"""

import os
import subprocess
import sys

import pytest

HOST = os.path.join(os.path.dirname(__file__), os.pardir,
                    "pngloss_tpu_torch", "csrc", "host")
ROOT = os.path.join(os.path.dirname(__file__), os.pardir)


def _build(target: str) -> str:
    try:
        subprocess.run(["make", "-C", HOST, "-s", target],
                       check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"cannot build {target}: {e}")
    return os.path.join(HOST, target)


@pytest.fixture(scope="module")
def stream_test():
    """The library's ISA flags (-march=native): fuzzes the AVX-512
    filter."""
    return _build("stream_test")


@pytest.fixture(scope="module")
def stream_test_portable():
    """No ISA flags: fuzzes the scalar-only walk the same sources fall
    back to on hosts without AVX-512."""
    return _build("stream_test_portable")


@pytest.mark.parametrize("seed", [0, 1])
def test_stream_clone_matches_libz(stream_test, seed):
    r = subprocess.run([stream_test, str(seed)], capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "211/211" in r.stdout


def test_stream_clone_matches_libz_portable(stream_test_portable):
    r = subprocess.run([stream_test_portable, "2"], capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "211/211" in r.stdout


@pytest.mark.parametrize("force", ["0", "1"])
def test_canary_guard(force):
    """With the canary forced to fail (PNGLOSS_FD_CANARY_FORCE_FAIL=1, a
    process of its own: the canary runs once) no stream begins, and a
    one-image call in bands still gives the one-shot bytes, counted as not
    streamed."""
    code = (
        "import sys\n"
        "sys.path.insert(0, %r)\n"
        "import numpy as np, torch\n"
        "from pngloss_tpu_torch import codec, pipeline, tracing\n"
        "from pngloss_tpu_torch.codec import stream\n"
        "print('STREAM', stream.begin(4, 3, 3) is not None)\n"
        "rng = np.random.default_rng(5)\n"
        "rgba = rng.integers(0, 256, (20, 9, 4), np.uint8)\n"
        "rgba[:, :, 3] = 255\n"
        "png = codec.encode(rgba, row_filters=None)\n"
        "(one,) = pipeline.compress_many([png], 19, device='cpu')\n"
        "pipeline.band_rows = lambda wb: 3\n"
        "with torch.profiler.profile(\n"
        "        activities=[torch.profiler.ProfilerActivity.CPU]):\n"
        "    (banded,) = pipeline.compress_many([png], 19, device='cpu')\n"
        "print('SAME', banded.unwrap() == one.unwrap())\n"
        "print('STREAMED', sum(c.n for c in tracing.records()['counts']\n"
        "                      if c.name == 'encode.streamed'))\n"
        % os.path.abspath(ROOT))
    env = dict(os.environ, PNGLOSS_FD_CANARY_FORCE_FAIL=force)
    env.pop("PNGLOSS_NO_FAST_DEFLATE", None)
    env.pop("PNGLOSS_NO_NATIVE", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    on = force == "0"
    assert f"STREAM {on}" in r.stdout
    assert "SAME True" in r.stdout
    assert f"STREAMED {int(on)}" in r.stdout
