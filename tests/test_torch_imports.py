"""The port imports nothing of the JAX package: no module of
``pngloss_tpu_torch`` and no line of ``chip_smoke.py``, ``bench_torch.py``
or ``tools/fuzz_torch.py`` imports ``pngloss_tpu`` or ``jax`` (an AST
scan, one case per file), the port runs
in a process that refuses both (a ``sys.meta_path`` finder; there
``bench_torch.py`` imports and builds its bench batch too), and each of
the port's copies of a JAX-free host module equals its original on small
inputs."""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from pngloss_tpu import codec as jax_codec
from pngloss_tpu import fcgi as jax_fcgi
from pngloss_tpu import metrics as jax_metrics
from pngloss_tpu import webassets as jax_webassets
from pngloss_tpu.core import reference as jax_reference
from pngloss_tpu_torch import codec, fcgi, metrics, reference, webassets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFUSED = ("pngloss_tpu", "jax", "jaxlib")
PORT_FILES = sorted(
    os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "pngloss_tpu_torch", "**", "*.py"),
        recursive=True)) + ["bench_torch.py", "chip_smoke.py",
                            "tools/fuzz_torch.py"]


def _imported(path: str) -> list[tuple[int, str]]:
    """(line, module) of every absolute import in the file at ``path``."""
    with open(os.path.join(REPO, path)) as fh:
        tree = ast.parse(fh.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.lineno, node.module))
    return out


@pytest.mark.parametrize("path", PORT_FILES)
def test_file_imports_no_jax_package(path):
    bad = [(line, m) for line, m in _imported(path)
           if m.split(".")[0] in REFUSED]
    assert not bad, f"{path} imports {bad}"


def test_scan_covers_the_port():
    assert "chip_smoke.py" in PORT_FILES
    assert "bench_torch.py" in PORT_FILES
    assert "tools/fuzz_torch.py" in PORT_FILES
    for module in ("pngloss_tpu_torch/codec/native.py",
                   "pngloss_tpu_torch/reference.py",
                   "pngloss_tpu_torch/website.py",
                   "pngloss_tpu_torch/ops/optimize_gpu.py"):
        assert module in PORT_FILES


RUN_REFUSING = r"""
import importlib, pkgutil, sys, threading, urllib.request

REFUSED = ("pngloss_tpu", "jax", "jaxlib")


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused: {name}")
        return None


sys.meta_path.insert(0, Refuse())
import numpy as np
import pngloss_tpu_torch

names = ["pngloss_tpu_torch.__main__"] + [
    m.name for m in pkgutil.walk_packages(pngloss_tpu_torch.__path__,
                                          "pngloss_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from pngloss_tpu_torch import cli, codec, pipeline, website

rgba = np.random.default_rng(61).integers(0, 256, (8, 8, 4), np.uint8)
rgba[..., 3] = 255
png = codec.encode(rgba, row_filters=None)
out = pipeline.compress_bytes(png, 19, device="cpu")
assert codec.decode(out).rgba.shape == (8, 8, 4)
assert cli.run(["-V"], device="cpu") == 0
srv = website.make_server(port=0, store=sys.argv[1], device="cpu")
threading.Thread(target=srv.serve_forever, daemon=True).start()
b = "XrefuseX"
body = (f"--{b}\r\nContent-Disposition: form-data; name=\"file\"\r\n\r\n"
        ).encode() + png + f"\r\n--{b}--\r\n".encode()
req = urllib.request.Request(
    f"http://127.0.0.1:{srv.server_address[1]}/compress.cgi", data=body,
    headers={"Content-Type": f"multipart/form-data; boundary={b}"})
assert urllib.request.urlopen(req, timeout=300).status == 200
srv.shutdown()
srv.server_close()
import bench_torch
batch, bpp, mp = bench_torch.bench_batch(bench_torch.bench_base())
assert batch.shape == (25, 512, 1536) and bpp == 3
bad = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not bad, bad
print("modules", len(names))
"""


def test_runs_where_the_jax_package_is_refused(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", RUN_REFUSING, str(tmp_path / "store")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.split()
    assert lines[0] == "0.1.0", proc.stdout          # cli -V
    assert lines[-2] == "modules" and int(lines[-1]) >= 25, proc.stdout


def _rgba(seed: int, kind: str) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rgba = rng.integers(0, 256, (6, 7, 4), np.uint8)
    if kind in ("gray", "gray_alpha"):
        rgba[..., 0] = rgba[..., 2] = rgba[..., 1]
    if kind in ("gray", "rgb"):
        rgba[..., 3] = 255
    if kind in ("rgba", "gray_alpha"):
        rgba[::2, ::3, 3] = 0
    return rgba


KINDS = ("gray", "gray_alpha", "rgb", "rgba")


@pytest.mark.parametrize("kind", KINDS)
def test_codec_copy_round_trips_like_the_original(kind):
    rgba = _rgba(62, kind)
    filters = np.arange(rgba.shape[0], dtype=np.int8) % 5
    chunks = [codec.pypng.Chunk(b"tEXt", b"Comment\x00copy", 1)]
    jchunks = [jax_codec.pypng.Chunk(b"tEXt", b"Comment\x00copy", 1)]
    for kw, jkw in (({}, {}), ({"row_filters": filters, "chunks": chunks},
                               {"row_filters": filters, "chunks": jchunks})):
        png = codec.encode(rgba, **kw)
        assert png == jax_codec.encode(rgba, **jkw)
        for data in (png, jax_codec.encode(rgba, **jkw)):
            mine, theirs = codec.decode(data), jax_codec.decode(data)
            np.testing.assert_array_equal(mine.rgba, theirs.rgba)
            assert (mine.gamma, mine.color_transform) == (
                theirs.gamma, theirs.color_transform)
            assert [(c.name, c.data) for c in mine.chunks] == [
                (c.name, c.data) for c in theirs.chunks]
    assert codec.detect_colorspace(rgba) == jax_codec.detect_colorspace(rgba)
    with pytest.raises(codec.PngDecodeError):
        codec.decode(b"not a png")
    with pytest.raises(codec.TooLargeFile):
        codec.encode(rgba, maximum_file_size=10)


@pytest.mark.parametrize("kind,strength,rows",
                         [(k, s, r) for k in KINDS for s, r in
                          ((19, True), (0, True), (45, False))])
def test_reference_copy_gives_the_original_planes(kind, strength, rows):
    rgba = _rgba(63 + strength, kind)
    q, f = reference.optimize_rgba(rgba, strength, 2, rows)
    q_ref, f_ref = jax_reference.optimize_rgba(rgba, strength, 2, rows)
    np.testing.assert_array_equal(q, q_ref)
    np.testing.assert_array_equal(f, f_ref)
    work = rgba[..., :3].reshape(6, 21)
    assert (reference.adaptive_filter_for_row(work[0], work[1], 3, 7)
            == jax_reference.adaptive_filter_for_row(work[0], work[1], 3, 7))


def test_psnr_copy():
    a, b = _rgba(64, "rgba"), _rgba(65, "rgba")
    assert metrics.psnr_rgba(a, b) == jax_metrics.psnr_rgba(a, b)
    assert metrics.psnr_rgba(a, a) == jax_metrics.psnr_rgba(a, a) == float("inf")


@pytest.mark.parametrize("content", [b"", b"x" * 7, bytes(range(256)) * 255],
                         ids=["empty", "padded", "largest"])
def test_fcgi_copy_frames_records_alike(content):
    assert (fcgi._pack_record(fcgi.FCGI_STDOUT, 3, content)
            == jax_fcgi._pack_record(jax_fcgi.FCGI_STDOUT, 3, content))
    pairs = {"REQUEST_METHOD": "GET", "K" * 200: "v" * 300,
             "EMPTY": "", "CONTENT": content[:40].hex()}
    packed = fcgi._pack_pairs(pairs)
    assert packed == jax_fcgi._pack_pairs(pairs)
    assert fcgi._parse_pairs(packed) == jax_fcgi._parse_pairs(packed) == pairs


@pytest.mark.parametrize("page", ["index", "example", "result", "style"])
def test_webassets_copy_pages(page):
    def render(mod):
        if page == "index":
            return mod.index_page("/pngloss/")
        if page == "example":
            return mod.example_page()
        if page == "style":
            return mod.STYLE_CSS
        return mod.result_page("/", sum224="abc_-", strength=40, bleed=3,
                               strip=1, in_size=123456, out_size=7890,
                               width=64, height=48)
    assert render(webassets) == render(jax_webassets)
