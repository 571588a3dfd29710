#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (``pngloss_tpu_torch``) on one GPU.

The port's counterpart of ``bench.py``, the TPU benchmark, which stays as
it is. Run from the root of the repository, on a machine with a CUDA
card:

    python3 bench_torch.py                  # every case below but setup
    python3 bench_torch.py --case bench --case photo_s19 --runs 3
    python3 bench_torch.py --case setup     # the kernels' cold build

Cases (``--case NAME``, repeatable; each runs on one card; every input is
synthetic and seeded, drawn by ``chip_smoke.py``'s generators, so a case
named after a phase of ``chip_smoke.py`` runs that phase's images):

  bench           bench.py's workload on the card. Device rate:
                  ``ops.optimize_batch_auto`` at -s 19 -b 2 on 25 512x512
                  RGB planes already on the card (one image with bench.py's
                  rng(0) stripe over the first 4*bpp bytes of each row),
                  timed by CUDA events; stream rate: 100 such planes (an
                  rng(1) stripe) through ``pipeline.dispatch_buckets`` /
                  ``collect_bucket``, timed by the wall clock
  batch16_s19     compress_many, 16 x 512x512 RGB PNGs at -s 19 (phase 5)
  full_card_s19   compress_many, 132 x 512x512 RGB at -s 19 (phase 14)
  corpus_ragged   compress_many over phase 13's corpus: 100 PNGs of
                  40-400 px, bpp 1-4, then 4 x 512x512 RGB (66 buckets)
  textured_s90    compress_many over phase 6's batch (8 smooth + 8 noise)
                  at -s 90: row 0 retries up to 48 times
  lossless_s0     compress_many, phase 5's 16 images at -s 0
  rgba_s19        compress_many, 16 x 512x512 RGBA at -s 19 under an alpha
                  of tiles, fully, partly and not transparent (bpp 4)
  suite_mixed     compress_many, 12 PNGs of 512x512 (3 at each bpp 1-4),
                  each at -s 0, 19, 40 and 90: 48 jobs in one call, in
                  suite.run_suite's order
  photo_s19       compress_many, one 4000x3000 RGB photo at -s 19
  screenshot_s19  compress_many, one 1920x1080 RGB screenshot at -s 19
  embed16         optimize_rgba_batch(use_row_filters=False) on phase 6's
                  batch at -s 19, arrays in and out
  embed_gray16    the same on 16 x 512x512 gray (bpp 1, phase 14)
  setup           (run only when named) the kernels' cold build: in a
                  subprocess, on a copy of the package in a temporary
                  directory, the seconds to the first finished call; the
                  checkout's build/pngloss_tpu_torch/ is left as it was

Each case: one warm-up run, then ``--runs`` timed runs (default 5; a
measurement takes at least 3, ``chip_smoke.py`` runs 1 as a smoke check).
It prints one JSON line: the median, min and max wall time of a run, the
spread (max - min) / median, MP/s at the median (input pixels by
bench.py's arithmetic, b * h * (w_bytes / bpp) / 1e6), the
``tracing.stage`` seconds of each run (summed over threads) and their
medians, the kernel launches of the timed runs, the card (name and power
limit, as nvidia-smi gives them), os.cpu_count() and the torch, CUDA and
nvcc versions.

Gates, not metrics: every timed run's output (PNG bytes, or planes and
filters) equals the warm-up's, and a cut-down copy of the case (the same
images cropped to CUT_SIDE px a side, CUT_JOBS jobs) gives on the card
what the same entry point gives with ``device="cpu"`` and what
``pngloss_tpu_torch.reference`` gives. A case whose gate fails prints no
line, and the run exits 1.

The last line is bench.py's record for the ``bench`` case:
{"metric": "1mp_images_per_sec_per_chip", "value", "unit", "stream_mp_s",
"device"}. bench.py's ``vs_baseline`` is left out: its divisor, 1,250
img(1MP)/s a chip, is the TPU north star's share of one chip
(BASELINE.json), a target set for a TPU.

Without CUDA it exits 2, names CUDA on stderr and times nothing: no case
is ever timed on the CPU, which runs only the gates' cut-down copies.

Usage: python3 bench_torch.py [--case NAME ...] [--runs N]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Callable

import numpy as np

import chip_smoke as smoke

RUNS = 5
# the gates' cut-down copy of a case: images cropped to CUT_SIDE px a side,
# CUT_JOBS jobs (Case.cut picks them)
CUT_SIDE, CUT_JOBS = 32, 4
# bench.py's workload: its chunk of planes for the device rate, its stream
# batch (PNGLOSS_BENCH_BATCH), -s 19 -b 2
BENCH_IMAGES, STREAM_IMAGES, BENCH_STRENGTH, BLEED = 25, 100, 19, 2
# cycles the card spins before a CUDA-event timed call (~5 ms), so that the
# host has queued the whole call before it starts
SPIN_CYCLES = 10_000_000
SUITE_STRENGTHS, SUITE_FILES = (0, 19, 40, 90), 12
RGBA_SEED, SUITE_SEED, TILE = smoke.SEED + 18, smoke.SEED + 19, 16
SETUP_TIMEOUT_S = 900


class GateError(Exception):
    """An output differs from the one it is held to."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------- inputs

def phase5_images() -> list[np.ndarray]:
    """``chip_smoke.py`` phase 5's 16 512x512 RGB images."""
    return list(smoke.synthetic_rgb(np.random.default_rng(smoke.SEED + 4),
                                    smoke.N_IMAGES, smoke.SIDE, smoke.SIDE))


def full_card_images() -> list[np.ndarray]:
    """Phase 14's full card: phase 5's images and 116 more."""
    more = smoke.synthetic_rgb(np.random.default_rng(smoke.SEED + 15),
                               smoke.CARD_IMAGES[0] - smoke.N_IMAGES,
                               smoke.SIDE, smoke.SIDE, np.int16)
    return phase5_images() + list(more)


def rgba_images(rng, n: int) -> list[np.ndarray]:
    """n 512x512 RGBA images like UI assets: ``synthetic_rgb``'s colours
    under an alpha of TILE-px tiles that are in turn fully transparent,
    partly transparent (a ramp over 1-254) and opaque, the turn shifted per
    image; any 2 x 2 tiles hold all three."""
    out = smoke.synthetic_rgb(rng, n, smoke.SIDE, smoke.SIDE)
    y, x = np.mgrid[0:smoke.SIDE, 0:smoke.SIDE]
    ramp = (1 + (x + y) % 254).astype(np.uint8)
    for im, shift in zip(out, rng.integers(0, 3, n)):
        kind = (y // TILE + 2 * (x // TILE) + shift) % 3
        im[..., 3] = np.where(kind == 0, 0, np.where(kind == 1, ramp, 255))
    return list(out)


def suite_images(rng) -> list[np.ndarray]:
    """SUITE_FILES 512x512 images, in turn gray, gray+alpha, RGB and RGBA
    (``chip_smoke.with_kind``): three at each bpp."""
    return [smoke.with_kind(im, k) for k, im in enumerate(
        smoke.synthetic_rgb(rng, SUITE_FILES, smoke.SIDE, smoke.SIDE))]


@dataclasses.dataclass(frozen=True)
class Case:
    """One named case: an entry point, its images and strengths.

    ``strength`` is one int for every image, or a tuple: each image at each
    strength, strength-major, as ``suite.run_suite`` lays out its jobs.
    ``cut``: the jobs the gates' cut-down copy keeps."""
    entry: str                                 # compress_many / embedding
    images: Callable[[], list]                 # RGBA (H, W, 4) uint8 each
    strength: int | tuple[int, ...]
    cut: tuple[int, ...] = (0, 1, 2, 3)


CASES = {
    "batch16_s19": Case("compress_many", phase5_images, 19),
    "full_card_s19": Case("compress_many", full_card_images, 19),
    "corpus_ragged": Case("compress_many", lambda: smoke.dispatch_images(
        np.random.default_rng(smoke.DISPATCH_SEED)), 19),
    # two smooth and two noise images in the cut-down copy
    "textured_s90": Case("compress_many", lambda: list(smoke.embedding_batch(
        np.random.default_rng(smoke.EMBED_SEED))), 90, (0, 1, 8, 9)),
    "lossless_s0": Case("compress_many", phase5_images, 0),
    "rgba_s19": Case("compress_many", lambda: rgba_images(
        np.random.default_rng(RGBA_SEED), smoke.N_IMAGES), 19),
    # the cut-down copy: files 0-3 (bpp 1-4), each at one of the strengths
    "suite_mixed": Case("compress_many", lambda: suite_images(
        np.random.default_rng(SUITE_SEED)), SUITE_STRENGTHS,
        (0, SUITE_FILES + 1, 2 * SUITE_FILES + 2, 3 * SUITE_FILES + 3)),
    "photo_s19": Case("compress_many", lambda: [smoke.photo_rgb(
        np.random.default_rng(smoke.USERS_SEED), *smoke.PHOTO)], 19, (0,)),
    "screenshot_s19": Case("compress_many", lambda: [smoke.screenshot_rgb(
        np.random.default_rng(smoke.USERS_SEED), *smoke.SCREEN)], 19, (0,)),
    "embed16": Case("embedding", lambda: list(smoke.embedding_batch(
        np.random.default_rng(smoke.EMBED_SEED))), 19, (0, 1, 8, 9)),
    "embed_gray16": Case("embedding", lambda: list(smoke.gray_rgb(
        np.random.default_rng(smoke.SEED + 17), smoke.GRAY_IMAGES)), 19),
}
NAMES = ("bench", *CASES)


@dataclasses.dataclass
class Inputs:
    """A case's call: ``files`` are the entry point's inputs (PNG bytes
    for compress_many, RGBA arrays in embedding mode), one per job."""
    entry: str
    files: list
    strength: int | list[int]
    images: int                                # distinct images
    mp: float


def case_inputs(case: Case, images, cut: bool = False) -> Inputs:
    """The entry point's inputs for ``images``, or for the cut-down copy
    (the jobs ``case.cut``, each image cropped to CUT_SIDE px a side)."""
    n = len(images)
    if isinstance(case.strength, int):
        idx, strength = list(range(n)), case.strength
    else:
        idx = [i for _ in case.strength for i in range(n)]
        strength = [s for s in case.strength for _ in range(n)]
    if cut:
        keep = case.cut[:CUT_JOBS]
        images = [np.ascontiguousarray(images[idx[j]][:CUT_SIDE, :CUT_SIDE])
                  for j in keep]
        if not isinstance(strength, int):
            strength = [strength[j] for j in keep]
        idx = list(range(len(keep)))
    if case.entry == "compress_many":
        pngs = smoke.encode_all(images)                 # once per image
        files = [pngs[i] for i in idx]
    else:
        files = [images[i] for i in idx]
    # bench.py's arithmetic: w_bytes / bpp is the width in pixels
    mp = sum(images[i].shape[0] * images[i].shape[1] for i in idx) / 1e6
    return Inputs(case.entry, files, strength, len(images), mp)


def megapixels(b: int, h: int, w_bytes: int, bpp: int) -> float:
    """Megapixels of b planes (h, w_bytes) at bpp, as bench.py counts."""
    return b * h * (w_bytes // bpp) / 1e6


def bench_base() -> np.ndarray:
    """The stand-in for bench.py's lena (512x512 RGB, which neither the
    repository nor the card's machine holds): ``synthetic_rgb``, seed
    SEED."""
    return smoke.synthetic_rgb(np.random.default_rng(smoke.SEED), 1,
                               smoke.SIDE, smoke.SIDE)[0]


def bench_batch(rgba: np.ndarray, chunk_b: int = BENCH_IMAGES):
    """``bench.make_bench_batch`` on ``rgba``: the image's working plane
    stacked chunk_b deep, an rng(0) stripe over the first 4*bpp bytes of
    every row. Returns (batch (chunk_b, H, W*bpp) uint8, bpp, MP)."""
    from pngloss_tpu_torch.pipeline import reduce_colorspace

    work, bpp = reduce_colorspace(rgba)
    rng = np.random.default_rng(0)
    batch = np.stack([work] * chunk_b)
    batch[:, :, : 4 * bpp] = rng.integers(
        0, 256, (chunk_b, work.shape[0], 4 * bpp), np.uint8)
    return batch, bpp, megapixels(chunk_b, *work.shape, bpp)


def stream_works(rgba: np.ndarray, n: int = STREAM_IMAGES):
    """bench.py's stream: n copies of the image's working plane, each with
    its own rng(1) stripe. Returns (planes, bpp, MP)."""
    from pngloss_tpu_torch.pipeline import reduce_colorspace

    work, bpp = reduce_colorspace(rgba)
    rng = np.random.default_rng(1)
    works = []
    for _ in range(n):
        w = work.copy()
        w[:, : 4 * bpp] = rng.integers(0, 256, (w.shape[0], 4 * bpp),
                                       np.uint8)
        works.append(w)
    return works, bpp, megapixels(n, *work.shape, bpp)


# ------------------------------------------------------- entry points

def run_entry(inp: Inputs, device) -> list:
    """The case's entry point on ``device``: PNG bytes per job, or
    (planes, filters) per job in embedding mode."""
    from pngloss_tpu_torch import pipeline

    if inp.entry == "compress_many":
        return [r.unwrap() for r in pipeline.compress_many(
            inp.files, inp.strength, BLEED, device=device)]
    qs, fs = pipeline.optimize_rgba_batch(inp.files, inp.strength, BLEED,
                                          use_row_filters=False,
                                          device=device)
    return list(zip(qs, fs))


def reference_outputs(inp: Inputs) -> list:
    """What ``pngloss_tpu_torch.reference`` (the scalar model, plus the host
    encoder for PNGs) gives for each job of ``inp``."""
    from pngloss_tpu_torch import reference
    from pngloss_tpu_torch.codec import decode, encode

    out = []
    for j, data in enumerate(inp.files):
        s = inp.strength if isinstance(inp.strength, int) else inp.strength[j]
        if inp.entry == "embedding":
            out.append(reference.optimize_rgba(data, s, BLEED, False))
            continue
        img = decode(data)
        q, f = reference.optimize_rgba(img.rgba, s, BLEED)
        out.append(encode(q, row_filters=f, gamma=img.gamma,
                          color_transform=img.color_transform,
                          chunks=img.chunks))
    return out


def planes_entry(planes: np.ndarray, bpp: int, device) -> list:
    """``ops.optimize_batch_auto`` (the device rate's call): (planes,
    filters) per image, on the host."""
    from pngloss_tpu_torch import ops

    q, f = ops.optimize_batch_auto(planes, BENCH_STRENGTH, BLEED, bpp=bpp,
                                   device=device)
    q, f = q.cpu().numpy(), f.cpu().numpy()
    return [(q[k], f[k]) for k in range(len(q))]


def stream_call(works, bpp: int, device) -> list:
    """bench.py's stream: ``dispatch_buckets``, then ``collect_bucket`` on
    each pending bucket. Returns [(image indices, (qs, fs))] per bucket."""
    from pngloss_tpu_torch import pipeline

    return [(p.idxs, pipeline.collect_bucket(p)) for p in
            pipeline.dispatch_buckets(works, [bpp] * len(works),
                                      BENCH_STRENGTH, BLEED, device=device)]


def per_image(buckets) -> list:
    """``stream_call``'s buckets as (planes, filters) per image."""
    out = [None] * sum(len(idxs) for idxs, _ in buckets)
    for idxs, (qs, fs) in buckets:
        for k, i in enumerate(idxs):
            out[i] = (qs[k].copy(), fs[k].copy())
    return out


def plane_reference(planes, bpp: int) -> list:
    """The scalar model on working planes, CLI mode, at bench.py's
    strength: (planes, filters) per plane."""
    from pngloss_tpu_torch import reference

    return [reference.optimize_image(np.asarray(p), bpp, BENCH_STRENGTH,
                                     BLEED) for p in planes]


# ---------------------------------------------------------------- gates

def first_difference(got: list, want: list):
    """Index of the first job whose output differs (PNG bytes, or every
    array of a tuple), "count" if the counts differ, else None."""
    if len(got) != len(want):
        return "count"
    for j, (g, w) in enumerate(zip(got, want)):
        if isinstance(g, bytes) or isinstance(w, bytes):
            same = g == w
        else:
            same = len(g) == len(w) and all(
                np.array_equal(np.asarray(a), np.asarray(b))
                for a, b in zip(g, w))
        if not same:
            return j
    return None


def check_same(what: str, got: list, want: list) -> None:
    j = first_difference(got, want)
    if j is not None:
        raise GateError(f"{what}: job {j} differs")


def gate_cut(name: str, device, got: list, cpu: list, ref: list) -> None:
    """The cut-down copy's gate: the output on ``device`` equals the same
    entry point's with device="cpu" and the scalar model's."""
    check_same(f"{name}: cut-down copy on {device} against device='cpu'",
               got, cpu)
    check_same(f"{name}: cut-down copy on {device} against "
               "pngloss_tpu_torch.reference", got, ref)


def cut_outputs(case: Case, images, device):
    """The cut-down copy's outputs on ``device``, with device="cpu" and
    from the scalar model."""
    inp = case_inputs(case, images, cut=True)
    return run_entry(inp, device), run_entry(inp, "cpu"), \
        reference_outputs(inp)


# ---------------------------------------------------------------- timing

def spread(values) -> dict:
    med = statistics.median(values)
    return {"median": med, "min": min(values), "max": max(values),
            "spread": (max(values) - min(values)) / med, "runs": list(values)}


def wall_fields(walls) -> dict:
    s = spread(walls)
    return {"median_s": s["median"], "min_s": s["min"], "max_s": s["max"],
            "spread": s["spread"], "wall_s": s["runs"]}


def timed_runs(call, runs: int, need, post=lambda out: out):
    """A warm-up call, then ``runs`` calls timed by the wall clock, each
    output (``post`` of what ``call`` returns, outside the timed region)
    equal to the warm-up's. Returns (walls, stage seconds per run, the
    timed runs' kernel launches; a kernel of ``need`` never launched
    raises)."""
    import torch

    from pngloss_tpu_torch import tracing

    want = post(call())
    torch.cuda.synchronize()
    smoke.reset_counts()
    walls, stages = [], []
    for r in range(runs):
        tracing.snapshot(reset=True)
        t0 = time.perf_counter()
        got = call()
        walls.append(time.perf_counter() - t0)
        stages.append(smoke._stage_sums(tracing.snapshot(reset=True)))
        check_same(f"timed run {r + 1} against the warm-up", post(got), want)
    return walls, stages, smoke.read_counts("bench_torch", need)


def stage_medians(stages: list[dict]) -> dict:
    return {k: statistics.median(s[k] for s in stages) for k in stages[0]}


def device_runs(batch: np.ndarray, bpp: int, runs: int):
    """The device rate's calls on ``batch``, uploaded to the card once,
    after a warm-up, each timed by CUDA events behind a spin, each output
    equal to the warm-up's on the card. Returns (ms per run, the timed
    runs' kernel launches)."""
    import torch

    from pngloss_tpu_torch import ops

    batch_dev = torch.as_tensor(batch, device="cuda")

    def call():
        return ops.optimize_batch_auto(batch_dev, BENCH_STRENGTH, BLEED,
                                       bpp=bpp, device=batch_dev.device)

    want = call()
    torch.cuda.synchronize()
    smoke.reset_counts()
    ms = []
    for r in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        got = call()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise GateError(f"bench: device run {r + 1} differs from the "
                            "warm-up")
    return ms, smoke.read_counts("bench (device rate)", smoke.CLI_KERNELS)


def run_bench(runs: int, info: dict) -> dict:
    """The ``bench`` case: bench.py's device rate and stream rate."""
    base = bench_base()
    batch, bpp, chunk_mp = bench_batch(base)
    works, _, stream_mp = stream_works(base)
    cut = batch[:CUT_JOBS, :CUT_SIDE, :CUT_SIDE * bpp]
    gate_cut("bench (optimize_batch_auto)", "cuda",
             planes_entry(cut, bpp, "cuda"), planes_entry(cut, bpp, "cpu"),
             plane_reference(cut, bpp))
    cut_works = [w[:CUT_SIDE, :CUT_SIDE * bpp].copy()
                 for w in works[:CUT_JOBS]]
    gate_cut("bench (dispatch_buckets)", "cuda",
             per_image(stream_call(cut_works, bpp, "cuda")),
             per_image(stream_call(cut_works, bpp, "cpu")),
             plane_reference(cut_works, bpp))

    ms, device_launches = device_runs(batch, bpp, runs)
    walls, stages, launches = timed_runs(
        lambda: stream_call(works, bpp, "cuda"), runs, smoke.CLI_KERNELS,
        per_image)
    dev = spread(ms)
    return {"case": "bench", "entry": "ops.optimize_batch_auto; "
            "pipeline.dispatch_buckets + collect_bucket", "strength":
            BENCH_STRENGTH, "device_images": BENCH_IMAGES,
            "device_mp": chunk_mp, "device_ms": dev,
            "img_1mp_s": chunk_mp / (dev["median"] / 1e3),
            "device_launches": device_launches,
            "images": STREAM_IMAGES, "jobs": STREAM_IMAGES, "mp": stream_mp,
            "runs": runs, **wall_fields(walls),
            "mp_s": stream_mp / statistics.median(walls),
            "stages": stage_medians(stages), "stages_runs": stages,
            "launches": launches, "gate": {
                "runs_equal": True, "cut_jobs": CUT_JOBS,
                "cut_side": CUT_SIDE, "cpu": True, "reference": True},
            **info}


def run_case(name: str, runs: int, info: dict) -> dict:
    """A case of CASES: its gates, then its timed runs on the card."""
    case = CASES[name]
    images = case.images()
    gate_cut(name, "cuda", *cut_outputs(case, images, "cuda"))
    inp = case_inputs(case, images)
    need = smoke.CLI_KERNELS if case.entry == "compress_many" else \
        smoke.EMBED_KERNELS
    walls, stages, launches = timed_runs(lambda: run_entry(inp, "cuda"),
                                         runs, need)
    return {"case": name, "entry": case.entry, "strength": case.strength,
            "images": inp.images, "jobs": len(inp.files), "mp": inp.mp,
            "runs": runs, **wall_fields(walls),
            "mp_s": inp.mp / statistics.median(walls),
            "stages": stage_medians(stages), "stages_runs": stages,
            "launches": launches, "gate": {
                "runs_equal": True, "cut_jobs": len(case.cut[:CUT_JOBS]),
                "cut_side": CUT_SIDE, "cpu": True, "reference": True},
            **info}


# ---------------------------------------------------------------- set-up

SETUP = r"""
import json, sys, time
t0 = time.perf_counter()
import torch
import pngloss_tpu_torch
from pngloss_tpu_torch.ops import _build
from pngloss_tpu_torch.pipeline import compress_many
t1 = time.perf_counter()
with open(sys.argv[1], "rb") as fh:
    png = fh.read()
out = compress_many([png], int(sys.argv[3]), device="cuda")[0].unwrap()
torch.cuda.synchronize()
t2 = time.perf_counter()
with open(sys.argv[2], "wb") as fh:
    fh.write(out)
print(json.dumps({"import_s": t1 - t0, "first_call_s": t2 - t0,
                  "build_s": _build.build_info["seconds"],
                  "compiled": _build.build_info["compiled"],
                  "package": pngloss_tpu_torch.__file__,
                  "build_root": _build.BUILD_ROOT}))
"""


def tree_state(path: str):
    """(relative path, size, mtime) of every file under ``path``, or None
    when it does not exist."""
    if not os.path.isdir(path):
        return None
    out = []
    for d, _, names in os.walk(path):
        for n in names:
            st = os.stat(os.path.join(d, n))
            out.append((os.path.relpath(os.path.join(d, n), path),
                        st.st_size, st.st_mtime_ns))
    return sorted(out)


def cold_copy(dst: str) -> None:
    """The package and the host codec's ``native/`` (with its library, so
    that only the kernels build) copied into ``dst``."""
    import pngloss_tpu_torch
    from pngloss_tpu_torch.codec import native

    native.load()                                    # builds it if missing
    shutil.copytree(os.path.dirname(pngloss_tpu_torch.__file__),
                    os.path.join(dst, "pngloss_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(native._NATIVE_DIR, os.path.join(dst, "native"),
                    ignore=shutil.ignore_patterns("fd_test*"))


def run_setup(runs: int, info: dict) -> dict:
    """The ``setup`` case: ``runs`` times, a subprocess on a fresh copy of
    the package builds the kernels cold and compresses one small PNG; its
    bytes must be the scalar model's, and the checkout's build cache must
    be left as it was."""
    from pngloss_tpu_torch.ops import _build

    image = np.ascontiguousarray(phase5_images()[0][:CUT_SIDE, :CUT_SIDE])
    inp = case_inputs(Case("compress_many", None, BENCH_STRENGTH), [image])
    want = reference_outputs(inp)[0]
    before = tree_state(_build.BUILD_ROOT)
    recs = []
    for r in range(runs):
        with tempfile.TemporaryDirectory() as tmp:
            cold_copy(tmp)
            src, dst = os.path.join(tmp, "in.png"), os.path.join(tmp,
                                                                 "out.png")
            with open(src, "wb") as fh:
                fh.write(inp.files[0])
            proc = subprocess.run(
                [sys.executable, "-c", SETUP, src, dst, str(BENCH_STRENGTH)],
                cwd=tmp, env=dict(os.environ, PYTHONPATH=tmp),
                capture_output=True, text=True, timeout=SETUP_TIMEOUT_S)
            if proc.returncode:
                raise RuntimeError(f"setup run {r + 1} exited "
                                   f"{proc.returncode}:\n{proc.stderr}")
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            if not (rec["compiled"] and rec["package"].startswith(tmp)
                    and rec["build_root"].startswith(tmp)):
                raise GateError(f"setup run {r + 1} did not build its own "
                                f"copy cold: {rec}")
            with open(dst, "rb") as fh:
                if fh.read() != want:
                    raise GateError(f"setup run {r + 1}: the first call's "
                                    "bytes differ from the scalar model's")
        recs.append(rec)
        log(f"setup run {r + 1}: first call {rec['first_call_s']:.1f} s, "
            f"kernels built in {rec['build_s']:.1f} s")
    if tree_state(_build.BUILD_ROOT) != before:
        raise GateError(f"setup changed {_build.BUILD_ROOT}")
    return {"case": "setup", "entry": "compress_many (first call of a "
            "fresh process on a fresh copy)", "runs": runs,
            "first_call_s": spread([r["first_call_s"] for r in recs]),
            "build_s": spread([r["build_s"] for r in recs]),
            "import_s": spread([r["import_s"] for r in recs]),
            "gate": {"reference": True, "build_cache_untouched": True},
            **info}


# ---------------------------------------------------------------- main

def host_info() -> dict:
    """The card (nvidia-smi's name and power limit) and the host's cores,
    torch, CUDA and nvcc versions."""
    import torch

    return {"device": smoke.card_line(), "cpu_count": os.cpu_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": smoke.nvcc_version()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Benchmark of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--case", action="append", choices=(*NAMES, "setup"),
                    metavar="NAME", help="a case to run (repeatable; "
                    f"default: all of {', '.join(NAMES)}; setup only when "
                    "named)")
    ap.add_argument("--runs", type=int, default=RUNS,
                    help=f"timed runs a case (default {RUNS})")
    args = ap.parse_args(argv)
    if args.runs < 1:
        ap.error("--runs must be at least 1")
    import torch

    if not torch.cuda.is_available():
        print("bench_torch: CUDA is not available: nothing was timed (every "
              "case runs on a CUDA card)", file=sys.stderr)
        return 2
    info = host_info()
    log(f"bench_torch on {info['device']}; {info['cpu_count']} CPUs, torch "
        f"{info['torch']}, CUDA {info['cuda']}; {info['nvcc']}")
    failed, record = [], None
    for name in args.case or NAMES:
        t0 = time.perf_counter()
        try:
            if name == "setup":
                line = run_setup(args.runs, info)
            elif name == "bench":
                line = run_bench(args.runs, info)
            else:
                line = run_case(name, args.runs, info)
        except GateError as e:
            log(f"bench_torch: {name}: gate failed: {e}")
            failed.append(name)
            continue
        print(json.dumps(line), flush=True)
        log(f"{name}: {time.perf_counter() - t0:.1f} s")
        if name == "bench":
            record = {"metric": "1mp_images_per_sec_per_chip",
                      "value": line["img_1mp_s"], "unit": "img(1MP)/s/chip",
                      "stream_mp_s": line["mp_s"], "device": info["device"]}
    if failed:
        log(f"bench_torch: gates failed: {', '.join(failed)}")
        return 1
    if record is not None:
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
