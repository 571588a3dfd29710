#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pngloss_tpu_torch``) on one GPU.

Run from the root of the repository:

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. the card's name and power limit, torch / CUDA / nvcc versions;
  2. build the CUDA kernels from ``pngloss_tpu_torch/csrc``;
  3. each kernel (the image kernel in its CLI and its adaptive variant)
     against its plain PyTorch version on the card, exact, on small shapes
     that reach every branch (bpp 1-4, strengths 0/3/19/255, bleed
     1/2/32767, transparency, ragged masks, rows failing the MSAD
     self-check) and at the main path's full shapes; times each kernel
     beside its plain version;
  4. PNG bytes of ``compress_many(device="cuda")`` against the scalar
     reference model plus the host encoder, on small mixed images; and
     embedding mode (``optimize_for_average_filter``,
     ``optimize_rgba_batch(use_row_filters=False)``) against the scalar
     model, on small images one batch of which takes the per-row fallback;
  5. the main path: ``compress_many`` on 16 synthetic 512x512 RGB images
     at -s 19 through the kernels (launch counters must rise), outputs
     decode, a second run gives the same bytes, -s 0 is pixel-lossless;
  6. embedding mode at full size: ``optimize_rgba_batch(use_row_filters=
     False)`` on 16 512x512 RGB images, some of which pass the speculation
     and some need the fallback (launch counters must rise); the adaptive
     image kernel against its plain version over all 511 rows, ok
     included; the output equals the per-row kernel path on every image,
     and every row's filter is libpng's MSAD choice for that row;
  7. the CLI on phase 5's images: ``cli.run`` in-process and
     ``python -m pngloss_tpu_torch`` as a subprocess give phase 5's bytes;
     stdin -> stdout, ``-v``, a not-a-PNG input (exit 25),
     ``--skip-if-larger -s 0`` (exit 98), and phase 4's small images
     against the scalar model;
  8. the suite runner on those files at -s 19 and -s 40 (32 jobs), each
     output equal to ``compress_many`` at its strength;
  9. the website over HTTP (a POST, a GET, a cached GET that launches
     nothing, two POSTs at once from two threads) and one FastCGI round
     trip on a unix socket, bytes equal to ``compress_many``'s;
 10. data parallelism: ``data_mesh()`` over every device and a mesh of
     cuda:0 twice, CLI mode and embedding mode equal to unsharded runs;
     with 2 or more devices, the kernels on cuda:1 while cuda:0 is the
     current device;
 11. a device trace (``tracing.device_trace``) of one main-path run: the
     trace holds the three kernels, as many launches of each as the
     counters saw, and their summed device time.

Each of phases 5-11 sets the launch counters to 0 just before the path it
drives and reads them just after; a kernel of that path that was not
launched fails the run.

Prints the card line and one JSON line of per-kernel results before the
last line, ``{"ok": true, "device": {...}}``. Without CUDA, or when any
phase fails, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

SEED = 0
N_IMAGES, SIDE, STRENGTH = 16, 512, 19
KERNELS = (
    # name, source, TPU kernel it replaces
    ("hist", "pngloss_tpu_torch/csrc/hist.cu",
     "pngloss_tpu/ops/pallas_hist.py:38"),
    ("row", "pngloss_tpu_torch/csrc/row.cu",
     "pngloss_tpu/ops/pallas_row.py:194"),
    ("image", "pngloss_tpu_torch/csrc/image.cu",
     "pngloss_tpu/ops/pallas_image.py:107"),
    ("image_adaptive", "pngloss_tpu_torch/csrc/image.cu",
     "pngloss_tpu/ops/pallas_image.py:107 (adaptive=True)"),
)
EMBED_SEED, EMBED_SMALL_SEED, EMBED_SMALL_STRENGTH = SEED + 5, 700, 45
ROOT = os.path.dirname(os.path.abspath(__file__))
CLI_KERNELS = ("hist", "row", "image")
EMBED_KERNELS = ("hist", "row", "image_adaptive")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 1, warm: bool = True) -> float:
    """Device time of one call of fn, by CUDA events over reps calls."""
    import torch

    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _max_err(got, want) -> int:
    """Largest absolute difference over matching tensors (0 = exact)."""
    if isinstance(got, (tuple, list)):
        return max(_max_err(g, w) for g, w in zip(got, want))
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def _i32(a, device):
    import torch

    return torch.as_tensor(np.asarray(a, np.int32), device=device)


def row_state(rng, b: int, w: int, bpp: int, device):
    """A mid-image row state with many frequency ties."""
    orig = rng.integers(0, 256, (b, w, bpp))
    if bpp % 2 == 0:
        orig[:, ::2, bpp - 1] = 0                        # transparent pixels
    orig[0, :3] = 255                                    # saturated band
    return dict(
        orig=_i32(orig, device),
        qprev=_i32(rng.integers(0, 256, (b, w, bpp)), device),
        e0=_i32(rng.integers(-40, 41, (b, w + 5, 4)), device),
        e1=_i32(rng.integers(-40, 41, (b, w + 5, 4)), device),
        hist=_i32(rng.integers(0, 3, (b, 256)), device),
        ofreq=_i32(rng.integers(0, 3, (b, 5, 256)), device),
    )


def synthetic_rgb(rng, n: int, h: int, w: int) -> np.ndarray:
    """(n, h, w, 4) RGBA, opaque: smooth gradients plus seeded noise."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x + y) * 255 // max(h + w - 2, 1)], -1)
    rgb = np.clip(base[None] + rng.integers(-12, 13, (n, h, w, 3)), 0, 255)
    alpha = np.full((n, h, w, 1), 255)
    return np.concatenate([rgb, alpha], -1).astype(np.uint8)


def check_kernels(device) -> dict[str, int]:
    """Phase 3a: every kernel against its plain version on small shapes
    that reach every branch. Returns the max abs error per kernel (raises
    unless all are 0)."""
    import torch

    from pngloss_tpu_torch.ops import hist, image, row

    rng = np.random.default_rng(SEED + 1)
    errs = {"hist": 0, "row": 0, "image": 0, "image_adaptive": 0}
    oks = set()
    for bpp in (1, 2, 3, 4):
        rows = rng.integers(0, 256, (3, 8, 9 * bpp)).astype(np.uint8)
        rows[1, :, :4] = 7                               # hot bins
        rows_d = torch.as_tensor(rows, device=device)
        wr, hr = _i32([9, 4, 2], device), _i32([8, 3, 5], device)
        for args in ((), (wr, hr)):
            errs["hist"] = max(errs["hist"], _max_err(
                hist.original_frequencies(rows_d, bpp, *args),
                hist.original_frequencies_ref(rows_d, bpp, *args)))

        s = _i32([0, 3, 19, 255], device)
        w_real = _i32([7, 5, 7, 2], device)
        st = row_state(rng, 4, 7, bpp, device)
        for bleed in (1, 2, 32767):
            args = (s, bleed, st["orig"], st["qprev"], st["e0"], st["e1"],
                    st["hist"], st["ofreq"], w_real)
            errs["row"] = max(errs["row"], _max_err(
                row.row_attempt(*args), row.row_attempt_ref(*args)))

            img = rng.integers(0, 256, (4, 6, 7 * bpp)).astype(np.uint8)
            if bpp % 2 == 0:
                img.reshape(4, 6, 7, bpp)[:, 1::2, ::2, bpp - 1] = 0
            img_d = torch.as_tensor(img, device=device)
            args = (s, bleed, w_real, st["ofreq"], img_d, st["qprev"],
                    st["e0"], st["e1"], st["hist"])
            errs["image"] = max(errs["image"], _max_err(
                image.image_rows(*args), image.image_rows_ref(*args)))
            want = image.image_rows_ref(*args, adaptive=True)
            errs["image_adaptive"] = max(errs["image_adaptive"], _max_err(
                image.image_rows(*args, adaptive=True), want))
            oks.update(want[2].tolist())
    if any(errs.values()):
        raise AssertionError(f"kernel != plain version: {errs}")
    if oks != {0, 1}:
        raise AssertionError(f"small adaptive inputs gave ok {oks}, not both")
    return errs


def timed_entry(name, fn, ref, shape: str, reps: int, log) -> dict:
    """A kernel (fn) against its plain version (ref) on the same inputs:
    exact, or it raises. The plain version runs once and is timed by that
    run; the kernel by CUDA events over reps calls after a warm-up."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = ref()
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = _max_err(fn(), want)
    if err:
        raise AssertionError(f"{name} at {shape}: max abs err {err}")
    ms = cuda_ms(fn, reps)
    log(f"  {name:5s} {shape:28s} kernel {ms:10.3f} ms  "
        f"plain {plain_ms:10.3f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, shape=shape)


def time_kernels(device, log) -> dict[str, dict]:
    """Phase 3b: each kernel against its plain version at the main path's
    shapes (16 x 512x512 RGB at -s 19; the image kernel over all 511 rows,
    its plain version replaying one row step from a CUDA graph). Exact;
    the plain version runs once and is timed by that run."""
    import torch

    from pngloss_tpu_torch.ops import hist, image, row
    from pngloss_tpu_torch.ops.optimize_gpu import row0

    rng = np.random.default_rng(SEED + 2)
    rgba = synthetic_rgb(rng, N_IMAGES, SIDE, SIDE)
    rows = torch.as_tensor(rgba[..., :3].reshape(N_IMAGES, SIDE, SIDE * 3),
                           device=device)
    b, bpp, w = N_IMAGES, 3, SIDE
    s = _i32([STRENGTH] * b, device)
    w_real, h_real = _i32([w] * b, device), _i32([SIDE] * b, device)
    out = {}

    def entry(name, fn, ref, shape, reps):
        out[name] = timed_entry(name, fn, ref, shape, reps, log)

    entry("hist", lambda: hist.original_frequencies(rows, bpp, w_real, h_real),
          lambda: hist.original_frequencies_ref(rows, bpp, w_real, h_real),
          f"{b}x{SIDE}x{w}x{bpp}", 20)
    ofreq = hist.original_frequencies(rows, bpp, w_real, h_real)
    orig0 = rows[:, 0].reshape(b, w, bpp).to(torch.int32)
    z = torch.zeros_like(orig0)
    ze = torch.zeros((b, w + 5, 4), dtype=torch.int32, device=device)
    zh = torch.zeros((b, 256), dtype=torch.int32, device=device)
    args = (s, 2, orig0, z, ze, ze, zh, ofreq, w_real)
    entry("row", lambda: row.row_attempt(*args),
          lambda: row.row_attempt_ref(*args), f"{b}x1x{w}x{bpp} (row 0)", 10)
    c0, _ = row0(s, 2, orig0, ofreq, w_real)
    args = (s, 2, w_real, ofreq, rows, c0.qprev, c0.e0, c0.e1, c0.hist)
    entry("image", lambda: image.image_rows(*args),
          lambda: image.image_rows_ref(*args),
          f"{b}x{SIDE}x{w}x{bpp} (rows 1-{SIDE - 1})", 2)
    return out


def check_end_to_end(device) -> list[tuple[bytes, int, bytes]]:
    """Phase 4: PNG bytes against the scalar model + host encoder.
    Returns (input PNG, strength, expected output) per small image."""
    from pngloss_tpu.codec import decode, encode
    from pngloss_tpu.core.reference import optimize_rgba
    from pngloss_tpu_torch.pipeline import compress_many

    rng = np.random.default_rng(SEED + 3)
    specs = ((46, 70, "rgb", 19), (24, 31, "gray", 0), (17, 25, "rgba", 40),
             (1, 40, "rgb", 19), (13, 9, "gray_alpha", 3), (9, 12, "rgb", 255))
    pngs, strengths = [], []
    for h, w, kind, s in specs:
        rgba = synthetic_rgb(rng, 1, h, w)[0]
        if kind in ("gray", "gray_alpha"):
            rgba[..., 0] = rgba[..., 2] = rgba[..., 1]
        if kind in ("rgba", "gray_alpha"):
            rgba[::3, ::2, 3] = 0
            rgba[1::3, 1::2, 3] = 128
        pngs.append(encode(rgba, row_filters=None))
        strengths.append(s)
    got = compress_many(pngs, strengths, device=device)
    cases = []
    for i, (png, s) in enumerate(zip(pngs, strengths)):
        img = decode(png)
        q, f = optimize_rgba(img.rgba, s, 2)
        want = encode(q, row_filters=f, gamma=img.gamma,
                      color_transform=img.color_transform, chunks=img.chunks)
        if got[i].unwrap() != want:
            raise AssertionError(f"end-to-end bytes differ for image {i} "
                                 f"({specs[i]})")
        cases.append((png, s, want))
    return cases


def speculate(rows, bpp: int, strength: int, device):
    """Embedding mode's speculation on same-shaped planes rows (B, H, W*bpp)
    uint8: pre-pass, row 0, the adaptive image kernel. Returns (ofreq,
    row-0 carry, row-0 filters, (qrows, filt, ok))."""
    import torch

    from pngloss_tpu_torch.ops import hist, image
    from pngloss_tpu_torch.ops.optimize_gpu import row0

    b, h, wb = rows.shape
    w = wb // bpp
    s = _i32([strength] * b, device)
    wr, hr = _i32([w] * b, device), _i32([h] * b, device)
    ofreq = hist.original_frequencies(rows, bpp, wr, hr)
    c0, f0 = row0(s, 2, rows[:, 0].reshape(b, w, bpp).to(torch.int32),
                  ofreq, wr)
    return ofreq, c0, f0, image.image_rows(s, 2, wr, ofreq, rows, c0.qprev,
                                           c0.e0, c0.e1, c0.hist,
                                           adaptive=True)


def check_embedding_small(device) -> list[int]:
    """Phase 4b: embedding mode against the scalar model on small images.
    The seed-700 (4, 6, 7*3) batch at -s 45 mixes images whose speculation
    passes with images that take the per-row fallback. Returns its ok."""
    import torch

    from pngloss_tpu.core.reference import optimize_rgba
    from pngloss_tpu_torch.pipeline import (
        optimize_for_average_filter,
        optimize_rgba_batch,
    )

    rows = np.random.default_rng(EMBED_SMALL_SEED).integers(
        0, 256, size=(4, 6, 7 * 3), dtype=np.uint8)
    ok = speculate(torch.as_tensor(rows, device=device), 3,
                   EMBED_SMALL_STRENGTH, device)[3][2].tolist()
    if set(ok) != {0, 1}:
        raise AssertionError(f"seed-700 speculation gave ok {ok}")
    rgbas = [np.concatenate([r.reshape(6, 7, 3),
                             np.full((6, 7, 1), 255, np.uint8)], -1)
             for r in rows]
    qs, fs = optimize_rgba_batch(rgbas, EMBED_SMALL_STRENGTH,
                                 use_row_filters=False, device=device)
    for i, (rgba, q, f) in enumerate(zip(rgbas, qs, fs)):
        q_ref, f_ref = optimize_rgba(rgba, EMBED_SMALL_STRENGTH, 2, False)
        if not (np.array_equal(q, q_ref) and np.array_equal(f, f_ref)):
            raise AssertionError(f"embedding: seed-700 image {i} differs "
                                 "from the scalar model")
    rng = np.random.default_rng(SEED + 6)
    specs = ((17, 23, "rgb", 19), (12, 9, "gray", 45), (9, 14, "rgba", 40),
             (1, 30, "rgb", 19), (11, 8, "gray_alpha", 3))
    for h, w, kind, strength in specs:
        rgba = synthetic_rgb(rng, 1, h, w)[0]
        rgba[..., :3] ^= rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        if kind in ("gray", "gray_alpha"):
            rgba[..., 0] = rgba[..., 2] = rgba[..., 1]
        if kind in ("rgba", "gray_alpha"):
            rgba[::3, ::2, 3] = 0
            rgba[1::3, 1::2, 3] = 128
        got = optimize_for_average_filter(rgba, strength, device=device)
        if not np.array_equal(got, optimize_rgba(rgba, strength, 2,
                                                 False)[0]):
            raise AssertionError(f"optimize_for_average_filter differs from "
                                 f"the scalar model on {(h, w, kind)}")
    return ok


def embedding_batch(rng) -> np.ndarray:
    """(16, 512, 512, 4) opaque RGBA: 8 smooth images (gradients plus
    +-12 noise), whose speculation passes at -s 19, and 8 of uniform
    noise, some of which have a row with no passing filter."""
    n = N_IMAGES // 2
    noise = rng.integers(0, 256, (N_IMAGES - n, SIDE, SIDE, 4))
    noise[..., 3] = 255
    return np.concatenate([synthetic_rgb(rng, n, SIDE, SIDE),
                           noise.astype(np.uint8)])


def run_embedding(device, card: str, log):
    """Phase 6: embedding mode at full size. Returns the kernel launch
    counts of its first run, the adaptive image kernel's timing, and the
    inputs and outputs of that run (rgba, q, f)."""
    import torch

    from pngloss_tpu.core.reference import adaptive_filter_for_row
    from pngloss_tpu_torch.ops import hist, image, row
    from pngloss_tpu_torch.ops.optimize_gpu import optimize_rows
    from pngloss_tpu_torch.pipeline import optimize_rgba_batch

    rgba = embedding_batch(np.random.default_rng(EMBED_SEED))
    b, bpp = N_IMAGES, 3
    log(f"  inputs: images 0-{N_IMAGES // 2 - 1} smooth, "
        f"{N_IMAGES // 2}-{N_IMAGES - 1} uniform noise, {SIDE}x{SIDE} RGB, "
        f"seed {EMBED_SEED}, -s {STRENGTH}")
    torch.cuda.synchronize()
    hist.LAUNCHES = row.LAUNCHES = image.ADAPTIVE_LAUNCHES = 0
    t0 = time.perf_counter()
    q1, f1 = optimize_rgba_batch(list(rgba), STRENGTH, use_row_filters=False,
                                 device=device)
    wall = time.perf_counter() - t0
    launches = {"hist": hist.LAUNCHES, "row": row.LAUNCHES,
                "image_adaptive": image.ADAPTIVE_LAUNCHES}
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")
    t0 = time.perf_counter()
    q2, f2 = optimize_rgba_batch(list(rgba), STRENGTH, use_row_filters=False,
                                 device=device)
    wall2 = time.perf_counter() - t0
    for i in range(b):
        if not (np.array_equal(q1[i], q2[i]) and np.array_equal(f1[i], f2[i])):
            raise AssertionError(f"embedding run 2 differs on image {i}")

    # the speculation and the fallback apart, on the same planes
    rows = torch.as_tensor(rgba[..., :3].reshape(b, SIDE, SIDE * bpp),
                           device=device)
    start = torch.cuda.Event(enable_timing=True)
    mid = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    ofreq, c0, f0, (qr, fr, ok) = speculate(rows, bpp, STRENGTH, device)
    mid.record()
    ok = ok.cpu().numpy()
    bad, good = np.flatnonzero(ok == 0), np.flatnonzero(ok)
    log(f"  speculation ok per image: {ok.tolist()}")
    if not (len(bad) and len(good)):
        raise AssertionError("the batch does not take both branches")
    s = _i32([STRENGTH] * b, device)
    wr = _i32([SIDE] * b, device)
    orig = rows.view(b, SIDE, SIDE, bpp).to(torch.int32)
    sel = torch.as_tensor(bad, device=device)
    attempts = row.LAUNCHES
    optimize_rows(s[sel], 2, orig[sel], ofreq[sel], wr[sel])
    end.record()
    end.synchronize()
    attempts = row.LAUNCHES - attempts
    spec_ms, fall_ms = start.elapsed_time(mid), mid.elapsed_time(end)

    # the per-row kernel path on every image: the speculation on the ok
    # images, and the entry point's output on all, must equal it
    qp, fp = optimize_rows(s, 2, orig, ofreq, wr)
    qp, fp = qp.cpu().numpy(), fp.cpu().numpy()
    spec_q = torch.cat([c0.qprev[:, None], qr], 1).cpu().numpy()
    spec_f = torch.cat([f0[:, None], fr.long()], 1).cpu().numpy()
    for i in good:
        if not (np.array_equal(spec_q[i], qp[i])
                and np.array_equal(spec_f[i], fp[i])):
            raise AssertionError(f"speculation != per-row path on ok "
                                 f"image {i}")
    for i in range(b):
        if not (np.array_equal(q1[i][..., :3], qp[i])
                and np.array_equal(f1[i], fp[i])):
            raise AssertionError(f"embedding output != per-row path on "
                                 f"image {i}")
        work = q1[i][..., :3].reshape(SIDE, SIDE * bpp)
        for y in range(SIDE):
            above = work[y - 1] if y else None
            if adaptive_filter_for_row(above, work[y], bpp, SIDE) != f1[i][y]:
                raise AssertionError(f"image {i} row {y}: filter {f1[i][y]} "
                                     "is not libpng's MSAD choice")
    mp = b * SIDE * SIDE / 1e6
    log(f"  embedding on {card}: {b} x {SIDE}x{SIDE} RGB at -s {STRENGTH}: "
        f"run 1 {wall:.3f} s ({mp / wall:.3f} MP/s), run 2 {wall2:.3f} s "
        f"({mp / wall2:.3f} MP/s)")
    log(f"  speculation {spec_ms:.3f} ms (CUDA events: pre-pass, row 0, "
        f"adaptive image kernel), fallback {fall_ms:.3f} ms for "
        f"{len(bad)} images x {SIDE} rows, {attempts} row attempts "
        f"({attempts / SIDE:.3f} per row)")
    log(f"  launches: {launches}")

    args = (s, 2, wr, ofreq, rows, c0.qprev, c0.e0, c0.e1, c0.hist)
    timing = timed_entry(
        "image_adaptive", lambda: image.image_rows(*args, adaptive=True),
        lambda: image.image_rows_ref(*args, adaptive=True),
        f"{b}x{SIDE}x{SIDE}x{bpp} (rows 1-{SIDE - 1}, embedding batch)", 2,
        log)
    return launches, timing, (rgba, q1, f1)


def run_main_path(device, card: str, log):
    """Phase 5: the main path at full size. Returns the kernel launch
    counts of its first run, its input PNGs and its output bytes."""
    from pngloss_tpu import tracing
    from pngloss_tpu.codec import decode, encode
    from pngloss_tpu_torch.ops import hist, image, row
    from pngloss_tpu_torch.pipeline import compress_many

    rgba = synthetic_rgb(np.random.default_rng(SEED + 4), N_IMAGES, SIDE, SIDE)
    pngs = [encode(im, row_filters=None) for im in rgba]
    mods = {"hist": hist, "row": row, "image": image}
    import torch

    torch.cuda.synchronize()
    for m in mods.values():
        m.LAUNCHES = 0
    tracing.snapshot(reset=True)
    t0 = time.perf_counter()
    first = compress_many(pngs, STRENGTH, device=device)
    wall = time.perf_counter() - t0
    launches = {k: m.LAUNCHES for k, m in mods.items()}
    stages = tracing.snapshot(reset=True)
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")
    t0 = time.perf_counter()
    second = compress_many(pngs, STRENGTH, device=device)
    wall2 = time.perf_counter() - t0
    for i, (a, b) in enumerate(zip(first, second)):
        if a.unwrap() != b.unwrap():
            raise AssertionError(f"run 2 differs from run 1 on image {i}")
        out = decode(a.unwrap()).rgba
        if out.shape != rgba[i].shape:
            raise AssertionError(f"image {i} decodes to {out.shape}")
    lossless = compress_many(pngs, 0, device=device)
    for i, r in enumerate(lossless):
        if not np.array_equal(decode(r.unwrap()).rgba, rgba[i]):
            raise AssertionError(f"-s 0 is not lossless on image {i}")
    mp = N_IMAGES * SIDE * SIDE / 1e6
    in_bytes = sum(len(p) for p in pngs)
    out_bytes = sum(len(r.unwrap()) for r in first)
    log(f"  main path on {card}: {N_IMAGES} x {SIDE}x{SIDE} RGB at -s {STRENGTH}: "
        f"run 1 {wall:.3f} s ({mp / wall:.3f} MP/s), run 2 {wall2:.3f} s "
        f"({mp / wall2:.3f} MP/s); {in_bytes} -> {out_bytes} bytes")
    log("  stages (run 1, seconds summed over threads): " + json.dumps(
        {k: v["seconds"] for k, v in stages.items()}))
    log(f"  launches: {launches}")
    return launches, pngs, [r.unwrap() for r in first]


def reset_counts() -> None:
    """Every kernel wrapper's launch counter to 0."""
    from pngloss_tpu_torch.ops import hist, image, row

    hist.LAUNCHES = row.LAUNCHES = image.LAUNCHES = 0
    image.ADAPTIVE_LAUNCHES = 0


def read_counts(path: str, need) -> dict[str, int]:
    """The launch counters; raises unless every kernel in ``need`` rose."""
    from pngloss_tpu_torch.ops import hist, image, row

    counts = {"hist": hist.LAUNCHES, "row": row.LAUNCHES,
              "image": image.LAUNCHES,
              "image_adaptive": image.ADAPTIVE_LAUNCHES}
    missing = [k for k in need if not counts[k]]
    if missing:
        raise AssertionError(f"{path}: {missing} not launched: {counts}")
    return counts


def write_pngs(d: str, pngs) -> list[str]:
    paths = []
    for k, png in enumerate(pngs):
        paths.append(os.path.join(d, f"img{k:02d}.png"))
        with open(paths[-1], "wb") as fh:
            fh.write(png)
    return paths


def check_files(paths, want, what: str) -> None:
    for k, (path, data) in enumerate(zip(paths, want)):
        with open(path, "rb") as fh:
            if fh.read() != data:
                raise AssertionError(f"{what}: {os.path.basename(path)} "
                                     f"differs from compress_many's bytes")


def run_cli(device, pngs, want, small, log) -> dict[str, int]:
    """Phase 7: the CLI. Returns the launch counts of the in-process run
    over phase 5's 16 files."""
    import contextlib
    import io

    import torch

    from pngloss_tpu_torch import cli

    def quiet_run(argv, **kw):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli.run(argv, device=device, **kw)
        return rc, err.getvalue().splitlines()

    with tempfile.TemporaryDirectory() as d:
        paths = write_pngs(d, pngs)
        outs = [p[:-4] + "-loss.png" for p in paths]
        argv = ["-f", "-s", str(STRENGTH), *paths]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        rc = cli.run(argv, device=device)
        wall = time.perf_counter() - t0
        counts = read_counts("[7] cli.run", CLI_KERNELS)
        if rc != 0:
            raise AssertionError(f"cli.run exited {rc}")
        check_files(outs, want, "cli.run")
        for o in outs:
            os.unlink(o)

        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "pngloss_tpu_torch", *argv], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
            text=True, timeout=600)
        sub_wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"python -m pngloss_tpu_torch exited "
                                 f"{proc.returncode}:\n{proc.stderr}")
        check_files(outs, want, "python -m pngloss_tpu_torch")

        out = io.BytesIO()
        rc = cli.run(["-f", "-s", str(STRENGTH), "-"],
                     stdin=io.BytesIO(pngs[0]), stdout=out, device=device)
        if rc != 0 or out.getvalue() != want[0]:
            raise AssertionError(f"stdin -> stdout: exit {rc}, bytes "
                                 f"{'equal' if out.getvalue() == want[0] else 'differ'}")

        rc, err = quiet_run(["-fv", "-s", str(STRENGTH), *paths[:2]])
        bucket = f"  optimizing bucket 1/1: 2 image(s) at {SIDE}x{SIDE}x3bpp"
        if rc != 0 or bucket not in err or err[-1] != "Compressed 2 images.":
            raise AssertionError(f"-v: exit {rc}, stderr {err}")

        bad = os.path.join(d, "bad.png")
        with open(bad, "wb") as fh:
            fh.write(b"not a png")
        rc, err = quiet_run(["-f", bad])
        if rc != 25 or "  error: cannot decode image bad.png" not in err:
            raise AssertionError(f"not a PNG: exit {rc}, stderr {err}")

        # a small RGBA image whose -s 0 output is larger than its input
        os.mkdir(os.path.join(d, "small"))
        (src,) = write_pngs(os.path.join(d, "small"), [small[2][0]])
        never = os.path.join(d, "never.png")
        rc, err = quiet_run(["-s", "0", "--skip-if-larger", "-o", never, src])
        if rc != 98 or os.path.exists(never):
            raise AssertionError(f"--skip-if-larger -s 0: exit {rc}")

        for k, (png, s, expect) in enumerate(small):
            out = io.BytesIO()
            rc = cli.run(["-f", "-s", str(s), "-"], stdin=io.BytesIO(png),
                         stdout=out, device=device)
            if rc != 0 or out.getvalue() != expect:
                raise AssertionError(f"small image {k}: CLI exit {rc} or "
                                     "bytes differ from the scalar model")
    mp = len(pngs) * SIDE * SIDE / 1e6
    log(f"  cli.run -f -s {STRENGTH} on {len(pngs)} files: {wall:.3f} s "
        f"({mp / wall:.3f} MP/s), launches {counts}")
    log(f"  python -m pngloss_tpu_torch on the same files: {sub_wall:.3f} s "
        "wall, start-up and kernel load included")
    log("  stdin -> stdout, -v, not-a-PNG (25), --skip-if-larger -s 0 (98), "
        f"{len(small)} small images == scalar model: ok")
    return counts


def run_suite_phase(device, pngs, want, log) -> dict[str, int]:
    """Phase 8: the suite runner over phase 5's files at two strengths."""
    import torch

    from pngloss_tpu_torch.pipeline import compress_many
    from pngloss_tpu_torch.suite import run_suite

    strengths = (STRENGTH, 40)
    with tempfile.TemporaryDirectory() as d:
        paths = write_pngs(d, pngs)
        out_dir = os.path.join(d, "out")
        torch.cuda.synchronize()
        reset_counts()
        rows, summary = run_suite(paths, strengths, out_dir=out_dir,
                                  device=device, verbose=False)
        counts = read_counts("[8] run_suite", CLI_KERNELS)
        errors = [r for r in rows if "error" in r]
        if len(rows) != len(pngs) * len(strengths) or errors:
            raise AssertionError(f"suite: {len(rows)} rows, errors {errors}")
        want40 = [r.unwrap() for r in compress_many(pngs, 40, device=device)]
        for s, expect in ((STRENGTH, want), (40, want40)):
            check_files([os.path.join(out_dir, f"img{k:02d}-s{s}.png")
                         for k in range(len(pngs))], expect, f"suite -s {s}")
    log(f"  {len(rows)} jobs, summary {json.dumps(summary)}, "
        f"launches {counts}")
    return counts


def _post(url: str, fields: dict):
    import urllib.request

    b = "XsmokeX"
    body = b"".join(
        f"--{b}\r\nContent-Disposition: form-data; name=\"{k}\"\r\n\r\n"
        .encode() + v + b"\r\n" for k, v in fields.items())
    body += f"--{b}--\r\n".encode()
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": f"multipart/form-data; boundary={b}"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, r.read()


def _result_url(png: bytes, strength: int = STRENGTH) -> str:
    import base64
    import hashlib

    s = base64.urlsafe_b64encode(hashlib.sha224(png).digest()).decode()
    return f"compressed.cgi?sum224={s}&strength={strength}&bleed=2&strip=0"


def _fcgi(path: str, params: dict, body: bytes = b""):
    """One FastCGI responder request over a unix socket; returns (status
    line, payload)."""
    import socket
    import struct

    from pngloss_tpu.fcgi import (
        FCGI_BEGIN_REQUEST,
        FCGI_PARAMS,
        FCGI_STDIN,
        FCGI_STDOUT,
        _pack_pairs,
        _pack_record,
    )

    with socket.socket(socket.AF_UNIX) as s:
        s.settimeout(600)
        s.connect(path)
        s.sendall(_pack_record(FCGI_BEGIN_REQUEST, 1,
                               struct.pack(">HB5x", 1, 0))
                  + _pack_record(FCGI_PARAMS, 1, _pack_pairs(params))
                  + _pack_record(FCGI_PARAMS, 1, b""))
        for i in range(0, len(body), 32768):
            s.sendall(_pack_record(FCGI_STDIN, 1, body[i:i + 32768]))
        s.sendall(_pack_record(FCGI_STDIN, 1, b""))
        buf = b""
        while chunk := s.recv(1 << 16):
            buf += chunk
    out = b""
    while buf:
        _v, rtype, _rid, clen, plen = struct.unpack(">BBHHBx", buf[:8])
        if rtype == FCGI_STDOUT:
            out += buf[8:8 + clen]
        buf = buf[8 + clen + plen:]
    head, _, payload = out.partition(b"\r\n\r\n")
    return head.split(b"\r\n")[0].decode(), payload


def serve(srv) -> threading.Thread:
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return t


def stop(srv, t: threading.Thread) -> None:
    srv.shutdown()
    t.join(timeout=60)
    if t.is_alive():
        raise AssertionError("server thread did not stop")


def run_website(device, pngs, want, log) -> dict[str, int]:
    """Phase 9: the website over HTTP, then one FastCGI round trip."""
    import urllib.request

    import torch

    from pngloss_tpu_torch import website

    fields = {"strength": str(STRENGTH).encode(), "bleed": b"2",
              "strip": b"0"}
    with tempfile.TemporaryDirectory() as d:
        srv = website.make_server(port=0, store=os.path.join(d, "store"),
                                  device=device)
        t = serve(srv)
        try:
            url = f"http://127.0.0.1:{srv.server_address[1]}/"

            def get(png):
                with urllib.request.urlopen(url + _result_url(png),
                                            timeout=600) as r:
                    return r.read()

            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            status, page = _post(url + "compress.cgi",
                                 {"file": pngs[0], **fields})
            post_s = time.perf_counter() - t0
            counts = read_counts("[9] POST compress.cgi", CLI_KERNELS)
            t0 = time.perf_counter()
            data = get(pngs[0])
            get_s = time.perf_counter() - t0
            if status != 200 or b"compressed" not in page or data != want[0]:
                raise AssertionError(f"POST {status} / GET bytes differ")
            reset_counts()
            if get(pngs[0]) != want[0] or any(read_counts("cached GET", ())
                                              .values()):
                raise AssertionError("the cached GET launched a kernel or "
                                     "gave other bytes")

            got: dict = {}

            def post_and_get(k):
                _post(url + "compress.cgi", {"file": pngs[k], **fields})
                got[k] = get(pngs[k])

            reset_counts()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=post_and_get, args=(k,))
                       for k in (1, 2)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            both_s = time.perf_counter() - t0
            both = read_counts("[9] two POSTs at once", CLI_KERNELS)
            if got != {k: want[k] for k in (1, 2)}:
                raise AssertionError("concurrent POSTs gave other bytes")
        finally:
            stop(srv, t)
            srv.server_close()

        sock = os.path.join(d, "fcgi.sock")
        srv = website.make_server(store=os.path.join(d, "store"),
                                  unix_socket=sock, fcgi=True, device=device)
        t = serve(srv)
        try:
            b = "XsmokeX"
            body = b"".join(
                f"--{b}\r\nContent-Disposition: form-data; name=\"{k}\""
                "\r\n\r\n".encode() + v + b"\r\n"
                for k, v in {"file": pngs[3], **fields}.items())
            body += f"--{b}--\r\n".encode()
            status, page = _fcgi(sock, {
                "REQUEST_METHOD": "POST", "REQUEST_URI": "/compress.cgi",
                "CONTENT_TYPE": f"multipart/form-data; boundary={b}",
                "CONTENT_LENGTH": str(len(body))}, body)
            status2, data = _fcgi(sock, {"REQUEST_METHOD": "GET",
                                         "REQUEST_URI": "/" + _result_url(
                                             pngs[3])})
            if not (status.startswith("Status: 200")
                    and status2.startswith("Status: 200")
                    and data == want[3]):
                raise AssertionError(f"FastCGI: {status} / {status2}, bytes "
                                     f"{'equal' if data == want[3] else 'differ'}")
        finally:
            stop(srv, t)
    log(f"  HTTP: POST of one {SIDE}x{SIDE} RGB image {post_s:.3f} s "
        f"(compression included), GET {get_s:.3f} s (cache hit), "
        f"launches {counts}")
    log(f"  two POSTs + GETs from two threads at once: {both_s:.3f} s, "
        f"bytes equal, launches {both}; cached GET launched nothing; "
        "FastCGI round trip on a unix socket: bytes equal")
    return counts


def run_mesh(device, pngs, want, embed, log) -> dict[str, int]:
    """Phase 10: data parallelism against the unsharded runs."""
    import torch

    from pngloss_tpu_torch.parallel import data_mesh
    from pngloss_tpu_torch.pipeline import compress_many, optimize_rgba_batch

    rgba, q1, f1 = embed
    n = torch.cuda.device_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compress_many(pngs, STRENGTH, device=device)
    plain_s = time.perf_counter() - t0
    log(f"  {n} device(s); unsharded compress_many {plain_s:.3f} s")
    counts = {}
    for name, mesh in (("data_mesh()", data_mesh()),
                       ("(cuda:0, cuda:0)", data_mesh((device, device)))):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        got = compress_many(pngs, STRENGTH, mesh=mesh)
        cli_s = time.perf_counter() - t0
        counts = read_counts(f"[10] compress_many(mesh={name})", CLI_KERNELS)
        if [r.unwrap() for r in got] != want:
            raise AssertionError(f"mesh {name}: bytes differ from unsharded")
        reset_counts()
        t0 = time.perf_counter()
        q, f = optimize_rgba_batch(list(rgba), STRENGTH,
                                   use_row_filters=False, mesh=mesh)
        emb_s = time.perf_counter() - t0
        emb = read_counts(f"[10] embedding mode, mesh={name}", EMBED_KERNELS)
        for i in range(len(rgba)):
            if not (np.array_equal(q[i], q1[i])
                    and np.array_equal(f[i], f1[i])):
                raise AssertionError(f"mesh {name}: embedding image {i} "
                                     "differs from unsharded")
        log(f"  mesh {name} = {[str(d) for d in mesh]}: compress_many "
            f"{cli_s:.3f} s, embedding {emb_s:.3f} s, equal to unsharded; "
            f"launches {counts} / {emb}")
    if n >= 2:
        with torch.cuda.device(0):
            errs = check_kernels(torch.device("cuda", 1))
        log(f"  kernels on cuda:1 while cuda:0 is current == plain "
            f"versions: {errs}")
    else:
        log("  one device: the cross-device check needs 2, not run")
    return counts


def run_tracing(device, pngs, want, log) -> dict[str, int]:
    """Phase 11: a device trace of one main-path run."""
    import re

    import torch

    from pngloss_tpu_torch import tracing
    from pngloss_tpu_torch.pipeline import compress_many

    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        reset_counts()
        with tracing.device_trace(d):
            got = compress_many(pngs, STRENGTH, device=device)
            torch.cuda.synchronize()
        counts = read_counts("[11] traced compress_many", CLI_KERNELS)
        if [r.unwrap() for r in got] != want:
            raise AssertionError("traced run: bytes differ")
        (name,) = os.listdir(d)
        with open(os.path.join(d, name)) as fh:
            events = json.load(fh)["traceEvents"]
    # "hist_kernel(...)", "void (anonymous namespace)::image_kernel<3,
    # false>(...)": the kernels of csrc/ by their function names
    pattern = re.compile(r"(?:^|[ :])(hist|row|image)_kernel[<(]")
    us = dict.fromkeys(CLI_KERNELS, 0.0)
    seen = dict.fromkeys(CLI_KERNELS, 0)
    busy = 0.0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        busy += e["dur"]
        m = pattern.search(e.get("name", ""))
        if m:
            us[m.group(1)] += e["dur"]
            seen[m.group(1)] += 1
    if seen != {k: counts[k] for k in CLI_KERNELS}:
        names = sorted({e.get("name", "")[:80] for e in events
                        if e.get("cat") == "kernel"})
        raise AssertionError(f"trace holds {seen} kernel launches, the "
                             f"counters saw {counts}; kernels: {names}")
    log("  trace kernels (launches, summed device ms): " + ", ".join(
        f"{k} {seen[k]} x {us[k] / 1e3:.3f}" for k in CLI_KERNELS)
        + f"; all kernels {busy / 1e3:.3f} ms")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from pngloss_tpu_torch.ops import _build

    def log(msg):
        print(msg, flush=True)

    device = torch.device("cuda", 0)
    card = card_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {nvcc}")

    t0 = time.perf_counter()
    _build.library()
    log(f"[2] kernels built in {time.perf_counter() - t0:.1f} s "
        f"({_build.build_info['path']})")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("    " + line.strip())

    errs = check_kernels(device)
    log(f"[3] kernels == plain versions on small shapes: {errs}")
    timing = time_kernels(device, log)

    t0 = time.perf_counter()
    small = check_end_to_end(device)
    log(f"[4] end-to-end bytes == scalar reference model "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    ok = check_embedding_small(device)
    log(f"[4b] embedding mode == scalar reference model; seed-700 "
        f"speculation ok {ok} ({time.perf_counter() - t0:.1f} s)")

    log("[5] main path")
    launches, pngs, want = run_main_path(device, card, log)

    log("[6] embedding mode at full size")
    embed_launches, timing["image_adaptive"], embed = run_embedding(
        device, card, log)
    launches["image_adaptive"] = embed_launches["image_adaptive"]

    for label, phase in (
            ("[7] CLI", lambda: run_cli(device, pngs, want, small, log)),
            ("[8] suite", lambda: run_suite_phase(device, pngs, want, log)),
            ("[9] website", lambda: run_website(device, pngs, want, log)),
            ("[10] mesh", lambda: run_mesh(device, pngs, want, embed, log)),
            ("[11] tracing", lambda: run_tracing(device, pngs, want, log))):
        log(label)
        t0 = time.perf_counter()
        phase()
        log(f"  ({time.perf_counter() - t0:.1f} s)")

    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name],
                    max_abs_err=max(errs[name], timing[name]["max_abs_err"]),
                    ms=timing[name]["ms"], plain_ms=timing[name]["plain_ms"],
                    shape=timing[name]["shape"])
               for name, src, rep in KERNELS]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
