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
     and every row's filter is libpng's MSAD choice for that row.

Prints the card line and one JSON line of per-kernel results before the
last line, ``{"ok": true, "device": {...}}``. Without CUDA, or when any
phase fails, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
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


def check_end_to_end(device) -> None:
    """Phase 4: PNG bytes against the scalar model + host encoder."""
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
    for i, (png, s) in enumerate(zip(pngs, strengths)):
        img = decode(png)
        q, f = optimize_rgba(img.rgba, s, 2)
        want = encode(q, row_filters=f, gamma=img.gamma,
                      color_transform=img.color_transform, chunks=img.chunks)
        if got[i].unwrap() != want:
            raise AssertionError(f"end-to-end bytes differ for image {i} "
                                 f"({specs[i]})")


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


def run_embedding(device, card: str, log) -> tuple[dict, dict]:
    """Phase 6: embedding mode at full size. Returns the kernel launch
    counts of its first run and the adaptive image kernel's timing."""
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
    return launches, timing


def run_main_path(device, card: str, log) -> dict[str, int]:
    """Phase 5: the main path at full size. Returns the kernel launch
    counts of its first run."""
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
    return launches


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
    check_end_to_end(device)
    log(f"[4] end-to-end bytes == scalar reference model "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    ok = check_embedding_small(device)
    log(f"[4b] embedding mode == scalar reference model; seed-700 "
        f"speculation ok {ok} ({time.perf_counter() - t0:.1f} s)")

    log("[5] main path")
    launches = run_main_path(device, card, log)

    log("[6] embedding mode at full size")
    embed_launches, timing["image_adaptive"] = run_embedding(device, card,
                                                             log)
    launches["image_adaptive"] = embed_launches["image_adaptive"]

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
