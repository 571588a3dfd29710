#!/usr/bin/env python3
"""Random differential check of the PyTorch/CUDA port (``pngloss_tpu_torch``).

The port's counterpart of ``tools/fuzz_loop.py`` (which byte-compares the
JAX package with the C tool). Each batch is one seed and checks:

  (a) on either device, end to end against the scalar model
      (``pngloss_tpu_torch/reference.py``): in CLI mode
      ``pipeline.compress_many`` must give the PNG bytes of
      ``reference.optimize_rgba`` followed by the port's encoder; in
      embedding mode ``pipeline.optimize_rgba_batch(use_row_filters=False)``
      must give the scalar model's planes and filters. Random images of 1 to
      --max-px a side (``ops/random_cases.random_case``: six kinds,
      transparent stripes), a strength each, one bleed per batch. With
      --mode both, even seeds run CLI mode and odd seeds embedding mode.
  (b) with --device cuda, each kernel against its plain version on the
      same card tensors, on one bucket of ``ops/random_cases.random_bucket``
      (one launch of each kernel): hist, row (row 0, one attempt), row
      retry (row 0 with its strength loop, with filter and attempts: the
      row ladder at a cluster size drawn per batch from 1, 2, 4 and 8,
      against the sequential plain version, and its rounds against the
      plain ladder's), image,
      image adaptive (with ok) and image retry (with attempts: the image
      ladder at a cluster size drawn per batch from 1, 2, 4 and 8, against
      the sequential plain version, and its rounds against the plain
      ladder's, at k = 1 the attempts); the image variants stop at each image's real height; the
      retry variants and image adaptive with the test-only ``never_pass``
      flag on some low-strength images. Buckets hold at most --max-steps
      image-kernel channel steps; from 2000 on, some are long (2-3 rows of
      2000-8192 px, the rows of users' photos and screenshots).

Usage:
  python tools/fuzz_torch.py --device cpu --total 64 --max-px 8
  python tools/fuzz_torch.py --device cuda --duration 600 --out fuzz.jsonl
  python tools/fuzz_torch.py --device cuda --duration 600 --max-steps 65536
  # one batch again: the same --seed (and options) with --total 1

One JSONL record per case (an image of (a) or of the bucket of (b)): seed,
case, check, kind, h, w, bpp, strength, bleed, mode, device, identical
(kernel records also: bucket, never_pass, row_ladder_k, image_ladder_k). On a
mismatch it also holds the first divergence (which output, and its row,
column, channel and filter) and, with --out, the input saved as a PNG beside
the JSONL. Exit code 0 if and only if every case was identical; 2 when
CUDA was asked for and is not available (nothing falls back to the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pngloss_tpu_torch import codec, pipeline, reference  # noqa: E402
from pngloss_tpu_torch.ops import (  # noqa: E402
    CudaUnavailableError,
    hist,
    image,
    resolve_device,
    row,
)
from pngloss_tpu_torch.ops.optimize_gpu import row0, zero_carry  # noqa: E402
from pngloss_tpu_torch.ops.random_cases import (  # noqa: E402
    random_bleed,
    random_bucket,
    random_case,
)

# images per batch through the entry points
E2E_IMAGES = 8
# the ladders' cluster sizes, one drawn per kernel batch for each ladder
LADDER_KS = (1, 2, 4, 8)
# named axes of each kernel output past the batch axis; "row" of the image
# kernel's outputs counts from its first row, row 1
AXES = {
    "hist": ("filter", "bin"),
    "row.q": ("filter", "col", "channel"),
    "row.hist": ("filter", "bin"),
    "row.e0": ("filter", "col", "lane"),
    "row.e1": ("filter", "col", "lane"),
    "row_retry.q": ("col", "channel"),
    "row_retry.hist": ("bin",),
    "row_retry.e0": ("col", "lane"),
    "row_retry.e1": ("col", "lane"),
    "row_retry.f": (),
    "row_retry.attempts": (),
    "row_retry.rounds": (),
    "q": ("row", "col", "channel"),
    "f": ("row",),
    "ok": (),
    "attempts": (),
    "rounds": (),
}


def batch_mode(seed: int, mode: str) -> str:
    return ("cli", "embed")[seed % 2] if mode == "both" else mode


def first_divergence(got: np.ndarray, want: np.ndarray, axes) -> dict | None:
    """The first index where got and want differ, by named axes, with both
    values; None where they are equal."""
    diff = np.argwhere(np.asarray(got) != np.asarray(want))
    if not len(diff):
        return None
    idx = tuple(int(i) for i in diff[0])
    return {**dict(zip(axes, idx)), "got": int(np.asarray(got)[idx]),
            "want": int(np.asarray(want)[idx])}


def _save(out: str | None, name: str, png: bytes) -> dict:
    if not out:
        return {}
    path = f"{out}.{name}.png"
    with open(path, "wb") as fh:
        fh.write(png)
    return {"input_saved": path}


def _plane_divergence(q, f, q_ref, f_ref) -> dict | None:
    """First divergence of (planes (H, W, 4), filters (H,)) from the
    scalar model's, with the filters of its row."""
    where = first_divergence(q, q_ref, ("row", "col", "channel"))
    if where:
        return {"output": "q", **where,
                "filter": [int(f[where["row"]]), int(f_ref[where["row"]])]}
    where = first_divergence(f, f_ref, ("row",))
    return {"output": "f", **where} if where else None


def check_end_to_end(rng, seed: int, mode: str, device, bleed: int,
                     n: int, max_px: int, max_strength: int,
                     out: str | None) -> list[dict]:
    """(a): n random images through the entry point of ``mode`` against
    the scalar model. Returns one record per image."""
    cases = [random_case(rng, max_px, max_strength) for _ in range(n)]
    rgbas = [rgba for _, rgba, _ in cases]
    strengths = [s for _, _, s in cases]
    pngs = [codec.encode(rgba, row_filters=None) for rgba in rgbas]
    if mode == "cli":
        got = pipeline.compress_many(pngs, strengths, bleed, device=device)
    else:
        got_q, got_f = pipeline.optimize_rgba_batch(
            rgbas, strengths, bleed, use_row_filters=False, device=device)
    recs = []
    for i, ((kind, rgba, s), png) in enumerate(zip(cases, pngs)):
        where = None
        if mode == "cli":
            img = codec.decode(png)
            q_ref, f_ref = reference.optimize_rgba(img.rgba, s, bleed)
            want = codec.encode(q_ref, row_filters=f_ref, gamma=img.gamma,
                                color_transform=img.color_transform,
                                chunks=img.chunks)
            if got[i].error is not None:
                where = {"output": "error", "error": repr(got[i].error)}
            elif got[i].data != want:
                # the planes show where; equal planes leave the encoder
                q, f = pipeline.optimize_rgba(img.rgba, s, bleed,
                                              device=device)
                where = (_plane_divergence(q, f, q_ref, f_ref)
                         or {"output": "png"})
        else:
            q_ref, f_ref = reference.optimize_rgba(rgba, s, bleed, False)
            where = _plane_divergence(got_q[i], got_f[i], q_ref, f_ref)
        rec = {"seed": seed, "case": i, "check": "end_to_end", "kind": kind,
               "h": rgba.shape[0], "w": rgba.shape[1],
               "bpp": pipeline.working_bpp(rgba), "strength": s,
               "bleed": bleed, "mode": mode, "device": str(device),
               "identical": where is None}
        if where:
            rec.update(divergence=where,
                       **_save(out, f"seed{seed}.case{i}", png))
        recs.append(rec)
    return recs


def kernel_outputs(bucket, bleed: int, device, k: int = 1,
                   image_k: int = 1) -> dict[str, tuple]:
    """(b): every kernel and its plain version on the bucket's tensors on
    the card, the row ladder at cluster size ``k`` and the image ladder at
    ``image_k``. Returns {kernel: {output: (got, want) numpy arrays}}."""
    i32 = torch.int32
    rows = torch.as_tensor(bucket.rows, device=device)
    b, h, wb = rows.shape
    bpp = bucket.bpp
    w = wb // bpp
    s, wr, hr, flags = (torch.as_tensor(a, dtype=i32, device=device)
                        for a in (bucket.strengths, bucket.w_real,
                                  bucket.h_real, bucket.never_pass))
    never_pass = flags if bool(flags.any()) else None
    pairs = {}

    def add(kernel, names, got, want):
        pairs[kernel] = {n: (g.cpu().numpy(), x.cpu().numpy())
                         for n, g, x in zip(names, got, want)}

    ofreq = hist.original_frequencies(rows, bpp, wr, hr)
    add("hist", ("hist",), [ofreq],
        [hist.original_frequencies_ref(rows, bpp, wr, hr)])
    orig0 = rows[:, 0].reshape(b, w, bpp).to(i32)
    z = zero_carry(b, w, bpp, device)
    args = (s, bleed, orig0, z.qprev, z.e0, z.e1, z.hist, ofreq, wr)
    add("row", ("row.q", "row.hist", "row.e0", "row.e1"),
        row.row_attempt(*args), row.row_attempt_ref(*args))
    rounds, rounds_ref = (torch.zeros(b, dtype=i32, device=device)
                          for _ in range(2))
    (q, *state), f, n = row.row0_retry(s, bleed, orig0, ofreq, wr,
                                        never_pass, k, rounds)
    (q_ref, *state_ref), f_ref, n_ref = row.row_retry_ref(
        s, bleed, orig0, z, ofreq, wr, never_pass)
    row.row_retry_ladder_ref(s, bleed, orig0, z, ofreq, wr, never_pass, k,
                             rounds_ref)
    add("row_retry", ("row_retry.q", "row_retry.hist", "row_retry.e0",
                      "row_retry.e1", "row_retry.f", "row_retry.attempts",
                      "row_retry.rounds"),
        (q, *state, f, n, rounds),
        (q_ref, *state_ref, f_ref, n_ref, rounds_ref))
    c0, _ = row0(s, bleed, orig0, ofreq, wr)
    args = (s, bleed, wr, ofreq, rows, c0.qprev, c0.e0, c0.e1, c0.hist)
    add("image", ("q", "f"), image.image_rows(*args, h_real=hr),
        image.image_rows_ref(*args, h_real=hr))
    add("image_adaptive", ("q", "f", "ok"),
        image.image_rows(*args, adaptive=True, never_pass=never_pass,
                         h_real=hr),
        image.image_rows_ref(*args, adaptive=True, never_pass=never_pass,
                             h_real=hr))
    rounds = torch.zeros(b, dtype=i32, device=device)
    got = image.image_rows(*args, adaptive=True, retry=True,
                           never_pass=never_pass, h_real=hr, k=image_k,
                           rounds=rounds)
    want = image.image_rows_retry_ref(*args, never_pass=never_pass,
                                      h_real=hr)
    if image_k == 1:              # one strength a round: rounds = attempts
        rounds_ref = want[2]
    else:
        rounds_ref = torch.zeros(b, dtype=i32, device=device)
        image.image_rows_ladder_ref(*args, k=image_k, never_pass=never_pass,
                                    h_real=hr, rounds=rounds_ref)
    add("image_retry", ("q", "f", "attempts", "rounds"), (*got, rounds),
        (*want, rounds_ref))
    return pairs


def kernel_divergence(pairs: dict, k: int) -> dict | None:
    """The first output of image k, in kernel order, where a kernel
    differs from its plain version."""
    for kernel, outputs in pairs.items():
        for name, (got, want) in outputs.items():
            where = first_divergence(got[k], want[k], AXES[name])
            if where is None:
                continue
            if name == "q":
                y = where["row"]
                where["filter"] = [int(outputs["f"][0][k][y]),
                                   int(outputs["f"][1][k][y])]
            if "row" in where and kernel.startswith("image"):
                where["row"] += 1
            return {"kernel": kernel, "output": name, **where}
    return None


def check_kernels(rng, seed: int, device, bleed: int, max_steps: int,
                  max_strength: int, out: str | None) -> list[dict]:
    """(b) on one random bucket. Returns one record per image."""
    bucket = random_bucket(rng, max_steps=max_steps,
                           max_strength=max_strength)
    rungs = int(rng.choice(LADDER_KS))
    image_rungs = int(rng.choice(LADDER_KS))
    pairs = kernel_outputs(bucket, bleed, device, rungs, image_rungs)
    h_pad, w_pad = bucket.shape
    recs = []
    for k, kind in enumerate(bucket.kinds):
        hr, wr = int(bucket.h_real[k]), int(bucket.w_real[k])
        where = kernel_divergence(pairs, k)
        rec = {"seed": seed, "case": k, "check": "kernels", "kind": kind,
               "h": hr, "w": wr, "bpp": bucket.bpp,
               "strength": int(bucket.strengths[k]), "bleed": bleed,
               "mode": "kernels", "device": str(device),
               "bucket": [h_pad, w_pad],
               "never_pass": int(bucket.never_pass[k]),
               "row_ladder_k": rungs, "image_ladder_k": image_rungs,
               "identical": where is None}
        if where:
            plane = bucket.rows[k, :hr, :wr * bucket.bpp]
            png = codec.encode(pipeline.restore_colorspace(
                plane, bucket.bpp, wr), row_filters=None)
            rec.update(divergence=where,
                       **_save(out, f"seed{seed}.kernels{k}", png))
        recs.append(rec)
    return recs


def run_batch(seed: int, device, *, mode: str = "both",
              e2e_images: int = E2E_IMAGES, max_px: int = 16,
              max_strength: int = 255, max_steps: int = 4096,
              out: str | None = None) -> list[dict]:
    """One batch: (a) on ``device``, and (b) where it is a CUDA device.
    Returns its records."""
    rng = np.random.default_rng(seed)
    bleed = random_bleed(rng)
    recs = check_end_to_end(rng, seed, batch_mode(seed, mode), device, bleed,
                            e2e_images, max_px, max_strength, out)
    if device.type == "cuda":
        recs += check_kernels(rng, seed, device, bleed, max_steps,
                              max_strength, out)
    return recs


def summarize(recs: list[dict]) -> dict:
    e2e = [r for r in recs if r["check"] == "end_to_end"]
    ker = [r for r in recs if r["check"] == "kernels"]
    batches = list({r["seed"]: r for r in ker}.values())

    def drawn(key):
        return {k: sum(r[key] == k for r in batches) for k in LADDER_KS}

    return {"cases": len(recs), "end_to_end": len(e2e),
            "kernel_batches": len(batches),
            "kernel_cases": len(ker),
            "mismatches": sum(not r["identical"] for r in recs),
            "modes": sorted({r["mode"] for r in e2e}),
            "bpps": {"end_to_end": sorted({r["bpp"] for r in e2e}),
                     "kernels": sorted({r["bpp"] for r in ker})},
            "row_ladder_k": drawn("row_ladder_k"),
            "image_ladder_k": drawn("image_ladder_k"),
            "widest_bucket": max((r["bucket"][1] for r in batches),
                                 default=0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Random differential check of pngloss_tpu_torch.")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the first batch; batch k uses seed + k")
    ap.add_argument("--total", type=int, default=0,
                    help="stop once this many cases ran (0: by --duration)")
    ap.add_argument("--duration", type=float, default=0,
                    help="stop starting batches after this many seconds")
    ap.add_argument("--out", default=None, help="JSONL output path")
    ap.add_argument("--max-px", type=int, default=16,
                    help="largest side of an end-to-end image")
    ap.add_argument("--max-strength", type=int, default=255)
    ap.add_argument("--max-steps", type=int, default=4096,
                    help="largest kernel bucket, in image-kernel channel "
                         "steps ((H-1) x W x bpp); from 2000 on some "
                         "buckets are long rows of 2000-8192 px")
    ap.add_argument("--mode", default="both", choices=["cli", "embed", "both"])
    args = ap.parse_args(argv)
    if not args.total and not args.duration:
        args.total = 256
    try:
        device = resolve_device(args.device)
    except CudaUnavailableError as e:
        print(f"fuzz_torch: {e}", file=sys.stderr)
        return 2
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    t0 = time.perf_counter()
    recs: list[dict] = []
    seed = args.seed
    while not ((args.total and len(recs) >= args.total)
               or (args.duration
                   and time.perf_counter() - t0 >= args.duration)):
        batch = run_batch(seed, device, mode=args.mode, max_px=args.max_px,
                          max_strength=args.max_strength,
                          max_steps=args.max_steps, out=args.out)
        if args.out:
            with open(args.out, "a") as fh:
                fh.writelines(json.dumps(r) + "\n" for r in batch)
        for r in batch:
            if not r["identical"]:
                print(json.dumps(r), file=sys.stderr)
        recs += batch
        print(f"fuzz_torch: seed {seed}: {len(batch)} cases, "
              f"{sum(not r['identical'] for r in batch)} mismatches "
              f"({time.perf_counter() - t0:.1f} s)", file=sys.stderr)
        seed += 1
    summary = summarize(recs)
    summary.update(device=str(device), seconds=time.perf_counter() - t0,
                   first_seed=args.seed, last_seed=seed - 1)
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        summary["card"] = (smi.stdout.strip().splitlines()[0]
                           if smi.returncode == 0 and smi.stdout.strip()
                           else torch.cuda.get_device_name(device))
    print(json.dumps(summary))
    return 0 if recs and not summary["mismatches"] else 1


if __name__ == "__main__":
    sys.exit(main())
