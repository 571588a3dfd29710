"""Batched suite runner on the port — the counterpart of
``pngloss_tpu/suite.py``: every (file, strength) job goes into one
``compress_many`` call, one optimizer call per shape bucket, with the
host codec around it.

Usage:
    python -m pngloss_tpu_torch.suite --dir DIR [--strengths 19,40] \
        [--files a.png,b.png] [--oracle /path/to/pngloss] [--out DIR]

Prints a per-file table (sizes, ratio, PSNR, byte-parity against the
oracle when given) on stderr and one JSON summary line on stdout; exits 1
when the oracle disagrees. The JAX package's ``--impl`` has no
counterpart: each device has one route (the CUDA kernels on a CUDA device,
their plain versions on the CPU). Runs on CUDA; without CUDA it exits 2
with a message that names CUDA. ``pngloss_tpu.suite`` imports JAX at its
top, so its small body is copied here, not imported.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

from pngloss_tpu_torch import codec, tracing
from pngloss_tpu_torch.metrics import psnr_rgba


def run_oracle(oracle: str, data: bytes, strength: int, bleed: int = 2) -> bytes:
    proc = subprocess.run(
        [oracle, "-f", "-s", str(strength), "-b", str(bleed), "-"],
        input=data, capture_output=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr.decode(errors="replace"))
    return proc.stdout


def run_suite(paths, strengths, oracle=None, out_dir=None, *, device="cuda",
              mesh=None, verbose=True):
    """Compress every file at every strength on ``device`` or over
    ``mesh`` (which, when given, replaces ``device``). Returns (rows,
    summary) as ``pngloss_tpu.suite.run_suite`` does. One request
    (``tracing.request``): the files' reads (``host_read``), the
    ``compress_many`` call, then per job its report (``suite.report``:
    decode, PSNR, the oracle's bytes) and its write (``host_write``)."""
    from pngloss_tpu_torch.parallel import resolve_mesh

    mesh = resolve_mesh(device, mesh)
    with tracing.request("suite.run_suite"):
        return _run_suite(paths, strengths, oracle, out_dir, mesh, verbose)


def _run_suite(paths, strengths, oracle, out_dir, mesh, verbose):
    from pngloss_tpu_torch.pipeline import compress_many

    files = {}
    with tracing.stage("host_read"):
        for p in paths:
            with open(p, "rb") as fh:
                files[p] = fh.read()
    results = []
    total_in = total_out = 0
    total_mp = 0.0
    parity_ok = True

    # one compress_many call across all (file, strength) pairs: mixed
    # strengths share a bucket (per-image strength vector)
    jobs = [(p, s) for s in strengths for p in paths]
    datas = [files[p] for p, _ in jobs]
    per_job_strength = [s for _, s in jobs]
    t0 = time.time()
    outs = compress_many(datas, per_job_strength, mesh=mesh)
    total_time = time.time() - t0

    in_decoded: dict[str, object] = {}
    for (p, strength), data, res in zip(jobs, datas, outs):
        name = os.path.basename(p)
        if res.error is not None:
            results.append(dict(file=name, strength=strength,
                                error=str(res.error)))
            continue
        with tracing.stage("suite.report"):
            if p not in in_decoded:
                in_decoded[p] = codec.decode(data)
            img = in_decoded[p]
            qimg = codec.decode(res.data)
            mp = img.width * img.height / 1e6
            total_mp += mp
            p_db = psnr_rgba(img.rgba, qimg.rgba)
            row = dict(
                file=name, strength=strength, in_bytes=len(data),
                out_bytes=len(res.data),
                ratio=round(len(res.data) / len(data), 4),
                psnr_db=round(p_db, 2) if p_db != float("inf") else "inf",
            )
            total_in += len(data)
            total_out += len(res.data)
            if oracle:
                ref = run_oracle(oracle, data, strength)
                row["byte_identical"] = res.data == ref
                parity_ok &= row["byte_identical"]
                if not row["byte_identical"]:
                    row["oracle_bytes"] = len(ref)
                    rimg = codec.decode(ref)
                    row["oracle_psnr_db"] = round(
                        psnr_rgba(img.rgba, rimg.rgba), 2)
        results.append(row)
        if out_dir:
            with tracing.stage("host_write"):
                os.makedirs(out_dir, exist_ok=True)
                with open(os.path.join(
                        out_dir, f"{name[:-4]}-s{strength}.png"), "wb") as f:
                    f.write(res.data)
        if verbose:
            print(json.dumps(row), file=sys.stderr)

    summary = dict(
        files=len(paths), strengths=list(strengths),
        total_in=total_in, total_out=total_out,
        ratio=round(total_out / max(total_in, 1), 4),
        mp_per_s=round(total_mp / max(total_time, 1e-9), 3),
        seconds=round(total_time, 3),
    )
    if oracle:
        summary["all_byte_identical"] = parity_ok
    return results, summary


def main(argv=None, *, device="cuda", mesh=None) -> int:
    from pngloss_tpu_torch.ops import CudaUnavailableError
    from pngloss_tpu_torch.parallel import resolve_mesh

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", required=True,
                    help="directory of the suite's *.png files")
    ap.add_argument("--strengths", default="19")
    ap.add_argument("--oracle", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--files", default=None,
                    help="comma-separated basenames (default: all *.png)")
    args = ap.parse_args(argv)

    paths = sorted(glob.glob(os.path.join(args.dir, "*.png")))
    if args.files:
        wanted = set(args.files.split(","))
        paths = [p for p in paths if os.path.basename(p) in wanted]
    strengths = [int(s) for s in args.strengths.split(",")]

    try:
        mesh = resolve_mesh(device, mesh)
    except CudaUnavailableError as e:
        print(f"pngloss-tpu-torch-suite: {e}", file=sys.stderr)
        return 2
    _, summary = run_suite(paths, strengths, oracle=args.oracle,
                           out_dir=args.out, mesh=mesh)
    print(json.dumps(summary))
    return 0 if summary.get("all_byte_identical", True) else 1


if __name__ == "__main__":
    sys.exit(main())
