#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pngloss_tpu_torch``) on one GPU.

Run from the root of the repository:

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. the card's name and power limit, torch / CUDA / nvcc versions;
  2. build the CUDA kernels from ``pngloss_tpu_torch/csrc``;
  3. (3a) each kernel (the row kernel in its one-attempt and its retry
     variant, the image kernel in its CLI, its adaptive and its retry
     variant) against its plain PyTorch version, exact, on small
     shapes that reach every branch (bpp 1-4, strengths 0/3/19/255, bleed
     1/2/32767, transparency, ragged masks, rows failing the MSAD
     self-check) and at the edges of the kernels' design (the pre-pass:
     row pitches of 1 to 16396 bytes, bases and pitches aligned to 16, 4
     and 1 bytes, a constant image, real sizes of 1, 1 and 33 images; the
     others: rows of 1408 and 4096 pixels at bpp 4, bands over 32 lanes at
     s 255, bleed 1 and 32767 with negative dither, a channel's symbol
     inside the next channel's band, transparent pixels at bpp 2 and 4,
     ragged widths, rows that retry from strength 32, 255, 2 and 1, an
     image whose every row fails; their plain versions run on the CPU);
     the row kernel's retry variant (row 0's ladder, a thread-block
     cluster of k blocks per image trying k strengths at once) at
     strengths 0, 1, 2, 19, 40 and 255 from the zero state and a mid-image
     one, and on the EDGES cases' rows 0 and 1 (rows that retry from 32,
     255, 2 and 1), there also at k = 1, 2, 4 and 8 with its rounds; the
     retry variants' give-up branch (no filter passes at strength 0) and
     the adaptive variant's cleared ok, through the test-only
     ``never_pass`` flag on
     images at strengths 0, 1, 2 and 40 beside unflagged ones in one
     launch, at bpp 1-4: flagged images take s + 1 attempts a row,
     unflagged ones equal themselves run alone;
     (3b) at the main path's full shapes, each
     kernel's time beside its plain version's, and with ``--parent DIR``
     (a checkout of an earlier commit) the kernels of both trees timed in
     turns, parent, this tree, this tree, parent (n/a for a kernel the
     parent lacks), row 0's strength loop also on row 0 of phase 6's batch
     at -s 90 and -s 255, and the image ladder and a whole embedding call
     on phase 14's gray batch;
  4. PNG bytes of ``compress_many(device="cuda")`` against the scalar
     reference model plus the host encoder, on small mixed images; and
     embedding mode (``optimize_for_average_filter``,
     ``optimize_rgba_batch(use_row_filters=False)``) against the scalar
     model, on small images one batch of which takes the per-row fallback;
  5. the main path: ``compress_many`` on 16 synthetic 512x512 RGB images
     at -s 19 through the kernels (launches: hist 1, the row kernel's
     retry variant 1, image 1, a single row attempt 0), outputs decode, a
     second run gives the same bytes, -s 0 is pixel-lossless;
  6. embedding mode at full size: ``optimize_rgba_batch(use_row_filters=
     False)`` on 16 512x512 RGB images, some of which pass the speculation
     and some need the fallback (launches: the row kernel's retry variant
     once, row 0, its one-attempt variant never, the image kernel's retry
     variant once, over the whole batch); the adaptive image
     kernel against its plain version over rows 1-63, ok included, and
     timed over all 511; the
     fallback's one launch of the retry variant against the row kernel's
     one-attempt variant with the strength loop on the host
     (``ops/edges.rows_by_step``: ``strength_loop`` around ``row_attempt``
     per row), rows, filters and attempts per image, both timed, the
     ladder at k = 1, 2, 4 and 8 against the host loop over all 511 rows
     of the failed images and against its sequential plain version over
     rows 1-63; the output equals the host's per-row loop on every image,
     and every row's filter is libpng's MSAD choice for that row;
     (6b) speculation plus fallback against the ladder, in turns;
     (6c) row 0's ladder on phase 6's batch at -s 90 and -s 255 in CLI
     mode against its sequential plain version on the card, attempts and
     rounds per image, at the k it picks and at k = 1, 2, 4 and 8, and
     ``compress_many`` of that batch at -s 90 giving the same bytes with
     row 0 at k = 1 and, with ``--parent``, as the parent tree;
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
     trace holds the three kernels (the row kernel's retry variant), as
     many launches of each as the counters saw, and their summed device
     time;
 12. the random differential check (``tools/fuzz_torch.run_batch``) on
     fixed seeds: random images of up to 8 px a side through
     ``compress_many`` and embedding mode against the scalar model, and
     each kernel against its plain version on a random padded bucket per
     batch, at bpp 1-4 and in both modes; any mismatch fails the run;
 13. dispatch: a seeded ragged corpus (100 PNGs of 40-400 px a side, bpp
     1-4, then four 512x512 RGB; 24 buckets or more) through
     ``compress_many`` with the stream pool in longest-chain order, with a
     pool of 1 in the parent's order and, with ``--parent``, the parent
     tree's ``compress_many`` (a subprocess), in turns, then pools of 2, 4,
     8 and 32: equal bytes, wall time, MP/s, stage seconds, buckets and
     launches of each; and ``dispatch_buckets`` in CLI mode under
     ``torch.cuda.set_sync_debug_mode("error")``, returning while a spin
     queued ahead of it on every stream of the pool still runs;
 14. the port at its users' sizes (PERF.md section 4): a 12 MP camera
     photo (4000x3000 RGB, in a 4096x3072 bucket) and a 1920x1080
     screenshot, each through ``compress_many`` at -s 19 and through
     ``optimize_rgba_batch(use_row_filters=False)`` at -s 19 with every
     kernel wrapper timed by CUDA events, then again through
     ``ops.optimize_batch_auto`` alone (equal planes and filters) beside
     each kernel of both paths against its plain version on the same card
     tensors, max abs err 0: the pre-pass over the whole plane, row 0's
     ladder at full width, the image kernel's CLI variant and its ladder
     over rows 1..N-1 (N in USER_ROWS) of the whole plane, from the whole
     image's pre-pass and row 0; a full card of 512x512 RGB images (132:
     one block per SM; then 264, more blocks than SMs) through
     ``compress_many`` and again through ``optimize_batch_auto``, the first
     16 giving phase 5's bytes and the first 132 of the 264 the 132's; 16
     gray 512x512 images in embedding mode; every output decodes to its
     input's size and in embedding mode every row's filter is libpng's
     MSAD choice; wall time, stage seconds, MP/s, CUDA-event ms, bound and
     share of each, and the phase's own duration (at most 150 s);
 15. the benchmark's entry point: ``bench_torch.py --case bench --runs 1``
     in a subprocess (at most BENCH_PHASE_S seconds) exits 0, its case
     line counts launches of the three kernels of the main path, and its
     last line is bench.py's record naming this card.

Each of phases 5-14 sets the launch counters to 0 just before the path it
drives and reads them just after (phase 15's subprocess does so around its
timed runs and reports them); a kernel of that path that was not
launched fails the run.

Prints its own duration, the card line and one JSON line of per-kernel
results (phase 14's numbers under "users_sizes", phase 15's record under
"bench") before the last
line, ``{"ok": true, "device": {...}}``: launches
on the main path,
max abs error against the plain version, the kernel's, the plain
version's and the library's time (none: no PyTorch call computes any of
these functions), and the least time the card could take for the same
work (``bound_ms``, ``bound_by``): the bytes each function must move over
3.35 TB/s, or its int32 operations over 16.7 TOP/s (64 int32 lanes per SM
per clock x 132 SMs x 1.98 GHz), whichever is larger. The operations are
counted term by term from the functions' bodies (the constants above
``bounds``), with the band candidates that this run's data scans counted
by the plain versions as they run. Without CUDA, or
when any phase fails, it exits non-zero and prints no result.

Usage: python3 chip_smoke.py [--parent DIR]
"""

from __future__ import annotations

import argparse
import contextlib
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
# phase 3a: the row kernel's retry variant at these strengths, bpp 1-4
ROW_STRENGTHS = (0, 1, 2, 19, 40, 255)
# row 0's ladder (the row kernel's retry variant) at these cluster sizes,
# in phase 3a besides the size it picks; phase 6c and the turns of 3b time
# it at LADDER_TIMES on row 0 of phase 6's batch at ROW0_STRENGTHS
ROW_LADDER_CHECKS = (1, 2, 4, 8)
ROW0_STRENGTHS = (90, 255)
# phase 6: the rows (row 0 and rows 1..PLAIN_ROWS-1) that the plain
# version of the image kernel's adaptive variant runs on the batch, and
# those that the sequential plain version of its retry variant runs on the
# failed images (SEQUENTIAL_ROWS); the retry variant (the ladder) at full
# depth is held to the plain ladder and to the host loop, and both kernels
# are timed at full depth
PLAIN_ROWS = 64
SEQUENTIAL_ROWS = 16
# the image kernel's retry variant (the ladder) at these cluster sizes, in
# phase 3a besides the size it picks; phase 6 and the turns of 3b add 4
LADDER_CHECKS = (1, 2, 8)
LADDER_TIMES = (1, 2, 4, 8)
# phase 3a: real heights of the give-up batch's images (ops/edges.GIVE_UP)
RAGGED_HEIGHTS = (4, 2, 1, 3, 4, 2)
KERNELS = (
    # name, source, TPU kernel it replaces
    ("hist", "pngloss_tpu_torch/csrc/hist.cu",
     "pngloss_tpu/ops/pallas_hist.py:38"),
    ("row", "pngloss_tpu_torch/csrc/row.cu",
     "pngloss_tpu/ops/pallas_row.py:194"),
    ("row_retry", "pngloss_tpu_torch/csrc/row.cu",
     "pngloss_tpu/ops/optimize_pallas.py:300 (row 0: the while_loop over the "
     "strength around pallas_row.py:194)"),
    ("image", "pngloss_tpu_torch/csrc/image.cu",
     "pngloss_tpu/ops/pallas_image.py:107"),
    ("image_adaptive", "pngloss_tpu_torch/csrc/image.cu",
     "pngloss_tpu/ops/pallas_image.py:107 (adaptive=True)"),
    ("image_retry", "pngloss_tpu_torch/csrc/image.cu",
     "pngloss_tpu/ops/optimize_pallas.py:260 (the scan over rows and the "
     "while_loop over the strength around pallas_row.py:194)"),
)
EMBED_SEED, EMBED_SMALL_SEED, EMBED_SMALL_STRENGTH = SEED + 5, 700, 45
ROOT = os.path.dirname(os.path.abspath(__file__))
CLI_KERNELS = ("hist", "row_retry", "image")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
# 64 int32 lanes per SM per clock x 132 SMs x 1.98 GHz (boost clock)
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# int32 operations of each function, counted from the scalar model's body
# (pngloss_tpu_torch/reference.py, after optimize_state.c) and, for the
# row cost, the plain version's (ops/optimize.row_cost): one add,
# subtract, multiply, divide, compare, select, shift, mask, abs or
# leading-zero count is one operation; loads and stores are bytes. Bodies
# that run for some data only (a new best symbol, a frequency tie, the
# empty-band fallback) are left out, and the band candidates are counted
# from this run's data, so each count is the least the function does.
#   predictor, per filter (filter_predict): none, sub, up 0; avg: add,
#   shift 2; paeth: 3 add/sub, 3 abs, 3 compares, an and, 2 selects 12
PREDICT_OPS = (0, 0, 0, 2, 12)
#   pre-pass, per sample and filter 1-4: predictor, residual subtract,
#   & 0xFF (filter 0's residual is the byte itself). The real-size mask is
#   per vector of samples, the bin offset of a filter is a constant and
#   the increment is a memory operation: none is counted
HIST_RESIDUAL_OPS = 2
#   one channel of one pixel under one filter (_run_pixel), beside its
#   predictor: carried error add 1; the +-256 wrap (subtract, 2 compares,
#   select-add, subtract) 5; filtered residual 1; band start (sign test,
#   remainder, subtract, + s) 4; clamp tests (2 add-compares, mx < mn) 5;
#   histogram update 1
CHANNEL_OPS = 17
#   each band candidate: loop step and test 2, back = symbol + predictor
#   1, symbol & 0xFF 1, the two frequency compares 2
CANDIDATE_OPS = 6
#   per pixel: a colour-difference subtract per channel, and per dither
#   lane a channel feeds (bpp 1 and 3: 3 lanes, bpp 2 and 4: 4) the Sierra
#   split: /bleed 1; twos: /16, * and - 3, 4 adds; threes: /8, * and - 3,
#   2 adds; fours: *2 /9 2, * and - 2, 2 adds; five: /2, - 2, 1 add; the
#   rest 1 add: 23
DIFFUSE_OPS, FED_LANES = 23, {1: 3, 2: 4, 3: 3, 4: 4}
#   image kernel, per channel and neighbour (above, diag, left) of the
#   derivative error: 2 partial subtracts, their difference, square, sum
#   5 (+1 multiply by a channel weight of 3: bpp 1 and 2's gray); per
#   pixel 3 adds joining them into the row's total
DERIV_OPS, DERIV_PIXEL_OPS = 5, 3
#   image kernel, per row and filter: over the 256 bins (delta subtract,
#   test, leading zeros, 33 +, multiply, add) 6 each; then /128, add and
#   the winner compare 3
COST_BIN_OPS, COST_ROW_OPS = 6, 3
#   adaptive variant, per channel of each candidate row: the 5 trial
#   predictors, and per trial subtract, & 0xFF, < 128, 256 -, select, add 6
MSAD_TRIAL_OPS = 6
# why every kernel's library_ms is null
NO_LIBRARY = ("no PyTorch call computes any of them: the pre-pass needs five "
              "predictors' residuals before any bincount, and row and "
              "image are sequential recurrences")
EMBED_KERNELS = ("hist", "row_retry", "image_retry")
# phase 12: batches (one seed each), end-to-end images a batch and their
# largest side, and the largest kernel bucket in image-kernel channel steps
FUZZ_SEED, FUZZ_BATCHES, FUZZ_E2E, FUZZ_MAX_PX = 1200, 40, 5, 8
FUZZ_MAX_STEPS = 512
# phase 13: the ragged corpus (images, sides in px, seed), the pool sizes
# run once each beside the turns, and the device-side spin (cycles, ~2 s
# at 1.98 GHz) that must outlast dispatch_buckets' return
DISPATCH_N, DISPATCH_SIDES, DISPATCH_SEED = 100, (40, 400), SEED + 13
DISPATCH_POOLS = (2, 4, 8, 32)
DISPATCH_SPIN_CYCLES = 4_000_000_000
# phase 14: users' shapes (H, W) and the rows N (h_real) over which the
# plain versions of the image stages run at full width, from the whole
# image's pre-pass and row 0: rows 1..N-1, at ~1.6 ms a channel step
# (eager, launch by launch from the host) on an H100, so that the plain
# checks of the phase (row 0 included) take ~90 s of its 150; the full
# card's batches; the gray embedding batch and its N
PHOTO, SCREEN = (3000, 4000), (1080, 1920)
USER_ROWS = {"photo": 2, "screenshot": 2}
USERS_SEED = SEED + 14
CARD_IMAGES = (132, 264)
GRAY_IMAGES, GRAY_ROWS = 16, 8
# phase 15: the seconds bench_torch.py's bench case may take, start-up
# and its gates' plain runs on the CPU included
BENCH_PHASE_S = 30


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def nvcc_version() -> str:
    """The last line of ``nvcc --version`` (the compiler's build)."""
    from pngloss_tpu_torch.ops import _build

    return subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]


def cuda_ms(fn, reps: int = 1, warm: bool = True) -> float:
    """Device time of one call of fn, by CUDA events over reps calls. The
    device first spins for ~5 ms, so the host has queued every call before
    the first one starts: a kernel of a few tens of microseconds is
    otherwise timed by how fast the host issues it."""
    import torch

    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
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
    if not got.numel():
        return 0
    return int((got.long().cpu() - want.long().cpu()).abs().max())


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


def synthetic_rgb(rng, n: int, h: int, w: int,
                  dtype=np.int64) -> np.ndarray:
    """(n, h, w, 4) RGBA, opaque: smooth gradients plus seeded noise, drawn
    as ``dtype`` (np.int16 draws other noise, ~4x faster)."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x + y) * 255 // max(h + w - 2, 1)], -1).astype(dtype)
    out = np.full((n, h, w, 4), 255, np.uint8)
    out[..., :3] = np.clip(
        base[None] + rng.integers(-12, 13, (n, h, w, 3), dtype=dtype), 0, 255)
    return out


def check_kernels(device, log=None) -> dict[str, int]:
    """Phase 3a: every kernel against its plain version on small shapes
    that reach every branch, and on the EDGES cases (their plain versions
    on the CPU); the image kernel's retry variant (the ladder) at the
    cluster size it picks and at LADDER_CHECKS, its rounds against the
    plain ladder's. Returns the max abs error per kernel (raises unless all
    are 0)."""
    import torch

    from pngloss_tpu_torch.convert import Carry
    from pngloss_tpu_torch.ops import hist, image, ladder, row
    from pngloss_tpu_torch.ops.edges import (
        EDGES,
        HIST_EDGES,
        edge_inputs,
        hist_edge_inputs,
        row_retry_inputs,
    )
    from pngloss_tpu_torch.ops.row import zero_carry

    rng = np.random.default_rng(SEED + 1)
    rng6 = np.random.default_rng(SEED + 11)
    errs = dict.fromkeys((k[0] for k in KERNELS), 0)
    ladder_rounds: dict = {}      # cluster size -> rounds summed per image
    row_rounds: dict = {}         # the same for row 0's ladder
    oks = set()
    retried = False
    row_retried = set()       # strengths the row retry variant retried from

    def row_retry_err(on_card, on_cpu):
        got = row.row_retry(*on_card)
        for s_k, n in zip(on_card[0].tolist(), got[2].tolist()):
            if n > 1:
                row_retried.add(s_k)
        return _max_err(got, row.row_retry_ref(*on_cpu))
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
            # the row retry variant, from the zero state and from a
            # mid-image one, on inputs of their own
            st6 = row_state(rng6, len(ROW_STRENGTHS), 7, bpp, device)
            s6 = _i32(ROW_STRENGTHS, device)
            w6 = _i32([7, 5, 7, 2, 7, 6], device)
            carry = Carry(st6["qprev"], row_state(rng6, 6, 7, bpp, device)[
                "orig"], st6["e0"], st6["e1"], st6["hist"])
            for c in (zero_carry(6, 7, bpp, device), carry):
                args = (s6, bleed, st6["orig"], c, st6["ofreq"], w6)
                errs["row_retry"] = max(errs["row_retry"],
                                        row_retry_err(args, args))

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
            want = image.image_rows_retry_ref(*args)
            errs["image_retry"] = max(errs["image_retry"], _max_err(
                image.image_rows(*args, adaptive=True, retry=True), want))
            retried = retried or bool((want[2] > img.shape[1] - 1).any())
    for name in sorted(HIST_EDGES):
        for bpp in (1, 2, 3, 4):
            for on_card, on_cpu in zip(hist_edge_inputs(name, bpp, device),
                                       hist_edge_inputs(name, bpp, "cpu")):
                errs["hist"] = max(errs["hist"], _max_err(
                    hist.original_frequencies(*on_card),
                    hist.original_frequencies_ref(*on_cpu)))
    for name in sorted(EDGES):
        row_args, image_args = edge_inputs(name, device)
        row_cpu, image_cpu = edge_inputs(name, "cpu")
        errs["row"] = max(errs["row"], _max_err(
            row.row_attempt(*row_args), row.row_attempt_ref(*row_cpu)))
        for on_card, on_cpu in zip(row_retry_inputs(image_args),
                                   row_retry_inputs(image_cpu)):
            errs["row_retry"] = max(errs["row_retry"],
                                    row_retry_err(on_card, on_cpu))
            if name.startswith("retry"):
                want = row.row_retry_ref(*on_card)
                for k in ROW_LADDER_CHECKS:
                    errs["row_retry"] = max(errs["row_retry"], row_ladder_err(
                        on_card, on_cpu, want, k, row_rounds))
        for key, adaptive in (("image", False), ("image_adaptive", True)):
            errs[key] = max(errs[key], _max_err(
                image.image_rows(*image_args, adaptive=adaptive),
                image.image_rows_ref(*image_cpu, adaptive=adaptive)))
        want = image.image_rows_retry_ref(*image_cpu)
        errs["image_retry"] = max(errs["image_retry"], _max_err(
            image.image_rows(*image_args, adaptive=True, retry=True), want))
        if name.startswith("retry"):
            for k in LADDER_CHECKS:
                errs["image_retry"] = max(errs["image_retry"], ladder_err(
                    image_args, image_cpu, want, k, ladder_rounds))
    for key, err in check_give_up(device, ladder_rounds,
                                  row_rounds).items():
        errs[key] = max(errs[key], err)
    if any(errs.values()):
        raise AssertionError(f"kernel != plain version: {errs}")
    if oks != {0, 1}:
        raise AssertionError(f"small adaptive inputs gave ok {oks}, not both")
    if not retried:
        raise AssertionError("no row of the small inputs retried")
    if not {1, 2, 32, 255} <= row_retried:
        raise AssertionError(f"the row retry variant retried from strengths "
                             f"{sorted(row_retried)} only")
    if log:
        log(f"  ladder (image retry variant) on the EDGES retry cases and "
            f"the give-up batch: k {sorted(ladder_rounds)}, rounds "
            f"{ladder_rounds}; picks k={image.ladder_size(4, 3, device)} "
            f"for 4 images, {image.ladder_size(6, 3, device)} for 6")
        log("  clusters resident at once per bpp {k: clusters}: " + ", ".join(
            f"bpp {bpp} {ladder.resident_clusters(image.clusters, bpp, device)}"
            for bpp in (1, 2, 3, 4)) + "; k picked at bpp 3 for B images: "
            + str({b: image.ladder_size(b, 3, device)
                   for b in (1, 2, 16, 32, 64, 132)}))
        log(f"  row 0's ladder (row retry variant) on the EDGES retry "
            f"cases' rows 0 and 1 and the give-up batch: k "
            f"{sorted(row_rounds)}, rounds {row_rounds}")
        log("  row ladder: clusters resident at once per bpp: " + ", ".join(
            f"bpp {bpp} {ladder.resident_clusters(row.clusters, bpp, device)}"
            for bpp in (1, 2, 3, 4)) + "; k picked at bpp 3 for B images: "
            + str({b: row.ladder_size(b, 3, device)
                   for b in (1, 2, 6, 16, 32, 64, 132)}))
    return errs


def ladder_err(on_card, on_cpu, want, k: int, seen: dict,
               never_pass=None) -> int:
    """The ladder at cluster size k on card tensors against ``want`` (the
    sequential plain version's rows, filters and attempts), and its rounds:
    at k = 1 the attempts, at the largest of LADDER_CHECKS the plain
    ladder's on the CPU (``on_cpu``). Adds the rounds to ``seen[k]``.
    Returns the max abs error."""
    import torch

    from pngloss_tpu_torch.ops import image

    b = on_card[0].shape[0]
    rounds = torch.zeros(b, dtype=torch.int32, device=on_card[0].device)
    got = image.image_rows(*on_card, adaptive=True, retry=True, k=k,
                           rounds=rounds, never_pass=never_pass)
    seen[k] = seen.get(k, 0) + int(rounds.sum())
    err = _max_err(got, want)
    if k == 1:
        return max(err, _max_err(rounds, want[2]))
    if k == max(LADDER_CHECKS):
        plain = torch.zeros(b, dtype=torch.int32)
        image.image_rows_ladder_ref(
            *on_cpu, k=k, rounds=plain,
            never_pass=None if never_pass is None else never_pass.cpu())
        err = max(err, _max_err(rounds, plain))
    return err


def row_ladder_err(on_card, on_cpu, want, k: int, seen: dict,
                   never_pass=None) -> int:
    """Row 0's ladder at cluster size k on card tensors against ``want``
    (the sequential plain version's output on the same tensors), its
    rounds against ceil(attempts / k), and at the largest of
    ROW_LADDER_CHECKS against the plain ladder's on the CPU (``on_cpu``).
    Adds the rounds to ``seen[k]``. Returns the max abs error."""
    import torch

    from pngloss_tpu_torch.ops import row

    b = on_card[0].shape[0]
    rounds = torch.zeros(b, dtype=torch.int32, device=on_card[0].device)
    got = row.row_retry(*on_card, never_pass=never_pass, k=k, rounds=rounds)
    seen[k] = seen.get(k, 0) + int(rounds.sum())
    err = max(_max_err(got, want),
              _max_err(rounds, (want[2] + k - 1) // k))
    if k == max(ROW_LADDER_CHECKS):
        plain = torch.zeros(b, dtype=torch.int32)
        row.row_retry_ladder_ref(
            *on_cpu, k=k, rounds=plain,
            never_pass=None if never_pass is None else never_pass.cpu())
        err = max(err, _max_err(rounds, plain))
    return err


def check_give_up(device, ladder_rounds: dict,
                  row_rounds: dict) -> dict[str, int]:
    """Phase 3a, the give-up branch: the image kernel's adaptive and retry
    variants (the latter also at LADDER_CHECKS) and the row kernel's retry
    variant (row 0 and row 1; also at ROW_LADDER_CHECKS) with the
    test-only never_pass flag on images
    at strengths 0, 1, 2 and 40 beside unflagged images, at bpp 1-4,
    against their plain versions on the same card tensors. Flagged images
    must get ok 0 and take s + 1 attempts a row; unflagged ones must equal
    themselves run alone. Then the same batch with real heights
    RAGGED_HEIGHTS: every image variant stops at the last real row. Returns
    the max abs error per variant."""
    from pngloss_tpu_torch.convert import Carry
    from pngloss_tpu_torch.ops import image, row
    from pngloss_tpu_torch.ops.edges import (
        GIVE_UP_H,
        give_up_inputs,
        row_retry_inputs,
    )

    errs = {"image": 0, "image_adaptive": 0, "image_retry": 0,
            "row_retry": 0}
    for bpp in (1, 2, 3, 4):
        args, flags = give_up_inputs(bpp, device)
        flagged = flags.bool()
        for rargs, rcpu in zip(row_retry_inputs(args),
                               row_retry_inputs(give_up_inputs(bpp,
                                                               "cpu")[0])):
            got = row.row_retry(*rargs, never_pass=flags)
            want = row.row_retry_ref(*rargs, never_pass=flags)
            errs["row_retry"] = max(errs["row_retry"], _max_err(got, want))
            for k in ROW_LADDER_CHECKS:
                errs["row_retry"] = max(errs["row_retry"], row_ladder_err(
                    rargs, rcpu, want, k, row_rounds, never_pass=flags))
            if _max_err(got[2][flagged], rargs[0][flagged] + 1):
                raise AssertionError(
                    f"row retry give-up at bpp {bpp}: attempts "
                    f"{got[2].tolist()} for never_pass {flags.tolist()}")
            for k in (~flagged).nonzero().squeeze(1).tolist():
                one = [Carry(*(t[k:k + 1] for t in a)) if isinstance(a, Carry)
                       else a[k:k + 1] if hasattr(a, "shape") else a
                       for a in rargs]
                (q, *st), f, n = got
                errs["row_retry"] = max(errs["row_retry"], _max_err(
                    row.row_retry(*one),
                    (tuple(t[k:k + 1] for t in (q, *st)), f[k:k + 1],
                     n[k:k + 1])))
        retry = image.image_rows(*args, adaptive=True, retry=True,
                                 never_pass=flags)
        adaptive = image.image_rows(*args, adaptive=True, never_pass=flags)
        want = image.image_rows_retry_ref(*args, never_pass=flags)
        errs["image_retry"] = max(errs["image_retry"], _max_err(retry, want))
        cpu = [a.cpu() if hasattr(a, "cpu") else a for a in args]
        for k in LADDER_CHECKS:
            errs["image_retry"] = max(errs["image_retry"], ladder_err(
                args, cpu, want, k, ladder_rounds, never_pass=flags))
        errs["image_adaptive"] = max(errs["image_adaptive"], _max_err(
            adaptive, image.image_rows_ref(*args, adaptive=True,
                                           never_pass=flags)))
        want = (args[0][flagged] + 1) * (GIVE_UP_H - 1)
        if _max_err(retry[2][flagged], want) or bool(
                adaptive[2][flagged].any()):
            raise AssertionError(
                f"give-up at bpp {bpp}: attempts {retry[2].tolist()}, ok "
                f"{adaptive[2].tolist()} for never_pass {flags.tolist()}")
        for k in (~flagged).nonzero().squeeze(1).tolist():
            one = [a[k:k + 1] if hasattr(a, "shape") else a for a in args]
            alone = image.image_rows(*one, adaptive=True, retry=True)
            errs["image_retry"] = max(errs["image_retry"], _max_err(
                alone, tuple(t[k:k + 1] for t in retry)))
        # ragged: padded rows are not run, come out as 0, and count in
        # neither ok nor attempts
        hr = _i32(RAGGED_HEIGHTS, device)
        errs["image"] = max(errs["image"], _max_err(
            image.image_rows(*args, h_real=hr),
            image.image_rows_ref(*args, h_real=hr)))
        errs["image_adaptive"] = max(errs["image_adaptive"], _max_err(
            image.image_rows(*args, adaptive=True, never_pass=flags,
                             h_real=hr),
            image.image_rows_ref(*args, adaptive=True, never_pass=flags,
                                 h_real=hr)))
        want = image.image_rows_retry_ref(*args, never_pass=flags, h_real=hr)
        for k in (None, *LADDER_CHECKS):
            errs["image_retry"] = max(errs["image_retry"], _max_err(
                image.image_rows(*args, adaptive=True, retry=True, k=k,
                                 never_pass=flags, h_real=hr), want))
    return errs


def main_inputs(device):
    """The main path's kernel inputs: 16 x 512x512 RGB at -s 19, as
    (s, w_real, h_real, rows (B, H, W*bpp) uint8)."""
    import torch

    rgba = synthetic_rgb(np.random.default_rng(SEED + 2), N_IMAGES, SIDE,
                         SIDE)
    rows = torch.as_tensor(rgba[..., :3].reshape(N_IMAGES, SIDE, SIDE * 3),
                           device=device)
    b = N_IMAGES
    return (_i32([STRENGTH] * b, device), _i32([SIDE] * b, device),
            _i32([SIDE] * b, device), rows)


def timed_entry(name, fn, ref, shape: str, reps: int, log,
                keep: bool = False) -> dict:
    """A kernel (fn) against its plain version (ref) on the same inputs:
    exact, or it raises. ``ref(count)`` runs once, adds the band
    candidates it scans to ``count`` where it has a band (row and image:
    one sum and one add per channel step), and is timed by that run; the
    kernel by CUDA events over reps calls after a warm-up. ``keep``: the
    plain version's output is returned too, as "want"."""
    import torch

    count = torch.zeros((), dtype=torch.int64, device="cuda")
    torch.cuda.current_stream().synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = ref(count)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = _max_err(fn(), want)
    if err:
        raise AssertionError(f"{name} at {shape}: max abs err {err}")
    ms = cuda_ms(fn, reps)
    log(f"  {name:5s} {shape:28s} kernel {ms:10.3f} ms  "
        f"plain {plain_ms:10.3f} ms")
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, shape=shape,
               candidates=int(count))
    if keep:
        out["want"] = want
    return out


def time_kernels(device, log) -> dict[str, dict]:
    """Phase 3b: each kernel against its plain version at the main path's
    shapes (16 x 512x512 RGB at -s 19; the image kernel over all 511 rows,
    its plain version replaying one row step from a CUDA graph). Exact;
    the plain version runs once and is timed by that run."""
    import torch

    from pngloss_tpu_torch.ops import hist, image, row
    from pngloss_tpu_torch.ops.optimize import strength_loop
    from pngloss_tpu_torch.ops.optimize_gpu import row0

    s, w_real, h_real, rows = main_inputs(device)
    b, bpp, w = N_IMAGES, 3, SIDE
    out = {}

    def entry(name, fn, ref, shape, reps):
        out[name] = timed_entry(name, fn, ref, shape, reps, log)

    entry("hist", lambda: hist.original_frequencies(rows, bpp, w_real, h_real),
          lambda _: hist.original_frequencies_ref(rows, bpp, w_real, h_real),
          f"{b}x{SIDE}x{w}x{bpp}", 20)
    ofreq = hist.original_frequencies(rows, bpp, w_real, h_real)
    orig0 = rows[:, 0].reshape(b, w, bpp).to(torch.int32)
    z = torch.zeros_like(orig0)
    ze = torch.zeros((b, w + 5, 4), dtype=torch.int32, device=device)
    zh = torch.zeros((b, 256), dtype=torch.int32, device=device)
    args = (s, 2, orig0, z, ze, ze, zh, ofreq, w_real)
    entry("row", lambda: row.row_attempt(*args),
          lambda n: row.row_attempt_ref(*args, count=n),
          f"{b}x1x{w}x{bpp} (row 0)", 10)

    def retry_ref(n):
        # row_retry_ref, counting the band candidates of every attempt
        return strength_loop(
            lambda s_try: row.row_attempt_ref(s_try, 2, orig0, z, ze, ze, zh,
                                              ofreq, w_real, count=n),
            s, orig0, z, z, ze, ze, zh, w_real)

    chosen = row.ladder_size(b, bpp, device)
    entry("row_retry", lambda: row.row0_retry(s, 2, orig0, ofreq, w_real),
          retry_ref, f"{b}x1x{w}x{bpp} (row 0 with its strength loop; "
          f"ladder k={chosen})", 10)
    rounds = torch.zeros(b, dtype=torch.int32, device=device)
    out["row_retry"].update(attempts=int(row.row0_retry(
        s, 2, orig0, ofreq, w_real, rounds=rounds)[2].sum()), k=chosen,
        rounds=rounds.tolist())
    c0, _ = row0(s, 2, orig0, ofreq, w_real)
    args = (s, 2, w_real, ofreq, rows, c0.qprev, c0.e0, c0.e1, c0.hist)
    entry("image", lambda: image.image_rows(*args),
          lambda n: image.image_rows_ref(*args, count=n),
          f"{b}x{SIDE}x{w}x{bpp} (rows 1-{SIDE - 1})", 2)
    return out


def kernel_times(device) -> dict[str, float]:
    """CUDA-event ms of each kernel alone at the main path's shapes, no
    plain version: what phase 3b runs for this tree and, in a subprocess,
    for the tree given with --parent (whose package comes first on
    sys.path there)."""
    import inspect

    import torch

    from pngloss_tpu_torch.ops import hist, image, row
    from pngloss_tpu_torch.ops.optimize_gpu import row0

    s, w_real, h_real, rows = main_inputs(device)
    b, bpp, w = N_IMAGES, 3, SIDE
    ofreq = hist.original_frequencies(rows, bpp, w_real, h_real)
    orig0 = rows[:, 0].reshape(b, w, bpp).to(torch.int32)
    z = torch.zeros_like(orig0)
    ze = torch.zeros((b, w + 5, 4), dtype=torch.int32, device=device)
    zh = torch.zeros((b, 256), dtype=torch.int32, device=device)
    c0, _ = row0(s, 2, orig0, ofreq, w_real)
    img = (s, 2, w_real, ofreq, rows, c0.qprev, c0.e0, c0.e1, c0.hist)
    retry = {}
    if hasattr(row, "RETRY_LAUNCHES"):       # an earlier tree has none
        retry["row_retry"] = cuda_ms(lambda: row.row0_retry(
            s, 2, orig0, ofreq, w_real), 10)
        if "k" in inspect.signature(row.row_retry).parameters:
            for k in LADDER_TIMES:       # the main path's row 0 at each k
                retry[f"row_retry_k{k}"] = cuda_ms(lambda: row.row0_retry(
                    s, 2, orig0, ofreq, w_real, k=k), 10)
        retry.update(row0_times(device))
    if hasattr(image, "RETRY_LAUNCHES"):     # an earlier tree has none
        # no row of these images fails: the retry variant's time beside
        # the adaptive variant's on the same work
        retry["image_retry"] = cuda_ms(lambda: image.image_rows(
            *img, adaptive=True, retry=True), 3)
    flat = torch.full_like(rows, 7)   # every sample of a filter in one bin
    return {
        "hist": cuda_ms(lambda: hist.original_frequencies(
            rows, bpp, w_real, h_real), 20),
        "hist_flat": cuda_ms(lambda: hist.original_frequencies(
            flat, bpp, w_real, h_real), 20),
        "row": cuda_ms(lambda: row.row_attempt(
            s, 2, orig0, z, ze, ze, zh, ofreq, w_real), 10),
        "image": cuda_ms(lambda: image.image_rows(*img), 3),
        "image_adaptive": cuda_ms(
            lambda: image.image_rows(*img, adaptive=True), 3),
        **retry,
        **(embedding_times(device) if "image_retry" in retry else {}),
        **(gray_times(device) if "image_retry" in retry else {}),
    }


def row0_inputs(device):
    """Row 0 of phase 6's batch (8 smooth and 8 noise 512x512 RGB, seed
    5) as row-kernel inputs: (orig0 (B, W, 3) int32, ofreq, w_real), and
    the batch as RGBA."""
    import torch

    from pngloss_tpu_torch.ops import hist

    rgba = embedding_batch(np.random.default_rng(EMBED_SEED))
    b, bpp = N_IMAGES, 3
    rows = torch.as_tensor(np.ascontiguousarray(rgba[..., :3]).reshape(
        b, SIDE, SIDE * bpp), device=device)
    wr = _i32([SIDE] * b, device)
    ofreq = hist.original_frequencies(rows, bpp, wr, _i32([SIDE] * b,
                                                          device))
    return rows[:, 0].reshape(b, SIDE, bpp).to(torch.int32), ofreq, wr, rgba


def row0_times(device) -> dict[str, float]:
    """Row 0's strength loop (the row kernel's retry variant) in this tree
    or an earlier one (kernel_times) on row 0 of phase 6's batch at each
    of ROW0_STRENGTHS, at the cluster size it picks and, in a tree with
    the row ladder, at each of LADDER_TIMES ("_k<size>"), CUDA-event
    ms."""
    import inspect

    from pngloss_tpu_torch.ops import row

    orig0, ofreq, wr, _ = row0_inputs(device)
    sizes = [None]
    if "k" in inspect.signature(row.row_retry).parameters:
        sizes += list(LADDER_TIMES)
    out = {}
    for st in ROW0_STRENGTHS:
        s = _i32([st] * N_IMAGES, device)
        for k in sizes:
            kw, tag = ({}, "") if k is None else ({"k": k}, f"_k{k}")
            out[f"row_retry_p6_s{st}{tag}"] = cuda_ms(
                lambda: row.row0_retry(s, 2, orig0, ofreq, wr, **kw), 5)
    return out


def embedding_times(device) -> dict[str, float]:
    """Embedding mode's per-row path in this tree or an earlier one
    (kernel_times): the image kernel's retry variant on phase 6's failed
    images (rows 1-511, from row 0's state) and on the give-up batch at bpp
    3, at the cluster size it picks and, in a tree with the ladder, at
    each of LADDER_TIMES ("_k<size>"), CUDA-event ms; and the best of two
    whole embedding calls (``optimize_rgba_batch``) on phase 6's batch,
    host wall ms."""
    import inspect

    import torch

    from pngloss_tpu_torch.ops import image
    from pngloss_tpu_torch.ops.edges import give_up_inputs
    from pngloss_tpu_torch.ops.optimize_gpu import row_step, zero_carry
    from pngloss_tpu_torch.pipeline import optimize_rgba_batch

    rgba = embedding_batch(np.random.default_rng(EMBED_SEED))
    b, bpp = N_IMAGES, 3
    rows = torch.as_tensor(np.ascontiguousarray(rgba[..., :3]).reshape(
        b, SIDE, SIDE * bpp), device=device)
    ofreq, _, _, (_, _, ok) = speculate(rows, bpp, STRENGTH, device)
    sel = (ok == 0).nonzero().squeeze(1)
    n = len(sel)
    s, wr = _i32([STRENGTH] * n, device), _i32([SIDE] * n, device)
    sub = rows[sel].contiguous()
    cb, _, _ = row_step(s, 2, sub[:, 0].reshape(n, SIDE, bpp).to(torch.int32),
                        zero_carry(n, SIDE, bpp, device), ofreq[sel], wr)
    args = (s, 2, wr, ofreq[sel], sub, cb.qprev, cb.e0, cb.e1, cb.hist)
    gargs, flags = give_up_inputs(bpp, device)
    sizes = [None]
    if "k" in inspect.signature(image.image_rows).parameters:
        sizes += list(LADDER_TIMES)
    out = {}
    for k in sizes:
        kw, tag = ({}, "") if k is None else ({"k": k}, f"_k{k}")
        out["image_retry_p6" + tag] = cuda_ms(lambda: image.image_rows(
            *args, adaptive=True, retry=True, **kw), 2)
        out["image_retry_give_up" + tag] = cuda_ms(lambda: image.image_rows(
            *gargs, adaptive=True, retry=True, never_pass=flags, **kw), 5)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimize_rgba_batch(list(rgba), STRENGTH, use_row_filters=False,
                            device=device)
        walls.append((time.perf_counter() - t0) * 1e3)
    out["embedding_call"] = min(walls)
    return out


def gray_times(device) -> dict[str, float]:
    """Phase 14's gray embedding batch (16 x 512x512, bpp 1) in this tree
    or an earlier one (kernel_times): the image kernel's retry variant over
    rows 1-511 from the batch's pre-pass and row 0, at the cluster size
    the tree picks and, in a tree with the ladder, at each of LADDER_TIMES
    ("_k<size>"), CUDA-event ms; and the best of two whole embedding calls
    (``optimize_rgba_batch``), host wall ms."""
    import inspect

    import torch

    from pngloss_tpu_torch.ops import image
    from pngloss_tpu_torch.pipeline import optimize_rgba_batch

    args, rgba = gray_inputs(device)
    sizes = [None]
    if "k" in inspect.signature(image.image_rows).parameters:
        sizes += list(LADDER_TIMES)
    out = {}
    for k in sizes:
        kw, tag = ({}, "") if k is None else ({"k": k}, f"_k{k}")
        out["image_retry_gray" + tag] = cuda_ms(lambda: image.image_rows(
            *args, adaptive=True, retry=True, **kw), 2)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimize_rgba_batch(list(rgba), STRENGTH, use_row_filters=False,
                            device=device)
        walls.append((time.perf_counter() - t0) * 1e3)
    out["embedding_gray_call"] = min(walls)
    return out


PARENT_TIMES = r"""
import importlib.util, json, sys
import torch
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location("smoke", sys.argv[2])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
print(json.dumps(smoke.kernel_times(torch.device("cuda", 0))))
"""


def parent_times(parent: str) -> dict[str, float]:
    """kernel_times of the tree at ``parent``, built there, in a
    subprocess."""
    proc = subprocess.run(
        [sys.executable, "-c", PARENT_TIMES, os.path.abspath(parent),
         os.path.abspath(__file__)], cwd=parent, capture_output=True,
        text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"the parent's kernel_times failed:\n"
                             f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def sm_clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def compare_parent(device, parent: str, log) -> dict:
    """Phase 3b with --parent: the kernels of both trees in turns."""
    turns = {}
    for k, who in enumerate(("parent", "this", "this", "parent")):
        times = (parent_times(parent) if who == "parent"
                 else kernel_times(device))
        turns.setdefault(who, []).append(times)
        log(f"  turn {k + 1} ({who}): " + ", ".join(
            f"{n} {t:.3f} ms" for n, t in times.items()))
    for name in turns["this"][0]:
        if name not in turns["parent"][0]:
            log(f"  {name}: n/a in the parent (it has no such kernel)")
    log(f"  SM clock after the turns (now, max): {sm_clocks()}")
    return turns


def pixel_ops(bpp: int, deriv: bool, msad: bool) -> int:
    """Fixed int32 operations of one pixel of one row summed over the 5
    filters (band candidates apart), from the counts above."""
    weight3 = {1: 1, 2: 1}.get(bpp, 0)        # channels of weight 3
    ops = 0
    for f in range(5):
        ops += bpp * (PREDICT_OPS[f] + CHANNEL_OPS) + bpp
        ops += bpp % 2 == 0                     # transparency test (alpha)
        ops += DIFFUSE_OPS * FED_LANES[bpp]
        if deriv:
            ops += 3 * (bpp * DERIV_OPS + weight3) + DERIV_PIXEL_OPS
        if msad:
            ops += bpp * (sum(PREDICT_OPS) + 5 * MSAD_TRIAL_OPS)
    return ops


def bounds(name: str, b: int, h: int, w: int, bpp: int,
           candidates: int = 0, attempts: int = 0) -> tuple[float, str]:
    """(bound_ms, "bytes" or "operations") of one kernel call at the main
    path's shapes (every column real): inputs read once and outputs
    written once over the HBM rate, or the int32 operations over the int32
    rate. ``candidates``: the band candidates this run's data scans (the
    plain version's count), for row and image. ``attempts``: the row
    attempts this run's data takes, summed over the images, for the retry
    variants (the image kernel's and the row kernel's): each is one row of
    the adaptive variant's work."""
    px, we = b * w * bpp, b * (w + 5) * 4
    if name == "hist":
        nbytes = b * h * w * bpp + 8 * b + 4 * b * 5 * 256
        ops = b * h * w * bpp * (sum(PREDICT_OPS) + 4 * HIST_RESIDUAL_OPS)
    elif name == "row":
        nbytes = (4 * (2 * px + 2 * we + 256 * b + 5 * 256 * b + 2 * b)
                  + 4 * 5 * (px + 256 * b + 2 * we))
        ops = b * w * pixel_ops(bpp, False, False)
        ops += CANDIDATE_OPS * candidates
    elif name == "row_retry":
        # in: s, w_real, orig, qprev, oprev, e0, e1, hist, ofreq; out: the
        # winner's row, histogram and dither rows, its filter (8 bytes),
        # the attempts; each attempt is one row of the adaptive count
        nbytes = (4 * (2 * b + 3 * px + 2 * we + 256 * b + 5 * 256 * b)
                  + 4 * (px + 256 * b + 2 * we + b) + 8 * b)
        ops = attempts * w * pixel_ops(bpp, True, True)
        ops += attempts * 5 * (256 * COST_BIN_OPS + COST_ROW_OPS)
        ops += CANDIDATE_OPS * candidates
    else:
        adaptive = name != "image"
        row_runs = attempts if name == "image_retry" else b * (h - 1)
        nbytes = (b * h * w * bpp + 4 * (px + 2 * we + 256 * b
                                         + 5 * 256 * b + 2 * b)
                  + 4 * (b * (h - 1) * (w * bpp + 1) + b))
        ops = row_runs * w * pixel_ops(bpp, True, adaptive)
        ops += row_runs * 5 * (256 * COST_BIN_OPS + COST_ROW_OPS)
        ops += CANDIDATE_OPS * candidates
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_end_to_end(device) -> list[tuple[bytes, int, bytes]]:
    """Phase 4: PNG bytes against the scalar model + host encoder.
    Returns (input PNG, strength, expected output) per small image."""
    from pngloss_tpu_torch.codec import decode, encode
    from pngloss_tpu_torch.reference import optimize_rgba
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

    from pngloss_tpu_torch.reference import optimize_rgba
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
    counts of its first run, the timings of the adaptive and the retry
    variant of the image kernel, and the inputs and outputs of that run
    (rgba, q, f)."""
    import torch

    from pngloss_tpu_torch.ops import image
    from pngloss_tpu_torch.ops.edges import rows_by_step
    from pngloss_tpu_torch.ops.optimize_gpu import row_step, zero_carry
    from pngloss_tpu_torch.pipeline import optimize_rgba_batch

    rgba = embedding_batch(np.random.default_rng(EMBED_SEED))
    b, bpp = N_IMAGES, 3
    log(f"  inputs: images 0-{N_IMAGES // 2 - 1} smooth, "
        f"{N_IMAGES // 2}-{N_IMAGES - 1} uniform noise, {SIDE}x{SIDE} RGB, "
        f"seed {EMBED_SEED}, -s {STRENGTH}")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    q1, f1 = optimize_rgba_batch(list(rgba), STRENGTH, use_row_filters=False,
                                 device=device)
    wall = time.perf_counter() - t0
    launches = read_counts("[6] optimize_rgba_batch", EMBED_KERNELS)
    # row 0 is one launch of the row kernel's retry variant, rows 1..H-1
    # one of the image kernel's (the ladder over the whole batch); no
    # single row attempt, no speculation
    if (launches["row"], launches["row_retry"], launches["image_adaptive"],
            launches["image_retry"]) != (0, 1, 0, 1):
        raise AssertionError(f"the embedding call launched {launches}")
    t0 = time.perf_counter()
    q2, f2 = optimize_rgba_batch(list(rgba), STRENGTH, use_row_filters=False,
                                 device=device)
    wall2 = time.perf_counter() - t0
    for i in range(b):
        if not (np.array_equal(q1[i], q2[i]) and np.array_equal(f1[i], f2[i])):
            raise AssertionError(f"embedding run 2 differs on image {i}")

    # the images with a row that fails at full strength: the speculation
    # (the adaptive variant, the JAX package's way) flags them
    rows = torch.as_tensor(rgba[..., :3].reshape(b, SIDE, SIDE * bpp),
                           device=device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    ofreq, c0, f0, (qr, fr, ok) = speculate(rows, bpp, STRENGTH, device)
    end.record()
    ok = ok.cpu().numpy()
    spec_ms = start.elapsed_time(end)
    bad, good = np.flatnonzero(ok == 0), np.flatnonzero(ok)
    log(f"  speculation ok per image: {ok.tolist()}")
    if not (len(bad) and len(good)):
        raise AssertionError("the batch does not take both branches")
    s = _i32([STRENGTH] * b, device)
    wr = _i32([SIDE] * b, device)
    orig = rows.view(b, SIDE, SIDE, bpp).to(torch.int32)
    sel = torch.as_tensor(bad, device=device)
    fall = (s[sel], 2, orig[sel], ofreq[sel], wr[sel])

    # the failed images with the strength loop on the host: the row
    # kernel's one-attempt variant once per attempt, the cost and the
    # self-check in PyTorch
    reset_counts()
    t0 = time.perf_counter()
    qh, fh, tries_host = rows_by_step(*fall)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    host_launches = read_counts("[6] the host loop", ("row",))["row"]

    # the retry variant on the failed images, from row 0's state, over all
    # 511 rows: the ladder at the cluster size it picks against its plain
    # version at that size (image_rows_ladder_ref, which replays one round
    # from a CUDA graph) in rows, filters, attempts and rounds; at every
    # size of LADDER_TIMES against the host loop (rows, filters, attempts;
    # at k = 1 the rounds are the attempts); and over rows
    # 1..SEQUENTIAL_ROWS-1 against the sequential plain version
    # (image_rows_retry_ref, one attempt a replay)
    cb, _, first_tries = row_step(
        fall[0], 2, fall[2][:, 0].contiguous(),
        zero_carry(len(bad), SIDE, bpp, device), fall[3], fall[4])
    args = (fall[0], 2, fall[4], fall[3], rows[sel].contiguous(), cb.qprev,
            cb.e0, cb.e1, cb.hist)
    chosen = image.ladder_size(len(bad), bpp, device)
    plain_rounds = torch.zeros(len(bad), dtype=torch.int32, device=device)
    retry = timed_entry(
        "image_retry",
        lambda: image.image_rows(*args, adaptive=True, retry=True),
        lambda n: image.image_rows_ladder_ref(*args, k=chosen,
                                              rounds=plain_rounds, count=n),
        f"{len(bad)}x{SIDE}x{SIDE}x{bpp} (rows 1-{SIDE - 1} of the failed "
        f"images, embedding batch; ladder k={chosen})", 2, log, keep=True)
    want = retry.pop("want")
    host_later = tries_host - first_tries       # rows 1..511, the host loop
    err = _max_err(want, (qh[:, 1:], fh[:, 1:], host_later))
    if err:
        raise AssertionError(f"the plain ladder != the host loop on the "
                             f"failed images: max abs err {err}")
    cut = (*args[:4], args[4][:, :SEQUENTIAL_ROWS].contiguous(), *args[5:])
    seq = timed_entry(
        "image_retry", lambda: image.image_rows(*cut, adaptive=True,
                                                retry=True),
        lambda n: image.image_rows_retry_ref(*cut, count=n),
        f"{len(bad)}x{SEQUENTIAL_ROWS}x{SIDE}x{bpp} (rows 1-"
        f"{SEQUENTIAL_ROWS - 1}, sequential plain version)", 2, log,
        keep=True)
    want_cut = seq.pop("want")
    ladder = {}
    for k in LADDER_TIMES:
        rounds_cut = torch.zeros(len(bad), dtype=torch.int32, device=device)
        err = _max_err(image.image_rows(*cut, adaptive=True, retry=True,
                                        k=k, rounds=rounds_cut), want_cut)
        rounds = torch.zeros(len(bad), dtype=torch.int32, device=device)
        got = image.image_rows(*args, adaptive=True, retry=True, k=k,
                               rounds=rounds)
        err = max(err, _max_err(got, want))
        if k == 1:
            err = max(err, _max_err(rounds, got[2]),
                      _max_err(rounds_cut, want_cut[2]))
        if k == chosen:
            err = max(err, _max_err(rounds, plain_rounds))
        if err:
            raise AssertionError(f"the ladder at k={k} != its plain version "
                                 f"or the host loop (rows 1-{SIDE - 1}) or "
                                 f"the sequential plain version (rows 1-"
                                 f"{SEQUENTIAL_ROWS - 1}) on the failed "
                                 f"images: max abs err {err}")
        ms = cuda_ms(lambda: image.image_rows(*args, adaptive=True,
                                              retry=True, k=k), 2)
        ladder[k] = dict(ms=ms, rounds=rounds.tolist())
        slowest = max(rounds.tolist()) / (SIDE - 1)
        log(f"  ladder k={k:2d}, rows 1-{SIDE - 1}: {ms:10.3f} ms, rounds "
            f"per image {rounds.tolist()} ({slowest:.3f} a row in the "
            f"slowest), attempts {got[2].tolist()}; equal to the host loop"
            + (", and to the plain ladder in rounds too" if k == chosen
               else "") + f"; rows 1-{SEQUENTIAL_ROWS - 1}: rounds "
            f"{rounds_cut.tolist()}, attempts {want_cut[2].tolist()}, equal "
            "to the sequential plain version")
    tries = tries_host
    retry.update(b=len(bad), attempts=int(host_later.sum()),
                 host_loop_ms=host_s * 1e3, k=chosen,
                 rounds=ladder[chosen]["rounds"],
                 ms_by_k={k: v["ms"] for k, v in ladder.items()},
                 sequential=dict(h=SEQUENTIAL_ROWS, shape=seq["shape"],
                                 ms=seq["ms"], plain_ms=seq["plain_ms"],
                                 attempts=want_cut[2].tolist()))
    tries = tries.tolist()
    log(f"  the failed images with the strength loop on the host "
        f"(strength_loop around row_attempt): {host_s * 1e3:.3f} ms, "
        f"{host_launches} row-kernel launches; equal to the ladder: rows, "
        f"filters, attempts per image {tries}")

    # the per-row path on every image, by the host loop: the entry point's
    # output and the speculation on the ok images must equal it, and every
    # row's filter must be libpng's MSAD choice
    qp, fp, tries_all = rows_by_step(s, 2, orig, ofreq, wr)
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
    msad_rows("[6] embedding", [q[..., :3].reshape(SIDE, SIDE * bpp)
                                for q in q1], f1, bpp)
    mp = b * SIDE * SIDE / 1e6
    log(f"  embedding on {card}: {b} x {SIDE}x{SIDE} RGB at -s {STRENGTH}, "
        f"the ladder over the whole batch (k="
        f"{image.ladder_size(b, bpp, device)}): run 1 {wall:.3f} s "
        f"({mp / wall:.3f} MP/s), run 2 {wall2:.3f} s ({mp / wall2:.3f} "
        f"MP/s); equal to the host loop on every image, attempts per image "
        f"{tries_all.tolist()}")
    log(f"  the speculation alone {spec_ms:.3f} ms (CUDA events: pre-pass, "
        f"row 0, adaptive image kernel); {max(tries)} row attempts in the "
        f"slowest failed image ({max(tries) / SIDE:.3f} per row)")
    log(f"  launches: {launches}")

    args = (s, 2, wr, ofreq, rows, c0.qprev, c0.e0, c0.e1, c0.hist)
    cut = (*args[:4], rows[:, :PLAIN_ROWS].contiguous(), *args[5:])
    timing = timed_entry(
        "image_adaptive", lambda: image.image_rows(*cut, adaptive=True),
        lambda n: image.image_rows_ref(*cut, adaptive=True, count=n),
        f"{b}x{PLAIN_ROWS}x{SIDE}x{bpp} (rows 1-{PLAIN_ROWS - 1}, "
        "embedding batch)", 2, log)
    # its plain version over all 511 rows would take ~150 s more than the
    # run's time allows (PERF.md section 7); the kernel is timed there
    timing.update(h=PLAIN_ROWS, ms_full=cuda_ms(
        lambda: image.image_rows(*args, adaptive=True), 2))
    log(f"  image_adaptive, rows 1-{SIDE - 1}: {timing['ms_full']:.3f} ms")
    return launches, timing, retry, (rgba, q1, f1)


def run_row0_ladder(device, parent, card: str, log) -> dict:
    """Phase 6c: row 0's ladder (the row kernel's retry variant) on phase
    6's batch in CLI mode. At each of ROW0_STRENGTHS: one launch at the
    cluster size it picks and one at each of LADDER_TIMES against the
    sequential plain version on the same card tensors (``row_retry_ref``:
    ``strength_loop`` around ``row_attempt_ref``), exact (rows,
    histograms, dither rows, filters, attempts), rounds per image equal
    to ceil(attempts / k), CUDA-event ms of each. Then ``compress_many``
    on the batch's PNGs at -s 90: the same bytes with row 0 at k = 1 and,
    with --parent, as the parent tree's ``compress_many``. Returns
    {strength: {"k", "attempts", "rounds", "ms", "ms_by_k", "plain_ms"}}.
    """
    import hashlib

    import torch

    from pngloss_tpu_torch.codec import encode
    from pngloss_tpu_torch.ops import row
    from pngloss_tpu_torch.pipeline import compress_many

    orig0, ofreq, wr, rgba = row0_inputs(device)
    b, bpp = N_IMAGES, 3
    chosen = row.ladder_size(b, bpp, device)
    zero = row.zero_carry(b, SIDE, bpp, device)
    out = {}
    for st in ROW0_STRENGTHS:
        s = _i32([st] * b, device)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = row.row_retry_ref(s, 2, orig0, zero, ofreq, wr)
        end.record()
        end.synchronize()
        rec = {"k": chosen, "attempts": want[2].tolist(),
               "plain_ms": start.elapsed_time(end), "ms_by_k": {},
               "rounds_by_k": {}}
        for k in (None, *LADDER_TIMES):
            rounds = torch.zeros(b, dtype=torch.int32, device=device)
            got = row.row0_retry(s, 2, orig0, ofreq, wr, k=k, rounds=rounds)
            size = chosen if k is None else k
            err = max(_max_err(got, want),
                      _max_err(rounds, (want[2] + size - 1) // size))
            if err:
                raise AssertionError(f"[6c] row 0's ladder at k={size}, -s "
                                     f"{st}: max abs err {err}")
            ms = cuda_ms(lambda: row.row0_retry(s, 2, orig0, ofreq, wr,
                                                k=k), 5)
            if k is None:
                rec.update(ms=ms, rounds=rounds.tolist())
            else:
                rec["ms_by_k"][k] = ms
                rec["rounds_by_k"][k] = rounds.tolist()
        out[st] = rec
        log(f"  -s {st} on {card}: row 0 attempts per image "
            f"{rec['attempts']}; ladder k={chosen} (picked) {rec['ms']:.4f} "
            f"ms, rounds {rec['rounds']}; " + ", ".join(
                f"k={k} {rec['ms_by_k'][k]:.4f} ms (rounds max "
                f"{max(rec['rounds_by_k'][k])})" for k in LADDER_TIMES)
            + f"; sequential plain version {rec['plain_ms']:.3f} ms; all "
            "equal to it")

    strength = ROW0_STRENGTHS[0]
    pngs = [encode(im, row_filters=None) for im in rgba]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got = [r.unwrap() for r in compress_many(pngs, strength, device=device)]
    wall = time.perf_counter() - t0
    launches = read_counts("[6c] compress_many", CLI_KERNELS)
    picked = row.ladder_size
    row.ladder_size = lambda *a: 1
    try:
        one = [r.unwrap() for r in compress_many(pngs, strength,
                                                 device=device)]
    finally:
        row.ladder_size = picked
    if got != one:
        raise AssertionError(f"[6c] compress_many at -s {strength}: row 0 "
                             "at k = 1 gives other bytes")
    same = "no parent given"
    if parent:
        with tempfile.TemporaryDirectory() as d:
            write_pngs(d, pngs)
            proc = subprocess.run(
                [sys.executable, "-c", PARENT_DISPATCH,
                 os.path.abspath(parent), d, str(strength)], cwd=parent,
                capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"[6c] the parent's compress_many failed:\n"
                                 f"{proc.stderr[-4000:]}")
        theirs = json.loads(proc.stdout.strip().splitlines()[-1])["sha256"]
        if theirs != [hashlib.sha256(p).hexdigest() for p in got]:
            raise AssertionError(f"[6c] compress_many at -s {strength} "
                                 "differs from the parent's bytes")
        same = "equal to the parent's"
    log(f"  compress_many, {b} x {SIDE}x{SIDE} RGB at -s {strength} (CLI "
        f"mode): {wall:.3f} s, {sum(map(len, got))} bytes; row 0 at k = 1 "
        f"gives the same bytes; {same}; launches {launches}")
    return out


def settle_speculation(device, card: str, log) -> dict:
    """Phase 6b: embedding mode's two ways through rows 1..H-1, after the
    pre-pass and row 0 they share, timed in turns (speculation, ladder,
    ladder, speculation) on 16 and 132 smooth 512x512 RGB images (no image
    fails the speculation; the 132 repeat the 16) and on phase 6's batch
    (2 of 16 fail):
      speculation: the adaptive variant over the batch, one wait for ok,
        then the per-row path (row 0, the ladder) for the images that
        failed;
      ladder: the ladder over the whole batch at the cluster size it picks.
    Host wall ms to the last output (synchronised); both give the same
    rows and filters. Returns {batch: {"speculation": [ms, ms], "ladder":
    [ms, ms], "k": ..., "failed": ...}}."""
    import torch

    from pngloss_tpu_torch.ops import hist, image
    from pngloss_tpu_torch.ops.optimize_gpu import optimize_rows, row0

    smooth = synthetic_rgb(np.random.default_rng(SEED + 7), N_IMAGES, SIDE,
                           SIDE)
    batches = {"16 smooth": smooth,
               "132 smooth": np.resize(smooth, (132, SIDE, SIDE, 4)),
               "phase 6": embedding_batch(np.random.default_rng(EMBED_SEED))}
    bpp = 3
    out = {}
    for label, rgba in batches.items():
        b = len(rgba)
        rows = torch.as_tensor(np.ascontiguousarray(rgba[..., :3]).reshape(
            b, SIDE, SIDE * bpp), device=device)
        s, wr = _i32([STRENGTH] * b, device), _i32([SIDE] * b, device)
        failed = []

        def start():
            ofreq = hist.original_frequencies(rows, bpp, wr)
            c0, f0 = row0(s, 2, rows[:, 0].reshape(b, SIDE, bpp).to(
                torch.int32), ofreq, wr)
            return ofreq, c0, f0

        def speculation():
            ofreq, c0, f0 = start()
            qr, fr, ok = image.image_rows(s, 2, wr, ofreq, rows, c0.qprev,
                                          c0.e0, c0.e1, c0.hist,
                                          adaptive=True)
            q = torch.cat([c0.qprev[:, None], qr], 1)
            f = torch.cat([f0[:, None], fr.long()], 1)
            bad = (ok == 0).nonzero().squeeze(1)
            failed[:] = bad.tolist()
            if bad.numel():
                q[bad], f[bad] = optimize_rows(
                    s[bad], 2, rows[bad].view(-1, SIDE, SIDE, bpp).to(
                        torch.int32), ofreq[bad], wr[bad])
            return q, f

        def ladder():
            ofreq, c0, f0 = start()
            qr, fr, _ = image.image_rows(s, 2, wr, ofreq, rows, c0.qprev,
                                         c0.e0, c0.e1, c0.hist,
                                         adaptive=True, retry=True)
            return (torch.cat([c0.qprev[:, None], qr], 1),
                    torch.cat([f0[:, None], fr.long()], 1))

        ladder()                                            # warm-up
        rec = {"speculation": [], "ladder": []}
        got = {}
        for way in ("speculation", "ladder", "ladder", "speculation"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got.setdefault(way, (speculation if way == "speculation"
                                 else ladder)())
            torch.cuda.synchronize()
            rec[way].append((time.perf_counter() - t0) * 1e3)
        err = _max_err(got["speculation"], got["ladder"])
        if err:
            raise AssertionError(f"[6b] {label}: the ladder != speculation "
                                 f"+ fallback: max abs err {err}")
        rec.update(k=image.ladder_size(b, bpp, device), failed=failed)
        spec, lad = np.mean(rec["speculation"]), np.mean(rec["ladder"])
        log(f"  {label} ({b} x {SIDE}x{SIDE} RGB, -s {STRENGTH}, images "
            f"failing the speculation {failed}) on {card}: speculation "
            f"{rec['speculation'][0]:.3f}, {rec['speculation'][1]:.3f} ms; "
            f"ladder (k={rec['k']}) {rec['ladder'][0]:.3f}, "
            f"{rec['ladder'][1]:.3f} ms; ladder / speculation "
            f"{lad / spec:.4f}; equal rows and filters")
        out[label] = rec
    return out


def run_main_path(device, card: str, log):
    """Phase 5: the main path at full size. Returns the kernel launch
    counts of its first run, its input PNGs and its output bytes."""
    import torch

    from pngloss_tpu_torch import tracing
    from pngloss_tpu_torch.codec import decode, encode
    from pngloss_tpu_torch.pipeline import compress_many

    rgba = synthetic_rgb(np.random.default_rng(SEED + 4), N_IMAGES, SIDE, SIDE)
    pngs = [encode(im, row_filters=None) for im in rgba]
    torch.cuda.synchronize()
    reset_counts()
    tracing.snapshot(reset=True)
    t0 = time.perf_counter()
    first = compress_many(pngs, STRENGTH, device=device)
    wall = time.perf_counter() - t0
    launches = read_counts("[5] compress_many", CLI_KERNELS)
    stages = tracing.snapshot(reset=True)
    # one bucket: the pre-pass, row 0 with its strength loop and the image
    # kernel once each; no single row attempt
    if {k: launches[k] for k in ("hist", "row_retry", "image", "row")} != {
            "hist": 1, "row_retry": 1, "image": 1, "row": 0}:
        raise AssertionError(f"the main path launched {launches}")
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

    hist.LAUNCHES = row.LAUNCHES = row.RETRY_LAUNCHES = image.LAUNCHES = 0
    image.ADAPTIVE_LAUNCHES = image.RETRY_LAUNCHES = 0


def read_counts(path: str, need) -> dict[str, int]:
    """The launch counters; raises unless every kernel in ``need`` rose."""
    from pngloss_tpu_torch.ops import hist, image, row

    counts = {"hist": hist.LAUNCHES, "row": row.LAUNCHES,
              "row_retry": row.RETRY_LAUNCHES, "image": image.LAUNCHES,
              "image_adaptive": image.ADAPTIVE_LAUNCHES,
              "image_retry": image.RETRY_LAUNCHES}
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

    from pngloss_tpu_torch.fcgi import (
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
    # false>(...)": the kernels of csrc/ by their function names;
    # row_ladder_kernel is the row kernel's retry variant
    pattern = re.compile(
        r"(?:^|[ :])(hist|row_ladder|row|image)_kernel(<[^>]*>)?\(")
    names = ("hist", "row", "row_retry", "image")
    us = dict.fromkeys(names, 0.0)
    seen = dict.fromkeys(names, 0)
    busy = 0.0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        busy += e["dur"]
        m = pattern.search(e.get("name", ""))
        if m:
            key = {"row_ladder": "row_retry"}.get(m.group(1), m.group(1))
            us[key] += e["dur"]
            seen[key] += 1
    if seen != {k: counts[k] for k in names}:
        names = sorted({e.get("name", "")[:80] for e in events
                        if e.get("cat") == "kernel"})
        raise AssertionError(f"trace holds {seen} kernel launches, the "
                             f"counters saw {counts}; kernels: {names}")
    log("  trace kernels (launches, summed device ms): " + ", ".join(
        f"{k} {seen[k]} x {us[k] / 1e3:.3f}" for k in CLI_KERNELS)
        + f"; all kernels {busy / 1e3:.3f} ms")
    return counts


def load_fuzz_tool():
    """tools/fuzz_torch.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "fuzz_torch", os.path.join(ROOT, "tools", "fuzz_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_fuzz(device, log) -> dict[str, int]:
    """Phase 12: FUZZ_BATCHES seeded batches of tools/fuzz_torch.py; any
    mismatch raises. Returns the launch counts of the run."""
    import torch

    fuzz = load_fuzz_tool()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    recs = []
    for seed in range(FUZZ_SEED, FUZZ_SEED + FUZZ_BATCHES):
        recs += fuzz.run_batch(seed, device, e2e_images=FUZZ_E2E,
                               max_px=FUZZ_MAX_PX, max_steps=FUZZ_MAX_STEPS)
    seconds = time.perf_counter() - t0
    counts = read_counts("[12] fuzz", [k[0] for k in KERNELS])
    summary = fuzz.summarize(recs)
    bad = [r for r in recs if not r["identical"]]
    if bad:
        raise AssertionError(f"fuzz: {len(bad)} mismatches, the first "
                             f"{json.dumps(bad[0])}")
    if (summary["kernel_batches"] < 40 or summary["end_to_end"] < 200
            or summary["modes"] != ["cli", "embed"]
            or summary["bpps"] != {"end_to_end": [1, 2, 3, 4],
                                   "kernels": [1, 2, 3, 4]}):
        raise AssertionError(f"fuzz: too little coverage {summary}")
    shapes = sorted({(r["bucket"][0], r["bucket"][1], r["bpp"])
                     for r in recs if r["check"] == "kernels"})
    log(f"  seeds {FUZZ_SEED}-{FUZZ_SEED + FUZZ_BATCHES - 1}, end-to-end "
        f"images up to {FUZZ_MAX_PX} px a side, kernel buckets (H, W, bpp) "
        f"{shapes}; launches {counts}")
    log(f"  fuzz: {summary['cases']} cases ({summary['end_to_end']} "
        f"end to end, {summary['kernel_cases']} images in "
        f"{summary['kernel_batches']} kernel batches), {seconds:.1f} s, "
        f"{summary['mismatches']} mismatches")
    return counts


def with_kind(rgba: np.ndarray, k: int) -> np.ndarray:
    """``rgba`` made, in place, the k-th of gray, gray+alpha, RGB and RGBA
    in turn (working bpp 1-4); the alpha pattern is fully and partly
    transparent pixels."""
    if k % 4 < 2:                                   # gray, gray+alpha
        rgba[..., 0] = rgba[..., 2] = rgba[..., 1]
    if k % 2:                                       # gray+alpha, RGBA
        rgba[::3, ::2, 3] = 0
        rgba[1::3, 1::2, 3] = 128
    return rgba


def dispatch_images(rng) -> list[np.ndarray]:
    """Phase 13's ragged corpus as RGBA images: DISPATCH_N with sides of
    DISPATCH_SIDES px, in turn gray, gray+alpha, RGB and RGBA (bpp 1-4),
    then four 512x512 RGB."""
    images = []
    for k in range(DISPATCH_N):
        h, w = (int(v) for v in rng.integers(DISPATCH_SIDES[0],
                                             DISPATCH_SIDES[1] + 1, 2))
        images.append(with_kind(synthetic_rgb(rng, 1, h, w)[0], k))
    return images + list(synthetic_rgb(rng, 4, SIDE, SIDE))


def dispatch_corpus(rng) -> list[bytes]:
    """Phase 13's ragged corpus (``dispatch_images``) as PNGs."""
    from pngloss_tpu_torch.codec import encode

    return [encode(im, row_filters=None) for im in dispatch_images(rng)]


PARENT_DISPATCH = r"""
import hashlib, json, os, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from pngloss_tpu_torch import tracing
from pngloss_tpu_torch.ops import hist, image, row
from pngloss_tpu_torch.pipeline import compress_many
d = sys.argv[2]
pngs = [open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))]
compress_many(pngs[:8], int(sys.argv[3]), device="cuda")     # warm-up
torch.cuda.synchronize()
hist.LAUNCHES = row.LAUNCHES = image.LAUNCHES = 0
tracing.snapshot(reset=True)
t0 = time.perf_counter()
out = compress_many(pngs, int(sys.argv[3]), device="cuda")
wall = time.perf_counter() - t0
print(json.dumps({"wall": wall, "stages": tracing.snapshot(reset=True),
                  "launches": {"hist": hist.LAUNCHES, "row": row.LAUNCHES,
                               "image": image.LAUNCHES},
                  "sha256": [hashlib.sha256(r.unwrap()).hexdigest()
                             for r in out]}))
"""


def _stage_sums(stages: dict) -> dict:
    """Stage seconds summed over threads, the buckets' dispatches as one
    (device_dispatch) beside the number of buckets."""
    out = {"buckets": sum(v["calls"] for k, v in stages.items()
                          if k.startswith("device_dispatch_"))}
    for name in ("host_decode", "device_dispatch", "device_fetch",
                 "host_encode"):
        out[name] = sum(v["seconds"] for k, v in stages.items()
                        if k == name or k.startswith(name + "_"))
    return out


def chain_model(keys, image_ms: float, pools) -> dict:
    """The device time the buckets ``keys`` (h_pad, wb_pad, bpp) would
    take if each ran as long as its image kernel's chain, (h_pad - 1) x
    wb_pad channel steps at the main batch's measured rate (``image_ms``
    for (SIDE - 1) x SIDE x 3 steps), dispatched longest chain first
    round-robin over a pool of P streams that all run side by side: for
    each P, the largest sum of one stream's chains, in ms."""
    from pngloss_tpu_torch.pipeline import dispatch_order

    per_step = image_ms / ((SIDE - 1) * SIDE * 3)
    chains = [(h - 1) * wb * per_step for h, wb, _ in dispatch_order(keys)]
    out = {}
    for pool in pools:
        sums = [0.0] * pool
        for k, c in enumerate(chains):
            sums[k % pool] += c
        out[pool] = max(sums)
    return out


def run_dispatch(device, parent, card: str, image_ms: float, log) -> dict:
    """Phase 13: the pipeline's dispatch over a ragged corpus
    (``dispatch_corpus``). ``compress_many`` with the stream pool in
    longest-chain order, with a pool of 1 in the order the buckets first
    appear (the parent's), and with --parent the parent tree's
    ``compress_many`` in a subprocess, in turns; all give the same bytes.
    Then pools of other sizes once each, and ``dispatch_buckets`` in CLI
    mode under ``torch.cuda.set_sync_debug_mode("error")``, behind a
    device-side spin on every stream of the pool that must still be
    running when it returns. Returns the launch counts of the pool's
    first timed run."""
    import hashlib

    import torch

    from pngloss_tpu_torch import pipeline, tracing
    from pngloss_tpu_torch.parallel import mesh

    pngs = dispatch_corpus(np.random.default_rng(DISPATCH_SEED))
    mp = 0.0
    for png in pngs:
        w, h = (int.from_bytes(png[16 + 4 * i:20 + 4 * i], "big")
                for i in (0, 1))
        mp += w * h / 1e6
    streams, order = mesh.STREAMS, pipeline.dispatch_order

    def this(pool: int, parents_order: bool) -> dict:
        mesh.STREAMS = pool
        pipeline.dispatch_order = list if parents_order else order
        try:
            torch.cuda.synchronize()
            reset_counts()
            tracing.snapshot(reset=True)
            t0 = time.perf_counter()
            out = pipeline.compress_many(pngs, STRENGTH, device=device)
            wall = time.perf_counter() - t0
            launches = read_counts("[13] compress_many", CLI_KERNELS)
            stages = _stage_sums(tracing.snapshot(reset=True))
        finally:
            mesh.STREAMS, pipeline.dispatch_order = streams, order
        return {"wall": wall, "stages": stages, "launches": launches,
                "sha256": [hashlib.sha256(r.unwrap()).hexdigest()
                           for r in out]}

    def parent_run(d: str) -> dict:
        proc = subprocess.run(
            [sys.executable, "-c", PARENT_DISPATCH, os.path.abspath(parent),
             d, str(STRENGTH)], cwd=parent, capture_output=True, text=True,
            timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"the parent's compress_many failed:\n"
                                 f"{proc.stderr[-4000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["stages"] = _stage_sums(rec["stages"])
        return rec

    def show(label: str, rec: dict) -> None:
        st = rec["stages"]
        log(f"  {label}: {rec['wall']:.3f} s ({mp / rec['wall']:.3f} MP/s); "
            f"{st['buckets']} buckets; stages (s, summed over threads) "
            f"host_decode {st['host_decode']:.6f} device_dispatch "
            f"{st['device_dispatch']:.6f} device_fetch "
            f"{st['device_fetch']:.6f} host_encode {st['host_encode']:.6f}; "
            f"launches {rec['launches']}")

    log(f"  corpus: {len(pngs)} PNGs, {mp:.6f} MP (sides "
        f"{DISPATCH_SIDES[0]}-{DISPATCH_SIDES[1]} px, bpp 1-4, seed "
        f"{DISPATCH_SEED}, then 4 x {SIDE}x{SIDE} RGB), -s {STRENGTH}, on "
        f"{card}; pool {streams} streams")
    this(streams, False)                                   # warm-up
    pool_label = f"pool of {streams}, longest chain first"
    one_label = "pool of 1, the parent's order"
    turns = [pool_label, one_label, "parent", "parent", one_label, pool_label]
    if not parent:
        turns = [t for t in turns if t != "parent"]
    runs: dict = {}
    with tempfile.TemporaryDirectory() as d:
        if parent:
            for k, png in enumerate(pngs):
                with open(os.path.join(d, f"{k:04d}.png"), "wb") as fh:
                    fh.write(png)
        for k, label in enumerate(turns):
            rec = (parent_run(d) if label == "parent"
                   else this(1, True) if label == one_label
                   else this(streams, False))
            show(f"turn {k + 1}, {label}", rec)
            runs.setdefault(label, []).append(rec)
    for pool in DISPATCH_POOLS:
        rec = this(pool, False)
        show(f"pool of {pool}, longest chain first", rec)
        runs.setdefault(f"pool of {pool}", []).append(rec)
    want = runs[pool_label][0]["sha256"]
    for label, recs in runs.items():
        for rec in recs:
            if rec["sha256"] != want:
                raise AssertionError(f"[13] {label}: bytes differ from the "
                                     "pool's")
    if runs[pool_label][0]["stages"]["buckets"] < 24:
        raise AssertionError(f"[13] only {runs[pool_label][0]['stages']} "
                             "buckets")

    # dispatch_buckets in CLI mode: no host sync, and it returns while a
    # spin queued ahead of its work on every stream is still running
    works, bpps = [], []
    for png in pngs:
        work, bpp = pipeline.reduce_colorspace(pipeline.codec.decode(png).rgba)
        works.append(work)
        bpps.append(bpp)
    keys = sorted({(pipeline.pad_dim(w.shape[0]),
                    pipeline.pad_dim(w.shape[1] // b) * b, b)
                   for w, b in zip(works, bpps)})
    model = chain_model(keys, image_ms, sorted({1, streams, *DISPATCH_POOLS}))
    log("  device time if each bucket took its chain (image kernel "
        f"{image_ms:.3f} ms per {SIDE - 1} x {SIDE} x 3 steps), P streams "
        "side by side: " + ", ".join(f"P={k} {v:.1f} ms"
                                     for k, v in model.items()))
    spins = []
    for slot in range(mesh.STREAMS):
        with mesh.bucket_stream(device, slot):
            torch.cuda._sleep(DISPATCH_SPIN_CYCLES)
            spins.append(torch.cuda.Event())
            spins[-1].record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        pending = pipeline.dispatch_buckets(works, bpps, STRENGTH,
                                            device=device)
        queued = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    running = sum(not e.query() for e in spins)
    if running != len(spins):
        raise AssertionError(f"[13] dispatch_buckets returned after "
                             f"{len(spins) - running} of the spins ended")
    for p in pending:
        pipeline.collect_bucket(p)
    log(f"  dispatch_buckets under set_sync_debug_mode('error'): "
        f"{len(pending)} buckets queued in {queued * 1e3:.3f} ms behind a "
        f"{DISPATCH_SPIN_CYCLES} cycle spin on each of the {len(spins)} "
        f"streams, all still running at its return")

    # the same in embedding mode (every row's strength loop in the
    # ladder): no host sync either, and the planes and filters of a run
    # without the spin
    want = [pipeline.collect_bucket(p) for p in pipeline.dispatch_buckets(
        works, bpps, STRENGTH, use_row_filters=False, device=device)]
    spins = []
    for slot in range(mesh.STREAMS):
        with mesh.bucket_stream(device, slot):
            torch.cuda._sleep(DISPATCH_SPIN_CYCLES)
            spins.append(torch.cuda.Event())
            spins[-1].record()
    reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        pending = pipeline.dispatch_buckets(works, bpps, STRENGTH,
                                            use_row_filters=False,
                                            device=device)
        queued = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    running = sum(not e.query() for e in spins)
    if running != len(spins):
        raise AssertionError(f"[13] embedding dispatch_buckets returned "
                             f"after {len(spins) - running} of the spins "
                             "ended")
    got = [pipeline.collect_bucket(p) for p in pending]
    counts = read_counts("[13] embedding dispatch_buckets",
                         ("hist", "row_retry", "image_retry"))
    for (qs, fs), (qw, fw) in zip(got, want):
        if not all(np.array_equal(a, x) for a, x in zip(qs + fs, qw + fw)):
            raise AssertionError("[13] embedding dispatch behind the spins "
                                 "differs from the run without")
    log(f"  embedding mode, dispatch_buckets under set_sync_debug_mode("
        f"'error'): {len(pending)} buckets queued in {queued * 1e3:.3f} ms "
        f"behind the same spins, all still running at its return; equal "
        f"planes and filters; launches {counts}")
    return runs[pool_label][0]["launches"]


def photo_rgb(rng, h: int, w: int) -> np.ndarray:
    """(h, w, 4) opaque RGBA like a camera photo: smooth gradients under a
    +-6 grain, fine texture (+-40) in the lower third, and hard edges (12
    flat rectangles and 8 flat discs below the top eighth)."""
    y, x = np.ogrid[0:h, 0:w]
    rgb = np.empty((h, w, 3), np.int16)
    rgb[..., 0] = 30 + x * 190 // w
    rgb[..., 1] = 40 + y * 170 // h
    rgb[..., 2] = 60 + (x + y) * 130 // (h + w)
    rgb += rng.integers(-6, 7, (h, w, 3), dtype=np.int16)
    lo = 2 * h // 3
    rgb[lo:] += rng.integers(-40, 41, (h - lo, w, 3), dtype=np.int16)
    for _ in range(12):
        top, left = int(rng.integers(h // 8, h)), int(rng.integers(0, w))
        rgb[top:top + int(rng.integers(h // 75 + 1, h // 4 + 2)),
            left:left + int(rng.integers(w // 100 + 1, w // 4 + 2))] = (
                rng.integers(0, 256, 3, dtype=np.int16))
    for _ in range(8):
        cy, cx = int(rng.integers(h // 8, h)), int(rng.integers(0, w))
        r = int(rng.integers(h // 150 + 1, h // 6 + 2))
        rgb[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.integers(
            0, 256, 3, dtype=np.int16)
    out = np.full((h, w, 4), 255, np.uint8)
    out[..., :3] = np.clip(rgb, 0, 255)
    return out


def screenshot_rgb(rng, h: int, w: int) -> np.ndarray:
    """(h, w, 4) opaque RGBA like a desktop screenshot: flat fills (a page,
    a dark sidebar, 6 panels), lines of text-like glyphs every 22 px drawn
    with 1-2 px strokes, and one gradient (the title bar)."""
    out = np.full((h, w, 4), 255, np.uint8)
    out[..., :3] = (246, 246, 244)
    side = w // 6
    out[:, :side, :3] = (40, 44, 52)
    for _ in range(6):
        top = int(rng.integers(h // 18, h - h // 10 + 1))
        left = int(rng.integers(side, w - w // 10 + 1))
        out[top:top + int(rng.integers(h // 18 + 1, h // 4 + 2)),
            left:left + int(rng.integers(w // 13 + 1, w // 3 + 2)),
            :3] = rng.integers(200, 256, 3)
    bar = h // 27 + 1
    for c, (lo, hi) in enumerate(((20, 90), (60, 140), (150, 230))):
        out[:bar, :, c] = np.linspace(lo, hi, w).astype(np.uint8)
    for line in range(bar + 20, h - 20, 22):
        x = 10 + int(rng.integers(0, 30))
        while x < w - 20:
            ink = (230, 230, 230) if x < side else (30, 30, 30)
            for _ in range(int(rng.integers(2, 9))):           # a word
                for _ in range(int(rng.integers(2, 4))):       # strokes
                    th = int(rng.integers(1, 3))
                    if rng.random() < 0.5:
                        y0 = line + int(rng.integers(0, 12))
                        out[y0:y0 + th, x:x + int(rng.integers(3, 9)),
                            :3] = ink
                    else:
                        x0 = x + int(rng.integers(0, 7))
                        out[line:line + int(rng.integers(6, 14)),
                            x0:x0 + th, :3] = ink
                x += 9
            x += int(rng.integers(6, 30))
    return out


def gray_rgb(rng, n: int) -> np.ndarray:
    """(n, SIDE, SIDE, 4) opaque gray RGBA (bpp 1): synthetic_rgb's green
    channel in all three."""
    rgba = synthetic_rgb(rng, n, SIDE, SIDE)
    rgba[..., 0] = rgba[..., 2] = rgba[..., 1]
    return rgba


def encode_all(rgbas) -> list[bytes]:
    """Input PNGs of ``rgbas``, encoded on a pool of os.cpu_count() threads
    (the host encoder releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from pngloss_tpu_torch.codec import encode

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        return list(pool.map(lambda im: encode(im, row_filters=None),
                             rgbas))


def png_filters(png: bytes) -> np.ndarray:
    """The row filter bytes of a non-interlaced PNG (IDAT, inflated)."""
    import zlib

    pos, idat, h = 8, [], 0
    while pos < len(png):
        n = int.from_bytes(png[pos:pos + 4], "big")
        kind = png[pos + 4:pos + 8]
        if kind == b"IHDR":
            h = int.from_bytes(png[pos + 12:pos + 16], "big")
        elif kind == b"IDAT":
            idat.append(png[pos + 8:pos + 8 + n])
        pos += n + 12
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return raw[::len(raw) // h].copy()


def png_planes(pngs, bpp: int):
    """Decoded (working-format plane (H, W*bpp), row filters (H,)) of each
    output PNG, on a thread pool."""
    from concurrent.futures import ThreadPoolExecutor

    from pngloss_tpu_torch.codec import decode
    from pngloss_tpu_torch.pipeline import pack_work

    def one(png):
        return pack_work(decode(png).rgba, bpp), png_filters(png)

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        return list(pool.map(one, pngs))


@contextlib.contextmanager
def kernel_spans(spans: dict):
    """While open, every call of the three kernel wrappers that
    ``ops.optimize_gpu`` makes (``hist.original_frequencies``,
    ``row.row_retry``, ``image.image_rows``) records CUDA events before and
    after itself on the current stream (in ``compress_many``, its bucket's
    pool stream), and its output, into ``spans[name]`` ("hist",
    "row_retry", "image" or "image_retry"). Single-threaded use only: it
    swaps the modules' functions."""
    import torch

    from pngloss_tpu_torch.ops import hist, image, row

    saved = ((hist, "original_frequencies", "hist"),
             (row, "row_retry", "row_retry"), (image, "image_rows", "image"))

    def timed(fn, name):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            key = "image_retry" if kw.get("retry") else name
            spans.setdefault(key, []).append((start, end, out))
            return out
        return call

    originals = [getattr(mod, attr) for mod, attr, _ in saved]
    for (mod, attr, name), fn in zip(saved, originals):
        setattr(mod, attr, timed(fn, name))
    try:
        yield spans
    finally:
        for (mod, attr, _), fn in zip(saved, originals):
            setattr(mod, attr, fn)


def spans_read(spans: dict) -> dict:
    """What ``kernel_spans`` saw, once the work has ended: {"ms": CUDA-event
    ms of each wrapper summed over its calls, "row_attempts": row 0's
    attempts, "attempts": the image ladder's (embedding mode)}."""
    out = {"ms": {k: sum(s.elapsed_time(e) for s, e, _ in v)
                  for k, v in spans.items()}}
    for key, name in (("row_retry", "row_attempts"),
                      ("image_retry", "attempts")):
        if key in spans:
            out[name] = int(sum(int(o[2].sum()) for _, _, o in spans[key]))
    return out


def entry_run(path: str, need, call):
    """Run 1 of a phase-14 shape: ``call()`` (an entry point) with the
    launch counters set to 0 before and read after, and every kernel
    wrapper timed by CUDA events (``kernel_spans``). Returns (its output,
    {"wall", "launches", "stages" (tracing.stage seconds), "ms",
    "row_attempts", "attempts"})."""
    import torch

    from pngloss_tpu_torch import tracing

    spans: dict = {}
    torch.cuda.synchronize()
    reset_counts()
    tracing.snapshot(reset=True)
    t0 = time.perf_counter()
    with kernel_spans(spans):
        out = call()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    rec = {"wall": wall, "launches": read_counts(path, need),
           "stages": _stage_sums(tracing.snapshot(reset=True)),
           **spans_read(spans)}
    return out, rec


def repeat_run(device, planes: np.ndarray, bpp: int, w_real, h_real,
               use_row_filters: bool):
    """Run 2 of a phase-14 shape: ``ops.optimize_batch_auto`` alone on the
    padded planes, on a CUDA stream of its own, so that it can run beside
    the plain checks in a thread of its own: its host buffers are pinned
    before anything is queued, its copies back do not block, and it waits
    for them by polling an event, so that no call of it holds the card
    (a copy into pageable memory or a pinned allocation would wait for
    the whole card). Returns host (q, f)."""
    import torch

    from pngloss_tpu_torch.ops import optimize_batch_auto
    from pngloss_tpu_torch.pipeline import POLL_S

    src = torch.from_numpy(planes).pin_memory()
    qh = torch.empty(planes.shape, dtype=torch.uint8, pin_memory=True)
    fh = torch.empty(planes.shape[:2], dtype=torch.int8, pin_memory=True)
    stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        q, f = optimize_batch_auto(src, STRENGTH, bpp=bpp, device=device,
                                   use_row_filters=use_row_filters,
                                   w_real=w_real, h_real=h_real)
        qh.copy_(q, non_blocking=True)
        fh.copy_(f, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    while not done.query():
        time.sleep(POLL_S)
    return qh.numpy(), fh.numpy()


def bucket_planes(works, bpp: int):
    """Working-format planes zero-padded into one bucket as
    ``pipeline.dispatch_buckets`` pads them: (planes (B, H_pad, W_pad*bpp)
    uint8, w_real, h_real)."""
    from pngloss_tpu_torch.pipeline import pad_dim

    hp = max(pad_dim(wk.shape[0]) for wk in works)
    wp = max(pad_dim(wk.shape[1] // bpp) for wk in works)
    planes = np.zeros((len(works), hp, wp * bpp), np.uint8)
    for k, wk in enumerate(works):
        planes[k, :wk.shape[0], :wk.shape[1]] = wk
    return (planes, np.asarray([wk.shape[1] // bpp for wk in works], np.int32),
            np.asarray([wk.shape[0] for wk in works], np.int32))


def same_planes(label: str, run2, want) -> None:
    """Run 2's (q, f) equal ``want`` [(plane, filters)] image by image
    (each sliced to its real size), or raise."""
    for k, (plane, filt) in enumerate(want):
        h, wb = plane.shape
        if not (np.array_equal(run2[0][k, :h, :wb], plane)
                and np.array_equal(run2[1][k, :h], filt)):
            raise AssertionError(f"[14] {label}: run 2 differs from run 1 on "
                                 f"image {k}")


def msad_rows(label: str, planes, filters, bpp: int) -> None:
    """Every row's filter is libpng's MSAD choice for that row (planes
    (H, W*bpp) and filters (H,) of each image), or raise: the scalar
    model's ``adaptive_filter_for_row`` (the first of the smallest of the
    five sums of |filtered byte| as a signed byte) on all rows of a block
    at once."""
    for k, (work, f) in enumerate(zip(planes, filters)):
        for lo in range(0, work.shape[0], 256):
            px = work[lo:lo + 256].astype(np.int64)
            above = np.zeros_like(px)
            above[1:] = px[:-1]
            if lo:
                above[0] = work[lo - 1]
            left, diag = np.zeros_like(px), np.zeros_like(px)
            left[:, bpp:] = px[:, :-bpp]
            diag[:, bpp:] = above[:, :-bpp]
            p, pd = above - diag, left - diag
            paeth = np.where((abs(p) <= abs(pd)) & (abs(p) <= abs(p + pd)),
                             left, np.where(abs(pd) <= abs(p + pd), above,
                                            diag))
            sums = [np.where(v < 128, v, 256 - v).sum(1) for v in (
                (px - pred) & 0xFF for pred in (
                    0, left, above, (left + above) // 2, paeth))]
            want = np.argmin(np.stack(sums), 0)
            bad = np.flatnonzero(want != f[lo:lo + 256])
            if len(bad):
                y = lo + int(bad[0])
                raise AssertionError(f"{label}: image {k} row {y}: filter "
                                     f"{f[y]} is not libpng's MSAD choice "
                                     f"{want[bad[0]]}")


def cut_checks(device, planes, bpp: int, w: int, h: int, n: int, log,
               beside) -> tuple[dict, object]:
    """The kernels of one large image against their plain versions on the
    same card tensors, max abs err 0: the pre-pass over the whole padded
    plane, row 0's ladder at full width (the same in both modes, so run
    once), and the image kernel's CLI variant and its ladder (at the k it
    picks) over rows 1..n-1 at full width, from the whole image's pre-pass
    and row 0, the kernels stopping at h_real = n on the whole plane (the
    rows after it 0). All on a stream of its own, which it alone waits
    for, in inference mode (the plain versions launch kernel by kernel
    from the host, and autograd's dispatch is ~15% of each launch's host
    time). ``beside()`` (run 2) runs in a thread of its own beside row 0's
    check, after row 0's ladder has run once, so that its scratch comes
    from the caching allocator: a new device allocation there would wait
    for the whole card. Returns ({kernel: entry} with the band candidates
    the plain versions counted, for ``bounds``; what ``beside``
    returned)."""
    import torch

    with torch.inference_mode(), torch.cuda.stream(torch.cuda.Stream(
            device)):
        return _cut_checks(device, planes, bpp, w, h, n, log, beside)


def _cut_checks(device, planes, bpp, w, h, n, log, beside):
    """``cut_checks`` on the current stream."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from pngloss_tpu_torch.ops import hist, image, row
    from pngloss_tpu_torch.ops.optimize_gpu import row0

    rows = torch.as_tensor(planes, device=device)
    hp, wb = rows.shape[1:]
    wp = wb // bpp
    s, wr, hr = (_i32([v], device) for v in (STRENGTH, w, h))
    ofreq = hist.original_frequencies(rows, bpp, wr, hr)
    orig0 = rows[:, 0].reshape(1, wp, bpp).to(torch.int32)
    zero = row.zero_carry(1, wp, bpp, device)
    c0, _ = row0(s, 2, orig0, ofreq, wr)
    args = (s, 2, wr, ofreq, rows, c0.qprev, c0.e0, c0.e1, c0.hist)
    cut = (*args[:4], rows[:, :n].contiguous(), *args[5:])
    hn = _i32([n], device)
    k0 = row.ladder_size(1, bpp, device)
    k1 = image.ladder_size(1, bpp, device)

    def check_hist():
        return timed_entry(
            "hist", lambda: hist.original_frequencies(rows, bpp, wr, hr),
            lambda _: hist.original_frequencies_ref(rows, bpp, wr, hr),
            f"1x{hp}x{wp}x{bpp} (real {h}x{w})", 5, log)

    # row 0's ladder once before run 2 starts (see cut_checks)
    rounds = torch.zeros(1, dtype=torch.int32, device=device)
    row.row0_retry(s, 2, orig0, ofreq, wr, rounds=rounds)

    def check_row0():
        out = timed_entry(
            "row_retry", lambda: row.row0_retry(s, 2, orig0, ofreq, wr),
            lambda cnt: row.row_retry_ref(s, 2, orig0, zero, ofreq, wr,
                                          count=cnt),
            f"1x1x{wp}x{bpp} (row 0, real {w * bpp} bytes; ladder k={k0})",
            3, log, keep=True)
        want = out.pop("want")
        if _max_err(rounds, (want[2] + k0 - 1) // k0):
            raise AssertionError(f"[14] row 0's ladder: rounds "
                                 f"{rounds.tolist()} for attempts "
                                 f"{want[2].tolist()} at k={k0}")
        return {**out, "attempts": int(want[2].sum()), "k": k0,
                "rounds": rounds.tolist()}

    def padded(want):
        # the plain version's rows 1..n-1, then 0 up to the plane's last
        # row, as the kernel writes the rows after h_real
        return tuple(torch.cat([t, t.new_zeros((1, hp - n, *t.shape[2:]))],
                               1) if t.dim() > 1 else t for t in want)

    def check_image():
        out = timed_entry(
            "image", lambda: image.image_rows(*args, h_real=hn),
            lambda cnt: padded(image.image_rows_ref(*cut, count=cnt)),
            f"1x{n}x{wp}x{bpp} (rows 1-{n - 1} of the whole {hp}-row "
            f"plane, h_real={n})", 2, log)
        return {**out, "h": n}

    def check_ladder():
        plain, rounds = (torch.zeros(1, dtype=torch.int32, device=device)
                         for _ in range(2))
        out = timed_entry(
            "image_retry", lambda: image.image_rows(
                *args, adaptive=True, retry=True, h_real=hn),
            lambda cnt: padded(image.image_rows_ladder_ref(
                *cut, k=k1, rounds=plain, count=cnt)),
            f"1x{n}x{wp}x{bpp} (rows 1-{n - 1} of the whole {hp}-row "
            f"plane, h_real={n}; ladder k={k1})", 2, log)
        image.image_rows(*args, h_real=hn, adaptive=True, retry=True,
                         rounds=rounds)
        if _max_err(rounds, plain):
            raise AssertionError(f"[14] the image ladder: rounds "
                                 f"{rounds.tolist()}, plain "
                                 f"{plain.tolist()}")
        return {**out, "k": k1, "rounds": rounds.tolist(), "h": n}

    out = {"hist": check_hist()}
    with ThreadPoolExecutor(1) as pool:
        run2 = pool.submit(beside)
        out["row_retry"] = check_row0()
        done = run2.result()
    out.update(image=check_image(), image_retry=check_ladder())
    return out, done


def large_image(device, name: str, rgba: np.ndarray, n: int, card: str,
                log) -> dict:
    """One large image (phase 14): CLI mode through ``compress_many`` and
    embedding mode through ``optimize_rgba_batch`` (run 1: launches
    counted, every kernel wrapper timed by CUDA events), each again through
    ``optimize_batch_auto`` (run 2, equal to run 1) beside every kernel on
    the path against its plain version (``cut_checks``, rows 1..n-1 for
    the image stages). Returns its numbers."""
    from pngloss_tpu_torch import pipeline
    from pngloss_tpu_torch.codec import decode

    h, w = rgba.shape[:2]
    work, bpp = pipeline.reduce_colorspace(rgba)
    planes, wr, hr = bucket_planes([work], bpp)
    mp = h * w / 1e6
    t0 = time.perf_counter()
    (png,) = encode_all([rgba])
    log(f"  {name}: {w}x{h} RGB ({mp:.3f} MP) in a {planes.shape[2] // bpp}x"
        f"{planes.shape[1]} bucket, input PNG {len(png)} bytes (encoded in "
        f"{time.perf_counter() - t0:.1f} s), -s {STRENGTH}, on {card}")
    rec = {"h": h, "w": w, "bpp": bpp,
           "bucket": [planes.shape[1], planes.shape[2] // bpp]}

    (res,), cli = entry_run(
        f"[14] {name} compress_many", CLI_KERNELS,
        lambda: pipeline.compress_many([png], STRENGTH, device=device))
    launches = cli["launches"]
    if (launches["hist"], launches["row_retry"], launches["image"],
            launches["row"], launches["image_adaptive"],
            launches["image_retry"]) != (1, 1, 1, 0, 0, 0):
        raise AssertionError(f"[14] {name} compress_many launched {launches}")
    out_png = res.unwrap()
    if decode(out_png).rgba.shape != rgba.shape:
        raise AssertionError(f"[14] {name}: the output decodes to another "
                             "size")
    cli.update(mp_s=mp / cli["wall"], bytes=[len(png), len(out_png)])
    log(f"  {name} CLI mode: compress_many {cli['wall']:.3f} s "
        f"({cli['mp_s']:.3f} MP/s), {len(png)} -> {len(out_png)} bytes; "
        f"stages (s, summed over threads) {json.dumps(cli['stages'])}; "
        f"launches {launches}; CUDA-event ms " + json.dumps(cli["ms"]))

    ((q1,), (f1,)), embed = entry_run(
        f"[14] {name} optimize_rgba_batch", EMBED_KERNELS,
        lambda: pipeline.optimize_rgba_batch(
            [rgba], STRENGTH, use_row_filters=False, device=device))
    launches = embed["launches"]
    if (launches["hist"], launches["row_retry"], launches["image_retry"],
            launches["row"], launches["image"],
            launches["image_adaptive"]) != (1, 1, 1, 0, 0, 0):
        raise AssertionError(f"[14] {name} embedding launched {launches}")
    q1 = pipeline.pack_work(q1, bpp)
    msad_rows(f"[14] {name} embedding", [q1], [f1], bpp)
    embed["mp_s"] = mp / embed["wall"]
    log(f"  {name} embedding mode: optimize_rgba_batch {embed['wall']:.3f} s "
        f"({embed['mp_s']:.3f} MP/s), every row's filter libpng's MSAD "
        f"choice; {embed['attempts']} row attempts (rows 1-{h - 1}); "
        f"launches {launches}; CUDA-event ms " + json.dumps(embed["ms"]))

    # run 2 of both modes beside the plain checks (the kernels' times come
    # from run 1)
    t0 = time.perf_counter()
    checks, (run2_cli, run2_embed) = cut_checks(
        device, planes, bpp, w, h, n, log, lambda: [
            repeat_run(device, planes, bpp, wr, hr, mode)
            for mode in (True, False)])
    same_planes(f"{name} CLI mode", run2_cli, png_planes([out_png], bpp))
    same_planes(f"{name} embedding mode", run2_embed, [(q1, f1)])
    log(f"  {name}: run 2 of both modes (optimize_batch_auto) equal to run "
        f"1 in planes and filters; every kernel equal to its plain version "
        f"(max abs err 0; the image stages over rows 1-{n - 1}); "
        f"{time.perf_counter() - t0:.1f} s for both")
    # bounds at the whole image's real size; the band candidates the
    # plain versions counted (the image stages' over rows 1..n-1 only, so
    # theirs are lower bounds)
    # (the CLI run's times and launches; the ladder's the embedding run's)
    full = {"hist": (cli, 0, 0),
            "row_retry": (cli, checks["row_retry"]["candidates"],
                          checks["row_retry"]["attempts"]),
            "image": (cli, checks["image"]["candidates"], 0),
            "image_retry": (embed, checks["image_retry"]["candidates"],
                            embed["attempts"])}
    rec.update(cli=cli, embed=embed, kernels={})
    for kname, (run, cands, attempts) in full.items():
        ms, launched = run["ms"][kname], run["launches"][kname]
        bound_ms, bound_by = bounds(kname, 1, 1 if kname == "row_retry"
                                    else h, w, bpp, cands, attempts)
        c = checks[kname]
        rec["kernels"][kname] = dict(
            ms=ms, launches=launched, bound_ms=bound_ms, bound_by=bound_by,
            share=bound_ms / ms, max_abs_err=c["max_abs_err"],
            checked=c["shape"], checked_ms=c["ms"], plain_ms=c["plain_ms"],
            **{k: c[k] for k in ("k", "rounds", "attempts", "h") if k in c})
        log(f"  {name} {kname:11s} launches {launched} {ms:12.3f} ms (run 1, "
            f"CUDA events)  "
            f"bound {bound_ms:.6f} ms ({bound_by}), share {bound_ms / ms:.2e}"
            f"; checked at {c['shape']}: kernel {c['ms']:.3f} ms, plain "
            f"{c['plain_ms']:.3f} ms")
    return rec


def full_card(device, pngs16, want16, card: str, log) -> dict:
    """Phase 14's full card: CARD_IMAGES[0] 512x512 RGB images, phase 5's 16
    and more (one block per SM), then CARD_IMAGES[1] (those and as many
    more: two waves), in one ``compress_many`` each (run 1, the kernels
    timed), and again through ``optimize_batch_auto`` (run 2, equal to run
    1). The first 16 give phase 5's bytes, the first CARD_IMAGES[0] of the
    larger call those of the smaller."""
    from pngloss_tpu_torch import pipeline

    rec = {}
    pngs = list(pngs16)
    rgbs = [synthetic_rgb(np.random.default_rng(SEED + 4), N_IMAGES, SIDE,
                          SIDE)[..., :3]]                # phase 5's images
    before = None
    for n, seed in zip(CARD_IMAGES, (SEED + 15, SEED + 16)):
        t0 = time.perf_counter()
        more = synthetic_rgb(np.random.default_rng(seed), n - len(pngs),
                             SIDE, SIDE, np.int16)
        pngs += encode_all(more)
        rgbs.append(more[..., :3])
        made = time.perf_counter() - t0
        res, run1 = entry_run(
            f"[14] {n} images compress_many", CLI_KERNELS,
            lambda: pipeline.compress_many(pngs, STRENGTH, device=device))
        got = [r.unwrap() for r in res]
        launches = run1["launches"]
        if (launches["hist"], launches["row_retry"], launches["image"],
                launches["row"]) != (1, 1, 1, 0):
            raise AssertionError(f"[14] {n} images launched {launches}")
        if got[:16] != want16:
            raise AssertionError(f"[14] {n} images: the first 16 differ from "
                                 "phase 5's bytes")
        if before is not None and got[:len(before)] != before:
            raise AssertionError(f"[14] {n} images: the first {len(before)} "
                                 "differ from the smaller call's bytes")
        decoded = png_planes(got, 3)
        if any(p.shape != (SIDE, SIDE * 3) for p, _ in decoded):
            raise AssertionError(f"[14] {n} images: an output decodes to "
                                 "another size")
        planes = np.concatenate(rgbs).reshape(n, SIDE, SIDE * 3)
        wr = hr = np.full(n, SIDE, np.int32)
        same_planes(f"{n} images", repeat_run(device, planes, 3, wr, hr,
                                              True), decoded)
        mp = n * SIDE * SIDE / 1e6
        stages, ms = run1["stages"], run1["ms"]
        bound = {k: bounds(k, n, 1 if k == "row_retry" else SIDE, SIDE, 3,
                           attempts=run1["row_attempts"]) for k in ms}
        run1.update(mp_s=mp / run1["wall"], inputs_s=made,
                    bound={k: dict(ms=b, by=by, share=b / ms[k])
                           for k, (b, by) in bound.items()})
        rec[n] = run1
        workers = pipeline.host_workers()
        log(f"  {n} x {SIDE}x{SIDE} RGB on {card}: compress_many "
            f"{run1['wall']:.3f} s ({run1['mp_s']:.3f} MP/s); stages (s, "
            f"summed over threads) {json.dumps(stages)}; launches "
            f"{launches}; CUDA-event ms {json.dumps(ms)}; run 2 "
            f"(optimize_batch_auto) equal in planes and filters; kernels "
            f"{sum(ms.values()) / 1e3:.3f} s against host encode "
            f"{stages['host_encode']:.3f} thread-s over {workers} threads "
            f"({stages['host_encode'] / workers:.3f} s); bound (operations "
            "without band candidates, not counted here) " + ", ".join(
                f"{k} {b:.6f} ms ({by}, share {b / ms[k]:.2e})"
                for k, (b, by) in bound.items()))
        before = got
    return rec


def gray_embedding(device, card: str, log) -> dict:
    """Phase 14's gray batch: GRAY_IMAGES 512x512 gray images (bpp 1) in
    embedding mode (run 1, launches counted, the kernels timed; run 2
    through ``optimize_batch_auto``, equal), every row's filter libpng's
    MSAD choice, the ladder at the k it picks against the plain ladder
    over rows 1..GRAY_ROWS-1."""
    import torch

    from pngloss_tpu_torch import pipeline
    from pngloss_tpu_torch.ops import image, ladder, row

    rgba = gray_rgb(np.random.default_rng(SEED + 17), GRAY_IMAGES)
    (qs, fs), run1 = entry_run(
        "[14] gray optimize_rgba_batch", EMBED_KERNELS,
        lambda: pipeline.optimize_rgba_batch(
            list(rgba), STRENGTH, use_row_filters=False, device=device))
    qs = [pipeline.pack_work(q, 1) for q in qs]
    msad_rows("[14] gray embedding", qs, fs, 1)
    works = [pipeline.reduce_colorspace(im)[0] for im in rgba]
    planes, wr, hr = bucket_planes(works, 1)
    same_planes("gray embedding", repeat_run(device, planes, 1, wr, hr,
                                             False), list(zip(qs, fs)))
    args, _ = gray_inputs(device, planes)
    k = image.ladder_size(GRAY_IMAGES, 1, device)
    n = GRAY_ROWS
    cut = (*args[:4], args[4][:, :n].contiguous(), *args[5:])
    rounds, plain = (torch.zeros(GRAY_IMAGES, dtype=torch.int32,
                                 device=device) for _ in range(2))
    got = image.image_rows(*args, adaptive=True, retry=True, rounds=rounds,
                           h_real=_i32([n] * GRAY_IMAGES, device))
    want = image.image_rows_ladder_ref(*cut, k=k, rounds=plain)
    err = max(_max_err((got[0][:, :n - 1], got[1][:, :n - 1], got[2]), want),
              _max_err(rounds, plain))
    if err:
        raise AssertionError(f"[14] gray: the ladder at k={k} != its plain "
                             f"version over rows 1-{n - 1}: max abs err {err}")
    resident = {name: ladder.resident_clusters(mod.clusters, 1, device)
                for name, mod in (("image", image), ("row", row))}
    run1.update(mp_s=GRAY_IMAGES * SIDE * SIDE / 1e6 / run1["wall"],
                resident=resident, k={
                    "image": k, "row": row.ladder_size(GRAY_IMAGES, 1,
                                                       device)})
    log(f"  {GRAY_IMAGES} x {SIDE}x{SIDE} gray, embedding mode on {card}: "
        f"optimize_rgba_batch {run1['wall']:.3f} s ({run1['mp_s']:.3f} "
        f"MP/s); launches {run1['launches']}; CUDA-event ms "
        f"{json.dumps(run1['ms'])}; {run1['attempts']} row attempts; run 2 "
        f"equal; every row's filter libpng's MSAD choice; ladders at bpp 1: "
        f"clusters resident {resident}, k picked {run1['k']}; the image "
        f"ladder over rows 1-{n - 1} equal to its plain ladder (rounds too)")
    return run1


def gray_inputs(device, planes=None):
    """Phase 14's gray batch as the image stage's inputs (from its own
    pre-pass and row 0): (image_rows args, the RGBA images)."""
    import torch

    from pngloss_tpu_torch.ops import hist
    from pngloss_tpu_torch.ops.optimize_gpu import row0

    rgba = gray_rgb(np.random.default_rng(SEED + 17), GRAY_IMAGES)
    if planes is None:
        planes = np.ascontiguousarray(rgba[..., 1])
    rows = torch.as_tensor(planes, device=device)
    b = GRAY_IMAGES
    s, wr = _i32([STRENGTH] * b, device), _i32([SIDE] * b, device)
    ofreq = hist.original_frequencies(rows, 1, wr, _i32([SIDE] * b, device))
    c0, _ = row0(s, 2, rows[:, 0].reshape(b, SIDE, 1).to(torch.int32),
                 ofreq, wr)
    return (s, 2, wr, ofreq, rows, c0.qprev, c0.e0, c0.e1, c0.hist), rgba


def run_users(device, pngs16, want16, card: str, log) -> dict:
    """Phase 14: the port at its users' sizes. Returns its numbers."""
    out = {}
    for name, make, (h, w) in (("photo", photo_rgb, PHOTO),
                               ("screenshot", screenshot_rgb, SCREEN)):
        t0 = time.perf_counter()
        out[name] = large_image(device, name, make(np.random.default_rng(
            USERS_SEED), h, w), USER_ROWS[name], card, log)
        log(f"  ({name}: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    out["full_card"] = full_card(device, pngs16, want16, card, log)
    log(f"  (full card: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    out["gray"] = gray_embedding(device, card, log)
    log(f"  (gray: {time.perf_counter() - t0:.1f} s)")
    return out


def run_bench_phase(card: str, log) -> dict:
    """Phase 15: ``bench_torch.py --case bench --runs 1`` in a subprocess,
    killed after BENCH_PHASE_S seconds. It must exit 0, its case line must
    count launches of CLI_KERNELS, and its last line must be bench.py's
    record naming this card. Returns that record."""
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_torch.py"), "--case",
         "bench", "--runs", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=BENCH_PHASE_S)
    if proc.returncode:
        raise AssertionError(f"[15] bench_torch.py exited {proc.returncode}:"
                             f"\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    record, case = json.loads(lines[-1]), json.loads(lines[-2])
    if (record.get("metric") != "1mp_images_per_sec_per_chip"
            or record.get("device") != card):
        raise AssertionError(f"[15] bench_torch.py's last line is not "
                             f"bench.py's record for {card}: {lines[-1]}")
    for key in ("device_launches", "launches"):
        missing = [k for k in CLI_KERNELS if not case[key].get(k)]
        if missing:
            raise AssertionError(f"[15] bench_torch.py's {key}: {missing} "
                                 f"not launched: {case[key]}")
    log(f"  bench_torch.py --case bench --runs 1 on {card}: "
        f"{record['value']:.3f} img(1MP)/s (device rate, "
        f"{case['device_ms']['median']:.3f} ms for {case['device_images']} "
        f"images), stream {record['stream_mp_s']:.3f} MP/s "
        f"({case['median_s']:.3f} s for {case['images']} images); launches "
        f"{case['device_launches']} and {case['launches']}")
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "GPU.")
    ap.add_argument("--parent", default=None, metavar="DIR",
                    help="a checkout of an earlier commit whose kernels "
                         "phase 3b times in turns with this tree's")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from pngloss_tpu_torch.ops import _build

    def log(msg):
        print(msg, flush=True)

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {nvcc_version()}")

    t0 = time.perf_counter()
    _build.library()
    log(f"[2] kernels built in {time.perf_counter() - t0:.1f} s "
        f"({_build.build_info['path']})")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("    " + line.strip())

    t0 = time.perf_counter()
    errs = check_kernels(device, log)
    log(f"[3] kernels == plain versions on small shapes: {errs} "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    timing = time_kernels(device, log)
    if args.parent:
        log(f"[3b] kernels of {args.parent} and of this tree, in turns")
        compare_parent(device, args.parent, log)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    small = check_end_to_end(device)
    log(f"[4] end-to-end bytes == scalar reference model "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    ok = check_embedding_small(device)
    log(f"[4b] embedding mode == scalar reference model; seed-700 "
        f"speculation ok {ok} ({time.perf_counter() - t0:.1f} s)")

    log("[5] main path")
    t0 = time.perf_counter()
    launches, pngs, want = run_main_path(device, card, log)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log("[6] embedding mode at full size")
    t0 = time.perf_counter()
    (embed_launches, timing["image_adaptive"], timing["image_retry"],
     embed) = run_embedding(device, card, log)
    for name in ("image_adaptive", "image_retry"):
        launches[name] = embed_launches[name]
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log("[6b] speculation against the ladder")
    t0 = time.perf_counter()
    settle_speculation(device, card, log)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log("[6c] row 0's ladder on phase 6's batch, CLI mode")
    t0 = time.perf_counter()
    timing["row_retry"]["p6"] = run_row0_ladder(device, args.parent, card,
                                                log)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    for label, phase in (
            ("[7] CLI", lambda: run_cli(device, pngs, want, small, log)),
            ("[8] suite", lambda: run_suite_phase(device, pngs, want, log)),
            ("[9] website", lambda: run_website(device, pngs, want, log)),
            ("[10] mesh", lambda: run_mesh(device, pngs, want, embed, log)),
            ("[11] tracing", lambda: run_tracing(device, pngs, want, log)),
            ("[12] fuzz", lambda: run_fuzz(device, log)),
            ("[13] dispatch", lambda: run_dispatch(
                device, args.parent, card, timing["image"]["ms"], log))):
        log(label)
        t0 = time.perf_counter()
        phase()
        log(f"  ({time.perf_counter() - t0:.1f} s)")

    log("[14] the port at its users' sizes")
    t0 = time.perf_counter()
    users = run_users(device, pngs, want, card, log)
    users["seconds"] = time.perf_counter() - t0
    log(f"  ({users['seconds']:.1f} s)")

    log("[15] bench_torch.py")
    t0 = time.perf_counter()
    bench = run_bench_phase(card, log)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    kernels = []
    log(f"[3b] kernels on the main path (SM clock now, max: {sm_clocks()})")
    for name, src, rep in KERNELS:
        t = timing[name]
        bound_ms, bound_by = bounds(name, t.get("b", N_IMAGES),
                                    t.get("h", SIDE), SIDE, 3,
                                    t["candidates"], t.get("attempts", 0))
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches[name],
            max_abs_err=max(errs[name], t["max_abs_err"]), ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, shape=t["shape"],
            **{k: t[k] for k in ("attempts", "host_loop_ms", "k", "rounds",
                                 "ms_by_k", "sequential", "ms_full", "p6")
               if k in t}))
        log(f"  {name:14s} launches {launches[name]:5d}  kernel "
            f"{t['ms']:10.3f} ms  bound {bound_ms:.6f} ms ({bound_by}), "
            f"{bound_ms / t['ms']:.2e} of the kernel's time; "
            f"{t['candidates']} band candidates; library: none")
    log(f"  row launches per embedding call (phase 6): one attempt "
        f"{embed_launches['row']}, retry variant "
        f"{embed_launches['row_retry']}")
    log(f"  library calls: {NO_LIBRARY}")
    log(f"[end] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s "
        f"({'with' if args.parent else 'without'} --parent)")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels, "users_sizes": users,
                      "bench": bench}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
