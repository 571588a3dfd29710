"""The benchmark of pngloss_tpu_torch, the PyTorch and CUDA port of pngloss.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the CUDA card it is started on:

1. set-up (``setup_s``, from this file's first line): the cell's
   configuration, mix and metric readers, found by name
   (``harness.cells``); the inputs drawn from ``--seed``
   (``harness.traffic``); the entry that drives the program
   (``benchmark/entries/<entry>.py``); the mix's warm-up calls, which load
   the kernels from the checkout's ``build/`` (building them there on a
   first run) and touch every shape the cell uses;
2. the window: calls in a closed loop, one caller, for ``--seconds``; the
   last call started in the window runs to its end. With ``--trace 1``
   a ``torch.profiler`` trace covers the window, with the benchmark's
   spans (``bench.window``, ``bench.call``), the program's stages and
   the codec as host spans;
3. after it: the card's memory peak, a check that no JAX module was
   loaded, then the outputs judged against the frozen scalar model in
   ``benchmark/reference`` on the host's cores (``reference.judge``);
   then every process the run started is stopped and waited for
   (``stop_processes``), before anything is printed;
4. the result: the checks as the last lines of standard error, and one
   JSON line last on standard output: ``correct``, ``attempted``,
   ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
   ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
   ``breakdown``, and ``checks`` last.

Without CUDA, or with fewer cards than the cell asks for, it exits 2 and
prints no result; where a JAX module or the JAX package is loaded, 3.
``--control 1`` judges the control in the program's place: for every
input of the mix, the reference worked out with floor division in the
dither (``reference.rowsearch``), which has to come out not correct.
The benchmark's own runs do not use it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names that must not be loaded in this process
FORBIDDEN = ("jax", "jaxlib", "flax", "pngloss_tpu")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def cuda_missing(chips: int) -> str | None:
    import torch

    if not torch.cuda.is_available():
        return "CUDA is not available (torch.cuda.is_available() is False)"
    n = torch.cuda.device_count()
    if n < chips:
        return f"the cell needs {chips} CUDA devices and {n} are visible"
    return None


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@contextlib.contextmanager
def instrumented():
    """Host spans for the trace: each program stage
    (``pngloss_tpu_torch.tracing.stage``) and codec call also opens a
    ``record_function`` of its name. Undone on exit."""
    import torch
    from pngloss_tpu_torch import codec, tracing

    saved = {(tracing, "stage"): tracing.stage,
             (codec, "decode"): codec.decode, (codec, "encode"): codec.encode}
    stage = saved[tracing, "stage"]

    @contextlib.contextmanager
    def traced_stage(name):
        with torch.profiler.record_function(name), stage(name):
            yield

    def span(fn, name):
        def wrapped(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return wrapped

    tracing.stage = traced_stage
    codec.decode = span(saved[codec, "decode"], "codec.decode")
    codec.encode = span(saved[codec, "encode"], "codec.encode")
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def window(entry, plan, seconds: float, first: int, record_function):
    """Calls in a closed loop until ``seconds`` have passed since the
    first one started. Returns one record a call, the first output of each
    input, and the number of later outputs that differ from it (compared
    between calls and then let go, so the window keeps no more than one
    output an input)."""
    import numpy as np

    from pngloss_tpu_torch import tracing

    tracing.snapshot(reset=True)
    outputs, differing = {}, 0
    records, k = [], first
    with record_function("bench.window"):
        end = time.perf_counter() + seconds
        while not records or time.perf_counter() < end:
            ids = plan.call(k)
            t0 = time.perf_counter()
            err, out = None, {}
            try:
                with record_function("bench.call"):
                    out = entry.call(ids)
            except Exception as e:                # a failed call: recorded
                err = f"{type(e).__name__}: {e}"
            t1 = time.perf_counter()
            stages = {n: v["seconds"]
                      for n, v in tracing.snapshot(reset=True).items()}
            records.append(dict(t0=t0, t1=t1, ids=ids, error=err,
                                ok=err is None and set(out) == set(ids),
                                mp=plan.megapixels(ids), stages=stages))
            for i, got in out.items():
                if i not in outputs:
                    outputs[i] = got
                elif not (got == outputs[i] if isinstance(got, bytes)
                          else np.array_equal(got, outputs[i])):
                    differing += 1
            k += 1
    return records, outputs, differing


def judge(first, plan, cell, seed: int, control: bool) -> dict:
    """The checks: each input's first output judged against the reference
    on the host's cores; with ``control``, the control's output of every
    input of the mix, as many as a run's window calls."""
    import multiprocessing

    from benchmark.reference import judge as ref

    if control:
        first = dict.fromkeys(range(len(plan.images)))
    mode = cell.entry.MODE
    tasks = [dict(index=i, original=plan.images[i], output=out, mode=mode,
                  strength=cell.config["strength"],
                  bleed=cell.config["bleed"],
                  full_rows=cell.mix["full_rows"],
                  seed=[abs(seed) % (1 << 64), int(seed < 0), i],
                  control=control)
             for i, out in sorted(first.items())]
    counts = dict(outputs=len(tasks), malformed=0, rows=0, wrong=0,
                  fell_back=0, searched=0, searched_wrong=0)
    workers = max(1, min(len(os.sched_getaffinity(0)), 8))
    pool = multiprocessing.get_context("spawn").Pool(workers)
    try:
        searches = []
        for res in pool.imap_unordered(ref.first_pass, tasks):
            i = res["index"]
            counts["malformed"] += res["malformed"]
            counts["rows"] += res["rows"]
            counts["wrong"] += res["wrong"]
            counts["fell_back"] += res["fell_back"]
            if res["malformed"]:
                log(f"output of image {i} malformed: {res['why']}")
            elif res["wrong"]:
                log(f"image {i}: {res['wrong']} rows wrong, first "
                    f"{res['first_wrong']}")
            searches += [(i, st["y"], pool.apply_async(
                ref.search, ((st, cell.config["strength"], mode),)))
                for st in res["states"]]
        for i, y, job in searches:
            counts["searched"] += 1
            if not job.get():
                counts["searched_wrong"] += 1
                if counts["searched_wrong"] <= 10:
                    log(f"image {i}: row {y} differs from the scalar "
                        f"model's search")
    finally:
        pool.terminate()
        pool.join()
    return counts


def _descendants() -> dict[int, str]:
    """{pid: command line} of every live process below this one."""
    parent = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as fh:
                stat = fh.read()
            # the fields after the command's name, which is in parentheses
            fields = stat[stat.rindex(")") + 2:].split()
        except (OSError, ValueError):
            continue
        if fields[0] != "Z":
            parent[int(name)] = int(fields[1])
    found, todo = set(), [os.getpid()]
    while todo:
        pid = todo.pop()
        kids = [k for k, p in parent.items() if p == pid and k not in found]
        found.update(kids)
        todo += kids
    out = {}
    for pid in found:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                out[pid] = fh.read().replace(b"\0", b" ").decode(
                    errors="replace").strip()
        except OSError:
            out[pid] = "?"
    return out


def _reap() -> None:
    """Collects every child that has ended, without blocking."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def stop_processes(grace: float = 10.0) -> None:
    """Stops every process this run started and waits until each has
    ended: multiprocessing's resource tracker (closing its pipe ends it),
    then whatever is still running below this process, which is named on
    standard error, asked to end, and killed after ``grace`` seconds.
    Orphans of the run's children are this process's own (it is their
    subreaper, ``subreaper()``), so they are found and waited for too."""
    from multiprocessing import resource_tracker

    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
    _reap()
    left = _descendants()
    if not left:
        return
    for pid, cmd in sorted(left.items()):
        log(f"a process was still running, stopped: {pid} {cmd[:200]}")
    for sig, wait in ((signal.SIGTERM, grace), (signal.SIGKILL, grace)):
        for pid in left:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        end = time.monotonic() + wait
        while left and time.monotonic() < end:
            time.sleep(0.05)
            _reap()
            left = _descendants()
        if not left:
            return
    log(f"processes that would not end: {sorted(left)}")


def subreaper() -> None:
    """Makes this process the parent of its children's orphans (Linux's
    PR_SET_CHILD_SUBREAPER), so that ``stop_processes`` finds them."""
    import ctypes

    with contextlib.suppress(OSError, AttributeError):
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)


def run(args, *, device="cuda", root=ROOT) -> dict:
    """One run of a cell; returns the result line's object."""
    from benchmark.harness import cells, traffic
    from benchmark.reference import scalar

    cell = cells.load(args.workload, root)
    if device == "cuda":
        missing = cuda_missing(cell.chips)
        if missing:
            raise CudaMissing(missing)
    import torch

    readers = {m["name"]: cells.reader(m["name"], root)
               for m in (cell.per_layer if args.trace else cell.end_to_end)}
    t_import = time.perf_counter()
    plan = traffic.plan(cell.mix, args.seed)
    t_plan = time.perf_counter()
    work = tempfile.mkdtemp(prefix="pngloss-bench-")
    try:
        entry = cell.entry.Entry(cell.config, plan, work, device)
        t_entry = time.perf_counter()
        warm = int(cell.mix.get("warmup_calls", 1))
        for k in range(warm):
            entry.call(plan.call(k))
        if device == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - T_START
        log(f"{cell.name}: set-up {setup_s:.3f} s (imports "
            f"{t_import - T_START:.3f}, images {t_plan - t_import:.3f}, "
            f"entry {t_entry - t_plan:.3f}, {warm} warm-up calls "
            f"{T_START + setup_s - t_entry:.3f}), {len(plan.images)} "
            f"images, window {args.seconds} s")

        prof, rec_fn = None, _no_span
        if args.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            rec_fn = torch.profiler.record_function
        with (prof if prof is not None else contextlib.nullcontext()), \
                (instrumented() if args.trace else contextlib.nullcontext()):
            records, first, differing = window(entry, plan, args.seconds,
                                               warm, rec_fn)
        if device == "cuda":
            torch.cuda.synchronize()
            peak = int(torch.cuda.max_memory_allocated())
            kind = torch.cuda.get_device_name(0)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
        else:
            peak, kind, sms = 0, "cpu", os.cpu_count()
        found = forbidden_modules()
        if found:
            raise Forbidden(found)
        del entry
        if device == "cuda":
            torch.cuda.empty_cache()
        trace = None
        if prof is not None:
            from benchmark.harness.trace import Trace

            path = os.path.join(work, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            trace = Trace(path, sms)
            os.unlink(path)

        t_judge = time.perf_counter()
        counts = judge(first, plan, cell, args.seed, bool(args.control))
        counts["differing"] = differing
        log(f"the check took {time.perf_counter() - t_judge:.3f} s, the "
            f"run {time.perf_counter() - T_START:.3f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    failed = sum(not r["ok"] for r in records)
    by_input = {}
    for r in records:
        by_input.setdefault(tuple(r["ids"]), []).append(r["t1"] - r["t0"])
    log("median call seconds by input: " + ", ".join(
        f"{'+'.join(map(str, k)) if len(k) < 4 else 'all'} "
        f"{statistics.median(v):.4f}" for k, v in sorted(by_input.items())))
    for r in records:
        if r["error"]:
            log(f"call failed: {r['error']}")
    view = types.SimpleNamespace(calls=records, setup_s=setup_s, plan=plan,
                                 trace=trace, config=cell.config,
                                 mix=cell.mix, sms=sms,
                                 bpp=[scalar.reduce_colorspace(im)[1]
                                      for im in plan.images])
    units = {m["name"]: m["unit"]
             for m in (cell.per_layer if args.trace else cell.end_to_end)}
    metrics = {}
    for name, read in readers.items():
        value = read(view)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units[name]}
    checks = {
        "calls_failed": [failed, 0],
        "outputs_malformed": [counts["malformed"], 0],
        "repeats_differing": [counts["differing"], 0],
        "rows_wrong": [counts["wrong"], 0],
        "rows_searched_wrong": [counts["searched_wrong"], 0],
    }
    correct = (counts["outputs"] > 0
               and all(v <= limit for v, limit in checks.values()))
    log(f"judged {counts['outputs']} distinct outputs of {len(records)} "
        f"calls: {counts['rows']} rows, {counts['searched']} of them "
        f"searched whole; {counts['fell_back']} rows kept a strength "
        f"below the configuration's")
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(records),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace is not None:
        dev.update(busy_s=trace.busy_s(), window_s=trace.window_s)
        result["breakdown"] = trace.breakdown()
    if args.control:
        log("control: the outputs judged are the control's, not the "
            "program's")
    result["checks"] = {n: {"value": v, "limit": limit}
                        for n, (v, limit) in checks.items()}
    for n, (v, limit) in checks.items():
        print(f"check {n}: {v} (limit {limit})", file=sys.stderr)
    return result


@contextlib.contextmanager
def _no_span(name):
    yield


class CudaMissing(RuntimeError):
    pass


class Forbidden(RuntimeError):
    pass


def main(argv=None) -> int:
    args = parse(argv)
    # the checkout's own cache directories, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    subreaper()
    try:
        result = run(args)
    except CudaMissing as e:
        print(f"error: {e}; the benchmark measures the CUDA card only",
              file=sys.stderr)
        return 2
    except Forbidden as e:
        found = e.args[0]
    else:
        found = forbidden_modules()     # the check and the readers too
    finally:
        stop_processes()
    if found:
        print(f"error: modules loaded in the benchmark's process that it "
              f"must not load: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
