"""The pngloss-compatible command line, on the port.

Counterpart of ``pngloss_tpu/cli.py``. The option surface, validation,
exit codes, output naming, overwrite guard, atomic writes, stdin/stdout
modes and verbose reporting are ``pngloss_tpu.cli``'s own, imported (that
module imports no JAX at its top); the parts that compress call the
port's pipeline on ``device`` (default ``"cuda"``) or over ``mesh``.
Stdout bytes, output files, exit codes and stderr lines equal
``pngloss_tpu.cli.run``'s for the same arguments, apart from the version
header.

One exit code is the port's own: ``NO_CUDA`` (3), when a file is to be
compressed on CUDA and CUDA is not available. Nothing runs on the CPU
instead. ``-h``, ``-V`` and option errors need no card.
"""

from __future__ import annotations

import io
import os
import sys

from pngloss_tpu import codec
from pngloss_tpu.cli import (  # noqa: F401  (the exit codes are re-exported)
    CANT_WRITE_ERROR,
    INVALID_ARGUMENT,
    LIBPNG_FATAL_ERROR,
    MISSING_ARGUMENT,
    NOT_OVERWRITING_ERROR,
    READ_ERROR,
    SUCCESS,
    TOO_LARGE_FILE,
    TOO_LOW_QUALITY,
    USAGE,
    Options,
    _print_wrote,
    _report_cannot_open,
    _report_decode_error,
    _report_input_color,
    _verbose_summary,
    _write_atomic,
    add_filename_extension,
    parse_options,
)
from pngloss_tpu.version import __version__

# not in the reference's enum (rwpng.h:23-38): CUDA asked for, not there
NO_CUDA = 3


def _compress_one(
    data: bytes, opts: Options, verbose_name: str, *, mesh,
) -> tuple[bytes | None, bytes | None, int, "codec.DecodedImage | None"]:
    """Read/optimize/encode one file's bytes. Returns
    (output_bytes, fallback_original_bytes, retval, decoded_image)."""
    from pngloss_tpu_torch import pipeline

    try:
        img = codec.decode(data, strip=opts.strip)
    except codec.PngDecodeError as e:
        _report_decode_error(e, verbose_name, opts.using_stdin)
        return None, None, getattr(e, "exit_code", LIBPNG_FATAL_ERROR), None

    if opts.verbose:
        _report_input_color(img, len(data))

    q, filters = pipeline.optimize_rgba(
        img.rgba, opts.strength, opts.bleed_divider, mesh=mesh)

    if opts.verbose:
        print("  compression complete", file=sys.stderr)
        n = pipeline.unique_symbol_count(
            q, filters, bpp=pipeline.working_bpp(img.rgba))
        print(f"  used {n} unique symbols", file=sys.stderr)

    max_size = len(data) - 1 if opts.skip_if_larger else 0
    try:
        out = codec.encode(
            q, row_filters=filters, gamma=img.gamma,
            color_transform=img.color_transform, chunks=img.chunks,
            maximum_file_size=max_size)
    except codec.TooLargeFile as e:
        if opts.verbose:
            kb = (max_size + 500) // 1000
            print(f"  file exceeded maximum size of {kb}KB", file=sys.stderr)
        # stdout mode: the oversized attempt, then the original 24-bit
        # image, as the reference streams them (pngloss.c:290-297)
        fallback = None
        if opts.using_stdout:
            fallback = e.data + codec.encode(
                img.rgba, row_filters=None, gamma=img.gamma,
                color_transform=img.color_transform, chunks=img.chunks)
        return None, fallback, TOO_LARGE_FILE, img

    return out, None, SUCCESS, img


def _print_full_version(file) -> None:
    """The version header (pngloss.c:55-70) for the port, with the
    versions of its dependencies. Imports no JAX and does not initialise
    CUDA."""
    import zlib

    import torch

    print(f"pngloss-tpu-torch {__version__}, a PyTorch/CUDA port of "
          "pngloss-tpu, a rebuild of pngloss\n"
          "   by William MacKay, Kornel Lesinski.\n"
          "   Hand-written CUDA kernels for NVIDIA Hopper (sm_90a).",
          file=file)
    cuda = (f"CUDA {torch.version.cuda}" if torch.version.cuda
            else "no CUDA")
    print(f"   Using zlib {zlib.ZLIB_VERSION}, torch {torch.__version__} "
          f"({cuda}).", file=file)


def _resolve(device, mesh):
    """The mesh to compress on, or None after reporting that CUDA is
    missing."""
    from pngloss_tpu_torch.ops import CudaUnavailableError
    from pngloss_tpu_torch.parallel import resolve_mesh

    try:
        return resolve_mesh(device, mesh)
    except CudaUnavailableError as e:
        print(f"  error: {e}; not compressing on the CPU instead",
              file=sys.stderr)
        return None


def run(argv: list[str], stdin: io.RawIOBase | None = None,
        stdout: io.RawIOBase | None = None, *, device="cuda",
        mesh=None) -> int:
    """main() (pngloss.c:94-163) on ``device``, or over ``mesh``, which,
    when given, replaces ``device``. Returns the process exit code."""
    opts, retval = parse_options(argv)
    if retval != SUCCESS:
        return retval

    if opts.print_version:
        print(__version__)
        return SUCCESS

    if opts.missing_arguments:
        _print_full_version(sys.stderr)
        print(USAGE, file=sys.stderr, end="")
        return MISSING_ARGUMENT

    if opts.print_help:
        _print_full_version(sys.stdout)
        print(USAGE, end="")
        return SUCCESS

    if opts.strength > 255:
        print("Must specify a strength in the range 0-255.", file=sys.stderr)
        return INVALID_ARGUMENT
    if not 1 <= opts.bleed_divider <= 32767:
        print("Must specify a bleed divider in the range 1-32767.", file=sys.stderr)
        return INVALID_ARGUMENT
    if opts.extension and opts.output_file_path:
        print("--ext and --output options can't be used at the same time",
              file=sys.stderr)
        return INVALID_ARGUMENT
    if opts.extension is None:
        opts.extension = "-loss.png"
    if opts.output_file_path and len(opts.files) != 1:
        print("  error: Only one input file is allowed when --output is used."
              " This error also happens when filenames with spaces are not in quotes.",
              file=sys.stderr)
        return INVALID_ARGUMENT
    if opts.using_stdout and not opts.using_stdin and len(opts.files) != 1:
        print("  error: Only one input file is allowed when using the special"
              " output path \"-\" to write to stdout. This error also happens"
              " when filenames with spaces are not in quotes.", file=sys.stderr)
        return INVALID_ARGUMENT
    if not opts.files and not opts.using_stdin:
        print("No input files specified.", file=sys.stderr)
        if opts.verbose:
            _print_full_version(sys.stderr)
        print(USAGE, file=sys.stderr, end="")
        return MISSING_ARGUMENT

    mesh = _resolve(device, mesh)
    if mesh is None:
        return NO_CUDA

    stdin = stdin if stdin is not None else sys.stdin.buffer
    stdout = stdout if stdout is not None else sys.stdout.buffer

    # pngloss_main_internal (pngloss.c:168-224); several file inputs take
    # the batched path: the same per-file behaviour and output, with one
    # optimizer call per shape bucket
    if len(opts.files) > 1 and not opts.using_stdin and not opts.using_stdout:
        return _run_batched(opts, mesh=mesh)

    error_count = skipped_count = file_count = 0
    latest_error = SUCCESS
    for filename in opts.files:
        display = "stdin" if opts.using_stdin else filename
        retval = SUCCESS
        outname = opts.output_file_path
        if not opts.using_stdout:
            if not outname:
                outname = add_filename_extension(filename, opts.extension)
            if not opts.force and os.path.exists(outname):
                print(f"  error: '{outname}' exists; not overwriting", file=sys.stderr)
                retval = NOT_OVERWRITING_ERROR

        if retval == SUCCESS:
            if opts.verbose:
                print(f"{display}:", file=sys.stderr)
            try:
                if opts.using_stdin:
                    data = stdin.read()
                else:
                    with open(filename, "rb") as fh:
                        data = fh.read()
            except OSError:
                if not opts.using_stdin:
                    _report_cannot_open(filename)
                retval = READ_ERROR
                data = None
            if retval == SUCCESS:
                out, fallback, retval, img = _compress_one(
                    data, opts, display, mesh=mesh)
                if retval == SUCCESS:
                    if opts.using_stdout:
                        if opts.verbose:
                            print("  writing compressed image to stdout",
                                  file=sys.stderr)
                        stdout.write(out)
                    else:
                        if opts.verbose:
                            print(f"  writing compressed image as {outname}",
                                  file=sys.stderr)
                        retval = _write_atomic(outname, out)
                    if retval == SUCCESS:
                        _print_wrote(opts, out, data, img)
                elif fallback is not None:
                    stdout.write(fallback)

        if retval != SUCCESS:
            latest_error = retval
            if retval in (TOO_LOW_QUALITY, TOO_LARGE_FILE):
                skipped_count += 1
            else:
                error_count += 1
        file_count += 1

    _verbose_summary(opts, error_count, skipped_count, file_count)
    return latest_error


def _run_batched(opts, *, mesh) -> int:
    """Multi-file batched mode: overwrite guards and reads up front, one
    optimizer call per shape bucket, then per-file encode+write with the
    same verbose output and exit codes as the sequential path."""
    from pngloss_tpu_torch import pipeline

    entries = []  # [filename, outname, retval, bytes|None, DecodedImage|None]
    for filename in opts.files:
        outname = opts.output_file_path or add_filename_extension(
            filename, opts.extension)
        retval = SUCCESS
        data = img = None
        if not opts.force and os.path.exists(outname):
            print(f"  error: '{outname}' exists; not overwriting", file=sys.stderr)
            retval = NOT_OVERWRITING_ERROR
        if retval == SUCCESS:
            try:
                with open(filename, "rb") as fh:
                    data = fh.read()
            except OSError:
                _report_cannot_open(filename)
                retval = READ_ERROR
        if retval == SUCCESS:
            try:
                img = codec.decode(data, strip=opts.strip)
            except codec.PngDecodeError as e:
                _report_decode_error(e, filename)
                retval = getattr(e, "exit_code", LIBPNG_FATAL_ERROR)
        entries.append([filename, outname, retval, data, img])

    ok = [e for e in entries if e[2] == SUCCESS]
    works, bpps = [], []
    for e in ok:
        work, bpp = pipeline.reduce_colorspace(e[4].rgba)
        works.append(work)
        bpps.append(bpp)
    pending = pipeline.dispatch_buckets(
        works, bpps, opts.strength, opts.bleed_divider, mesh=mesh)
    qs, fs = [None] * len(ok), [None] * len(ok)
    for pi, p in enumerate(pending):
        if opts.verbose:
            # one progress line per bucket, the batched analog of the
            # reference's per-row spinner (pngloss_image.c:214-237)
            h, wb = p.q.shape[1], p.q.shape[2]
            print(f"  optimizing bucket {pi + 1}/{len(pending)}: "
                  f"{len(p.idxs)} image(s) at {wb // p.bpp}x{h}x{p.bpp}bpp",
                  file=sys.stderr)
        qb, fb = pipeline.collect_bucket(p)
        for k, i in enumerate(p.idxs):
            qs[i] = pipeline.restore_colorspace(
                qb[k], p.bpp, ok[i][4].rgba.shape[1])
            fs[i] = fb[k]

    error_count = skipped_count = 0
    latest_error = SUCCESS
    for j, e in enumerate(ok):
        filename, outname, _, data, img = e
        if opts.verbose:
            print(f"{filename}:", file=sys.stderr)
            _report_input_color(img, len(data))
            print("  compression complete", file=sys.stderr)
            n = pipeline.unique_symbol_count(
                qs[j], fs[j], bpp=pipeline.working_bpp(img.rgba))
            print(f"  used {n} unique symbols", file=sys.stderr)
        max_size = len(data) - 1 if opts.skip_if_larger else 0
        try:
            out = codec.encode(
                qs[j], row_filters=fs[j], gamma=img.gamma,
                color_transform=img.color_transform, chunks=img.chunks,
                maximum_file_size=max_size)
        except codec.TooLargeFile:
            if opts.verbose:
                kb = (max_size + 500) // 1000
                print(f"  file exceeded maximum size of {kb}KB", file=sys.stderr)
            e[2] = TOO_LARGE_FILE
            continue
        if opts.verbose:
            print(f"  writing compressed image as {outname}", file=sys.stderr)
        e[2] = _write_atomic(outname, out)
        if e[2] == SUCCESS:
            _print_wrote(opts, out, data, img)

    for e in entries:
        if e[2] != SUCCESS:
            latest_error = e[2]
            if e[2] in (TOO_LOW_QUALITY, TOO_LARGE_FILE):
                skipped_count += 1
            else:
                error_count += 1
    _verbose_summary(opts, error_count, skipped_count, len(entries))
    return latest_error


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
