"""The pngloss-compatible command line, on the port.

Counterpart of ``pngloss_tpu/cli.py``. The option surface, validation,
exit codes, output naming, overwrite guard, atomic writes, stdin/stdout
modes and verbose reporting are copies of ``pngloss_tpu.cli``'s (the port
imports nothing of the JAX package); the parts that compress call the
port's pipeline on ``device`` (default ``"cuda"``) or over ``mesh``.
Stdout bytes, output files, exit codes and stderr lines equal
``pngloss_tpu.cli.run``'s for the same arguments, apart from the version
header.

One exit code is the port's own: ``NO_CUDA`` (3), when a file is to be
compressed on CUDA and CUDA is not available. Nothing runs on the CPU
instead. ``-h``, ``-V`` and option errors need no card.
"""

from __future__ import annotations

import getopt
import io
import os
import sys
import tempfile

from pngloss_tpu_torch import codec, tracing
from pngloss_tpu_torch.version import __version__

# pngloss_error (rwpng.h:23-38) — enum values double as process exit codes
SUCCESS = 0
MISSING_ARGUMENT = 1
READ_ERROR = 2
INVALID_ARGUMENT = 4
NOT_OVERWRITING_ERROR = 15
CANT_WRITE_ERROR = 16
OUT_OF_MEMORY_ERROR = 17
PNG_OUT_OF_MEMORY_ERROR = 24
LIBPNG_FATAL_ERROR = 25
WRONG_INPUT_COLOR_TYPE = 26
LIBPNG_INIT_ERROR = 35
TOO_LARGE_FILE = 98
TOO_LOW_QUALITY = 99
# not in the reference's enum (rwpng.h:23-38): CUDA asked for, not there
NO_CUDA = 3

# user documentation wording follows the reference tool's help text
# (PNGLOSS_USAGE, pngloss.c:28-51) so reference users see the interface
# they know; only the header line and the TPU note differ
USAGE = """\
usage:  pngloss [options] -- pngfile [pngfile ...]
        pngloss [options] - >stdout <stdin

options:
  -s, --strength 19 how much quality to sacrifice, from 0 to 100 (default 19)
  -b, --bleed 2     bleed divider, from 1 (full dithering) to 32767 (none)
  -f, --force       overwrite existing output files
  -o, --output file destination file path to use instead of --ext
  -v, --verbose     print status messages
  -q, --quiet       don't print status messages (default, overrides -v)
  -V, --version     print version number
  --skip-if-larger  only save converted files if they're smaller than original
  --ext new.png     set custom suffix/extension for output filenames
  --strip           remove optional metadata (default on Mac)

Lossily compresses a PNG by using more compressible colors that are
close enough to the original color values. The threshold determining
what is close enough is controlled by the strength parameter. The output
filename is the same as the input name except that it ends in "-loss.png"
or your custom extension (unless the input is stdin, in which case the
compressed image will go to stdout).  If you pass the special output path
"-" and a single input file, that file will be processed and the
compressed image will go to stdout. The default behavior if the output
file exists is to skip the conversion; use --force to overwrite.
"""

_LONG_OPTS = [
    "verbose", "quiet", "force", "no-force", "ext=", "skip-if-larger",
    "output=", "strip", "version", "help", "strength=", "bleed=",
]


class Options:
    def __init__(self):
        self.strength = 19
        self.bleed_divider = 2
        self.extension: str | None = None
        self.output_file_path: str | None = None
        self.files: list[str] = []
        self.using_stdin = False
        self.using_stdout = False
        self.force = False
        self.skip_if_larger = False
        self.strip = False
        self.print_help = False
        self.print_version = False
        self.missing_arguments = False
        self.verbose = False


def parse_options(argv: list[str]) -> tuple[Options, int]:
    """pngloss_parse_options (pngloss_opts.c:38-138)."""
    o = Options()
    try:
        opts, args = getopt.gnu_getopt(
            argv, "vqfo:Vhs:b:", _LONG_OPTS)
    except getopt.GetoptError as e:
        print(e, file=sys.stderr)
        return o, INVALID_ARGUMENT

    for flag, val in opts:
        if flag in ("-v", "--verbose"):
            o.verbose = True
        elif flag in ("-q", "--quiet"):
            o.verbose = False
        elif flag in ("-f", "--force"):
            o.force = True
        elif flag == "--no-force":
            o.force = False
        elif flag == "--ext":
            o.extension = val
        elif flag in ("-o", "--output"):
            if o.output_file_path:
                print("--output option can be used only once", file=sys.stderr)
                return o, INVALID_ARGUMENT
            if val == "-":
                o.using_stdout = True
            else:
                o.output_file_path = val
        elif flag == "--skip-if-larger":
            o.skip_if_larger = True
        elif flag == "--strip":
            o.strip = True
        elif flag in ("-h", "--help"):
            o.print_help = True
        elif flag in ("-V", "--version"):
            o.print_version = True
        elif flag in ("-s", "--strength"):
            if not val.isdigit():
                print("-s, --strength requires a numeric argument", file=sys.stderr)
                return o, INVALID_ARGUMENT
            o.strength = int(val)
        elif flag in ("-b", "--bleed"):
            if not val.isdigit():
                print("-b, --bleed requires a numeric argument", file=sys.stderr)
                return o, INVALID_ARGUMENT
            o.bleed_divider = int(val)

    if args:
        if len(args) == 1 and args[0] == "-":
            o.using_stdin = True
            o.using_stdout = o.output_file_path is None or o.using_stdout
        o.files = args
    elif len(argv) == 0:
        o.missing_arguments = True
    return o, SUCCESS


def add_filename_extension(filename: str, newext: str) -> str:
    """Insert the suffix before a trailing .png, else append (pngloss.c:319)."""
    if filename.lower().endswith(".png"):
        return filename[:-4] + newext
    return filename + newext


def _write_atomic(outname: str, data: bytes) -> int:
    """Atomic write via temp file + rename (pngloss.c:392-423)."""
    d = os.path.dirname(outname) or "."
    try:
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, outname)
    except OSError:
        try:
            os.unlink(tmp)
        except Exception:
            pass
        return CANT_WRITE_ERROR
    return SUCCESS


def _print_wrote(opts, out: bytes, data: bytes, img) -> None:
    if not opts.verbose:
        return
    kb = (len(out) + 500) // 1000
    percent = 100.0 * len(out) / len(data)
    print(f"  wrote {kb}KB file ({percent:.1f}% of original)", file=sys.stderr)
    meta = sum(len(c.data) + 12 for c in img.chunks)
    if meta > 0:
        print(f"  copied {(meta + 500) // 1000}KB of additional PNG metadata",
              file=sys.stderr)


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


def _report_cannot_open(filename: str) -> None:
    """read_image's fopen failure line (pngloss.c:441)."""
    print(f"  error: cannot open {filename} for reading", file=sys.stderr)


def _report_decode_error(e: Exception, filename: str,
                         using_stdin: bool = False) -> None:
    """The libpng error-handler line (rwpng.c:652) followed by
    read_image's cannot-decode line (pngloss.c:453)."""
    print(f"  error: {e} (libpng failed)", file=sys.stderr)
    print("  error: cannot decode image "
          + ("from stdin" if using_stdin else os.path.basename(filename)),
          file=sys.stderr)


def _report_input_color(img, data_len: int) -> None:
    """Verbose read-size line plus the input-color report chain
    (pngloss.c:238-254); shared by the sequential and batched modes."""
    print(f"  read {(data_len + 500) // 1000}KB file", file=sys.stderr)
    if img.icc_note == "iccp":
        print("  used embedded ICC profile to transform image to sRGB"
              " colorspace", file=sys.stderr)
    elif img.icc_note == "gama_chrm":
        print("  used gAMA and cHRM chunks to transform image to sRGB"
              " colorspace", file=sys.stderr)
    elif img.icc_note == "iccp_warn_gray":
        print("  warning: ignored ICC profile in GRAY colorspace",
              file=sys.stderr)
    elif img.color_transform == codec.pypng.COLOR_SRGB:
        print("  passing sRGB tag from the input", file=sys.stderr)
    elif img.gamma != 0.45455:
        print(f"  converted image from gamma {1.0 / img.gamma:2.1f}"
              " to gamma 2.2", file=sys.stderr)


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

    # a trace of the call where PNGLOSS_PROFILE_DIR is set
    with tracing.device_trace(), tracing.request("cli.run"):
        return _run_files(opts, stdin, stdout, device, mesh)


class _File:
    """One input file of a call: its name, the name its lines give it,
    its output's name (None for stdout), its exit code so far, the
    overwrite guard's first, and its ``pipeline.Prepared`` once decoded."""

    def __init__(self, opts: Options, name: str):
        self.name = name
        self.display = "stdin" if opts.using_stdin else name
        self.outname = None if opts.using_stdout else (
            opts.output_file_path
            or add_filename_extension(name, opts.extension))
        guarded = (self.outname is not None and not opts.force
                   and os.path.exists(self.outname))
        self.retval = NOT_OVERWRITING_ERROR if guarded else SUCCESS
        self.prep = None


def _run_files(opts, stdin, stdout, device, mesh) -> int:
    """The compressing part of ``run`` (pngloss_main_internal,
    pngloss.c:168-224), on the pipeline's one path for one file or many:
    each file read and prepared on ``pipeline.HostPool`` (in the calling
    thread for one file), every shape bucket optimized in one call, each
    image finished on the pool as its bucket lands, and written with its
    lines in file order. Every guard and read or decode error is reported
    before the first bucket. Under -v one file is named before its read,
    as the reference's sequential mode does; several are named with their
    results, after one line per bucket, as its batched mode does."""
    from pngloss_tpu_torch import pipeline

    mesh = _resolve(device, mesh)
    if mesh is None:
        return NO_CUDA
    stdin = stdin if stdin is not None else sys.stdin.buffer
    stdout = stdout if stdout is not None else sys.stdout.buffer
    files = [_File(opts, name) for name in opts.files]
    several = len(files) > 1

    def load(f):
        with tracing.stage("host_read"):
            if opts.using_stdin:
                data = stdin.read()
            else:
                with open(f.name, "rb") as fh:
                    data = fh.read()
        return pipeline.prepare(data, opts.strip)

    def finish(j, q_work, f_row):
        """(the PNG, or the codec.TooLargeFile raised under
        --skip-if-larger; the symbol count for -v)."""
        prep = ok[j].prep
        n = (pipeline.symbol_count(q_work, f_row, prep.bpp)
             if opts.verbose else None)
        try:
            return pipeline.finish(prep, q_work, f_row,
                                   opts.skip_if_larger), n
        except codec.TooLargeFile as e:
            return e, n

    with pipeline.HostPool() as pool:
        todo = [f for f in files if f.retval == SUCCESS]
        if opts.verbose and todo and not several:
            print(f"{todo[0].display}:", file=sys.stderr)
        loaded = iter(pool.map(load, todo))
        ok = []
        for f in files:
            if f.retval == NOT_OVERWRITING_ERROR:
                print(f"  error: '{f.outname}' exists; not overwriting",
                      file=sys.stderr)
                continue
            f.prep, err = next(loaded)
            if err is None:
                ok.append(f)
            elif isinstance(err, OSError):
                if not opts.using_stdin:
                    _report_cannot_open(f.name)
                f.retval = READ_ERROR
            elif isinstance(err, codec.PngDecodeError):
                _report_decode_error(err, f.name, opts.using_stdin)
                f.retval = getattr(err, "exit_code", LIBPNG_FATAL_ERROR)
            else:
                raise err

        pending = pipeline.dispatch_buckets(
            [f.prep.work for f in ok], [f.prep.bpp for f in ok],
            opts.strength, opts.bleed_divider, mesh=mesh)
        if opts.verbose and several:
            # one progress line per bucket, the batched analog of the
            # reference's per-row spinner (pngloss_image.c:214-237)
            for pi, p in enumerate(pending):
                h, wb = p.q.shape[1], p.q.shape[2]
                print(f"  optimizing bucket {pi + 1}/{len(pending)}: "
                      f"{len(p.idxs)} image(s) at {wb // p.bpp}x{h}x"
                      f"{p.bpp}bpp", file=sys.stderr)
        for j, res, err in pool.drain(pending, finish):
            if err is not None:
                raise err
            if opts.verbose and several:
                print(f"{ok[j].display}:", file=sys.stderr)
            _deliver(opts, ok[j], *res, stdout)

    failed = [f.retval for f in files if f.retval != SUCCESS]
    skipped = sum(r in (TOO_LOW_QUALITY, TOO_LARGE_FILE) for r in failed)
    _verbose_summary(opts, len(failed) - skipped, skipped, len(files))
    return failed[-1] if failed else SUCCESS


def _verbose_summary(opts, error_count, skipped_count, file_count):
    if not opts.verbose:
        return
    s = lambda n: "" if n == 1 else "s"
    if error_count:
        print(f"There were errors compressing {error_count} file{s(error_count)}"
              f" out of a total of {file_count} file{s(file_count)}.",
              file=sys.stderr)
    if skipped_count:
        print(f"Skipped {skipped_count} file{s(skipped_count)} out of a total"
              f" of {file_count} file{s(file_count)}.", file=sys.stderr)
    if not skipped_count and not error_count:
        print(f"Compressed {file_count} image{s(file_count)}.", file=sys.stderr)


def _deliver(opts, f: _File, out, n, stdout) -> None:
    """A finished file's -v lines and its PNG written to stdout or its
    output file."""
    img, data = f.prep.img, f.prep.data
    if opts.verbose:
        _report_input_color(img, len(data))
        print("  compression complete", file=sys.stderr)
        print(f"  used {n} unique symbols", file=sys.stderr)
    if isinstance(out, codec.TooLargeFile):
        if opts.verbose:
            kb = (len(data) - 1 + 500) // 1000
            print(f"  file exceeded maximum size of {kb}KB", file=sys.stderr)
        f.retval = TOO_LARGE_FILE
        if f.outname is None:
            # the oversized attempt, then the original 24-bit image, as
            # the reference streams them (pngloss.c:290-297)
            stdout.write(out.data + codec.encode(
                img.rgba, row_filters=None, gamma=img.gamma,
                color_transform=img.color_transform, chunks=img.chunks))
        return
    if opts.verbose:
        print("  writing compressed image to stdout" if f.outname is None
              else f"  writing compressed image as {f.outname}",
              file=sys.stderr)
    with tracing.stage("host_write"):
        if f.outname is None:
            stdout.write(out)
        else:
            f.retval = _write_atomic(f.outname, out)
    if f.retval == SUCCESS:
        _print_wrote(opts, out, data, img)


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
