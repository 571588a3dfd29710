"""Build and load the CUDA kernels of ``csrc/``.

The kernels are compiled once, at first use, with ``nvcc`` for Hopper
(``sm_90a``): one ``nvcc`` per source, all started together, then one link
into a shared library with a plain C interface, loaded with ``ctypes``.
The library lands in ``build/pngloss_tpu_torch/<key>/`` at the root of
the checkout, where ``key`` hashes the sources and the flags, so a
changed source rebuilds. Nothing here runs at import time: the
package imports on machines with no CUDA toolkit.

Every C entry point takes its pointers and the CUDA stream as
``void*`` (``ctypes.c_void_p``), launches on that stream, allocates
nothing, does not synchronise, and returns ``cudaGetLastError()``;
``check`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build",
                          "pngloss_tpu_torch")
SOURCES = ("hist.cu", "row.cu", "image.cu")
HEADERS = ("quantize.cuh",)
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
LINK_FLAGS = (*_ARCH, "-shared")
LIB_NAME = "libpngloss_tpu_torch.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
# argument types of every C entry point (csrc/*.cu, extern "C")
_SIGNATURES = {
    "plk_hist": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "plk_row_attempt": (_P, _I, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, _P, _P, _I, _I, _I, _P),
    "plk_row_retry": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _P),
    "plk_row_ladder_clusters": (_I, _I, _P),
    "plk_image_rows": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                       _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _P),
    "plk_ladder_clusters": (_I, _I, _P),
    "plk_image_split": (_P, _I, *(_P,) * 14, _I, _I, _I, _I, _P),
    "plk_split_clusters": (_I, _P),
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in ((os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME
                  else None), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build_key() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read() + b"\0")
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(out_path: str) -> str:
    """Compile every source in parallel, then link; returns nvcc's output
    (the register and spill report)."""
    nvcc = nvcc_path()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    work = tempfile.mkdtemp(dir=os.path.dirname(out_path))
    procs: list = []
    try:
        objs = [os.path.join(work, s + ".o") for s in SOURCES]
        for s, obj in zip(SOURCES, objs):
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                 os.path.join(CSRC_DIR, s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=900)[0] for p in procs]
        for s, p, log in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s} ({p.returncode}):"
                                   f"\n{log}")
        lib = os.path.join(work, LIB_NAME)
        proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", lib, *objs],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(lib, out_path)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    return "".join(logs) + proc.stdout + proc.stderr


def library() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        key = build_key()
        path = os.path.join(BUILD_ROOT, key, LIB_NAME)
        t0 = time.perf_counter()
        log = _compile(path) if not os.path.exists(path) else ""
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.plk_error_string.argtypes = [ctypes.c_int]
        lib.plk_error_string.restype = ctypes.c_char_p
        build_info.update(path=path, key=key, compiled=bool(log),
                          seconds=time.perf_counter() - t0, log=log)
        _lib = lib
        return lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = library().plk_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_ptr(t) -> int:
    """The raw handle of torch's current CUDA stream on ``t``'s device.
    Launch under ``torch.cuda.device(t.device)``: a stream is valid only
    while its own device is the current one."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given dtype
    and shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def require_aligned(t, name: str, nbytes: int = 16) -> None:
    """Raise unless ``t``'s data starts on an ``nbytes`` boundary (the
    kernels read and write dither rows as 16-byte vectors)."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name}: expected data aligned to {nbytes} bytes")


def route(t) -> str:
    """'cpu' (plain PyTorch version) or 'cuda' (kernel) for an input
    tensor; any other device raises."""
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return kind
