"""ctypes bindings for the port's stream encoder (``csrc/host/``).

``EncodeStream`` encodes the optimizer's working plane as its rows
arrive: each band is filtered and deflated while the card still makes the
rows after it, and the PNG it ends with is ``codec.native.encode``'s for
the plane restored to RGBA. Its deflate is ``native/fast_deflate.cpp``'s
zlib clone made incremental (``csrc/host/stream_deflate.cpp``); the shared
library is built on demand from ``csrc/host/Makefile`` (g++ + zlib only).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from pngloss_tpu_torch.codec.native import _TRANSFORM_TO_CODE, _serialize_chunks
from pngloss_tpu_torch.codec.pypng import COLOR_GAMA_ONLY, TooLargeFile

_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
    "host")
_SO_PATH = os.path.join(_DIR, "libpngloss_stream.so")
# the sources of the library's Makefile target
_SOURCES = ("encode_stream.cpp", "stream_deflate.cpp")
# pl_encode_stream_end: the output takes another colour type than the plane's
_RETYPED = 3
# pl_encode_stream_begin: the deflate clone is off (PNGLOSS_NO_FAST_DEFLATE,
# or the clone differs from the system zlib on the canary buffer)
_NO_CLONE = 5

_lock = threading.Lock()
_lib = None
_load_failed = False


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", _DIR, "-s"],
                       check=True, capture_output=True, timeout=300)
        return True
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError):
        return False


def load():
    """Load (building if needed) the stream library, or None where it is
    not there (no compiler, or ``PNGLOSS_NO_NATIVE``, under which the
    codec is the pure-Python one)."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if os.environ.get("PNGLOSS_NO_NATIVE"):
            _load_failed = True
            return None
        if (not os.path.exists(_SO_PATH)
                or os.path.getmtime(_SO_PATH) < max(
                    os.path.getmtime(os.path.join(_DIR, src))
                    for src in _SOURCES)):
            if not _build():
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            _load_failed = True
            return None
        lib.pl_stream_last_error.restype = ctypes.c_char_p
        lib.pl_stream_free.argtypes = [ctypes.c_void_p]
        lib.pl_encode_stream_begin.argtypes = [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int, ctypes.c_double,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_void_p),
        ]
        lib.pl_encode_stream_begin.restype = ctypes.c_int
        lib.pl_encode_stream_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_uint32,
        ]
        lib.pl_encode_stream_rows.restype = ctypes.c_int
        lib.pl_encode_stream_end.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.pl_encode_stream_end.restype = ctypes.c_int
        lib.pl_encode_stream_free.argtypes = [ctypes.c_void_p]
        lib.pl_encode_stream_free.restype = None
        _lib = lib
        return _lib


def _error(lib) -> ValueError:
    return ValueError(lib.pl_stream_last_error().decode())


def begin(w: int, h: int, bpp: int, gamma: float = 0.45455,
          color_transform: str = COLOR_GAMA_ONLY, chunks=None):
    """An ``EncodeStream`` of an h x w working plane of ``bpp`` bytes a
    pixel, with the input's gamma, colour transform and chunks; None where
    the library is not there or its deflate clone is off
    (``PNGLOSS_NO_FAST_DEFLATE``, or a system zlib that deflates the canary
    buffer otherwise), so that the caller encodes one-shot."""
    lib = load()
    if lib is None:
        return None
    blob = _serialize_chunks(chunks)
    handle = ctypes.c_void_p()
    rc = lib.pl_encode_stream_begin(
        w, h, bpp, float(gamma), _TRANSFORM_TO_CODE[color_transform], blob,
        len(blob), ctypes.byref(handle))
    if rc == _NO_CLONE:
        return None
    if rc != 0:
        raise _error(lib)
    return EncodeStream(lib, handle, w, bpp)


class EncodeStream:
    """The PNG of a working plane (``pipeline.pack_work``'s (H, W*bpp)
    uint8 layout: gray, gray+alpha, RGB or RGBA) encoded as its rows
    arrive (made by ``begin``): ``rows`` filters and deflates each band of
    rows while later ones are still being made, ``end`` returns the bytes
    ``codec.native.encode`` gives for the plane restored to RGBA. The
    output's colour type is taken to be the plane's; where the rows never
    confirm it (a plane whose output is all gray, or all opaque), ``end``
    returns None and the caller encodes one-shot. A context manager: a
    stream left without ``end`` is freed on exit."""

    def __init__(self, lib, handle, w: int, bpp: int):
        self._lib, self._handle, self._w, self._bpp = lib, handle, w, bpp

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._handle is not None:
            self._lib.pl_encode_stream_free(self._handle)
            self._handle = None

    def rows(self, rows: np.ndarray, filters: np.ndarray) -> None:
        """The next rows of the plane, (n, W*bpp) uint8, and their row
        filters (n,); row 0's filter is libpng's MSAD choice, as
        ``encode`` makes it."""
        rows = np.ascontiguousarray(rows, dtype=np.uint8)
        filters = np.ascontiguousarray(filters, dtype=np.int8)
        n = rows.shape[0]
        if rows.shape[1:] != (self._w * self._bpp,) or filters.shape != (n,):
            raise ValueError(f"rows {rows.shape} and filters "
                             f"{filters.shape} do not fit the plane")
        rc = self._lib.pl_encode_stream_rows(
            self._handle, rows.ctypes.data, filters.ctypes.data, n)
        if rc != 0:
            raise _error(self._lib)

    def end(self, maximum_file_size: int = 0) -> bytes | None:
        """The PNG, once every row is in (raises ``TooLargeFile`` past
        ``maximum_file_size``, as ``encode``), or None where the output
        takes another colour type than the plane's."""
        handle, self._handle = self._handle, None
        out_p = ctypes.c_void_p()
        out_len = ctypes.c_size_t()
        rc = self._lib.pl_encode_stream_end(
            handle, int(maximum_file_size), ctypes.byref(out_p),
            ctypes.byref(out_len))
        if rc == _RETYPED:
            return None
        if rc not in (0, 98):
            raise _error(self._lib)
        data = ctypes.string_at(out_p, out_len.value)
        self._lib.pl_stream_free(out_p)
        if rc == 98:
            raise TooLargeFile(f"{len(data)} > {maximum_file_size}", data)
        return data
