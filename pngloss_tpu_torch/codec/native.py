"""ctypes bindings for the native host codec (native/pngloss_host.cpp).

Same byte-level behavior as the pure-Python codec; C++ for production
throughput of the host stages (decode, filter+DEFLATE). The shared library
is built on demand from native/Makefile (g++ + zlib only).

The port's own copy of ``pngloss_tpu/codec/native.py``: the port imports nothing
of the JAX package.
Like the original it finds ``native/`` at the root of the checkout, which
both packages share.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from pngloss_tpu_torch.codec import pypng
from pngloss_tpu_torch.codec.pypng import (
    COLOR_GAMA_ONLY,
    COLOR_NONE,
    COLOR_SRGB,
    Chunk,
    DecodedImage,
    PngDecodeError,
    TooLargeFile,
)

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libpngloss_host.so")
# the sources of the library's Makefile target
_SOURCES = ("pngloss_host.cpp", "fast_deflate.cpp")

_TRANSFORM_TO_CODE = {COLOR_NONE: 0, COLOR_SRGB: 1, COLOR_GAMA_ONLY: 2}
_CODE_TO_TRANSFORM = {v: k for k, v in _TRANSFORM_TO_CODE.items()}

_lock = threading.Lock()
_lib = None
_load_failed = False


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, "-s"],
                       check=True, capture_output=True, timeout=300)
        return True
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError):
        return False


def load():
    """Load (building if needed) the native library, or None if unavailable."""
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
                    os.path.getmtime(os.path.join(_NATIVE_DIR, src))
                    for src in _SOURCES)):
            if not _build():
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            _load_failed = True
            return None
        lib.pl_last_error.restype = ctypes.c_char_p
        lib.pl_free.argtypes = [ctypes.c_void_p]
        lib.pl_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.pl_decode.restype = ctypes.c_int
        lib.pl_encode.argtypes = [
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_char_p, ctypes.c_double, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.pl_encode.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _serialize_chunks(chunks) -> bytes:
    blob = bytearray()
    for c in chunks or ():
        blob += len(c.data).to_bytes(4, "little")
        blob += c.name
        blob.append(c.location)
        blob += c.data
    return bytes(blob)


def _parse_chunks(blob: bytes) -> list[Chunk]:
    out = []
    pos = 0
    while pos < len(blob):
        n = int.from_bytes(blob[pos:pos + 4], "little")
        name = blob[pos + 4:pos + 8]
        location = blob[pos + 8]
        data = blob[pos + 9:pos + 9 + n]
        out.append(Chunk(name=name, data=data, location=location))
        pos += 9 + n
    return out


def decode(data: bytes, strip: bool = False) -> DecodedImage:
    lib = load()
    assert lib is not None
    rgba_p = ctypes.c_void_p()
    w = ctypes.c_uint32()
    h = ctypes.c_uint32()
    gamma = ctypes.c_double()
    transform = ctypes.c_int()
    chunks_p = ctypes.c_void_p()
    chunks_len = ctypes.c_size_t()
    rc = lib.pl_decode(data, len(data), int(strip),
                       ctypes.byref(rgba_p), ctypes.byref(w), ctypes.byref(h),
                       ctypes.byref(gamma), ctypes.byref(transform),
                       ctypes.byref(chunks_p), ctypes.byref(chunks_len))
    if rc != 0:
        # rc carries the rwpng.h pngloss_error (25 libpng-fatal, 24 OOM
        # guard); error texts may quote raw bytes from a malformed chunk
        # name, so decode defensively
        raise PngDecodeError(lib.pl_last_error().decode("utf-8", "replace"),
                             exit_code=rc if rc in (24, 25) else 25)
    try:
        n = int(w.value) * int(h.value) * 4
        rgba = np.ctypeslib.as_array(
            ctypes.cast(rgba_p, ctypes.POINTER(ctypes.c_uint8)), shape=(n,)
        ).reshape(int(h.value), int(w.value), 4).copy()
        blob = (ctypes.string_at(chunks_p, chunks_len.value)
                if chunks_p.value and chunks_len.value else b"")
    finally:
        lib.pl_free(rgba_p)
        if chunks_p.value:
            lib.pl_free(chunks_p)
    return DecodedImage(
        rgba=rgba, gamma=gamma.value,
        color_transform=_CODE_TO_TRANSFORM[transform.value],
        chunks=_parse_chunks(blob), file_size=len(data))


def encode(rgba: np.ndarray, row_filters=None, gamma: float = 0.45455,
           color_transform: str = COLOR_GAMA_ONLY, chunks=None,
           maximum_file_size: int = 0) -> bytes:
    lib = load()
    assert lib is not None
    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    h, w = rgba.shape[0], rgba.shape[1]
    if row_filters is not None:
        rf = np.ascontiguousarray(row_filters, dtype=np.int8).tobytes()
        assert len(rf) == h
    else:
        rf = None
    blob = _serialize_chunks(chunks)
    out_p = ctypes.c_void_p()
    out_len = ctypes.c_size_t()
    rc = lib.pl_encode(rgba.tobytes(), w, h, rf, float(gamma),
                       _TRANSFORM_TO_CODE[color_transform],
                       blob, len(blob), int(maximum_file_size),
                       ctypes.byref(out_p), ctypes.byref(out_len))
    if rc not in (0, 98):
        raise ValueError(lib.pl_last_error().decode())
    data = ctypes.string_at(out_p, out_len.value)
    lib.pl_free(out_p)
    if rc == 98:
        raise TooLargeFile(f"{len(data)} > {maximum_file_size}", data)
    return data
