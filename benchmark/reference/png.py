"""A plain PNG writer for the benchmark's inputs and reader for the
program's outputs: zlib and the five filters of the PNG specification
(ISO/IEC 15948, sections 9 and 10), nothing else.

8-bit, non-interlaced images in colour types 0 (gray), 2 (RGB), 4 (gray and
alpha) and 6 (RGBA), which is everything the pngloss command writes. The
reader keeps each row's filter byte, so a check can judge the filters the
encoder was told to use as well as the pixels.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class PngError(ValueError):
    """The bytes are not a PNG this reader accepts."""


def _chunk(name: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + name + body
            + struct.pack(">I", zlib.crc32(name + body) & 0xFFFFFFFF))


def filter_rows(px: np.ndarray, f: int, bpp: int) -> np.ndarray:
    """Every row of ``px`` (H, W*bpp) int16 under filter ``f``, each
    predicted from the row above it (zeros above the first). Returns
    uint8."""
    up = np.zeros_like(px)
    up[1:] = px[:-1]
    left = np.zeros_like(px)
    left[:, bpp:] = px[:, :-bpp]
    diag = np.zeros_like(px)
    diag[:, bpp:] = up[:, :-bpp]
    if f == 0:
        pred = np.zeros_like(px)
    elif f == 1:
        pred = left
    elif f == 2:
        pred = up
    elif f == 3:
        pred = (left + up) >> 1
    else:
        p = left + up - diag
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - diag)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, diag))
    return ((px - pred) & 0xFF).astype(np.uint8)


def write(pixels: np.ndarray, level: int = 6, filters=None) -> bytes:
    """(H, W, C) uint8 pixels, C in 1-4, as PNG bytes. Each row takes its
    filter from ``filters`` where given, else the filter with the least
    sum of absolute signed residuals, as a common encoder's adaptive
    filtering does (the first such filter on a tie)."""
    h, w, c = pixels.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    flat = pixels.reshape(h, w * c).astype(np.int16)
    cands = np.stack([filter_rows(flat, f, c) for f in range(5)])
    sad = np.where(cands < 128, cands, 256 - cands.astype(np.int16)).sum(
        2, dtype=np.int64)
    best = np.argmin(sad, 0) if filters is None else np.asarray(filters,
                                                                np.intp)
    lines = np.empty((h, w * c + 1), np.uint8)
    lines[:, 0] = best
    lines[:, 1:] = cands[best, np.arange(h)]
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(lines.tobytes(), level))
            + _chunk(b"IEND", b""))


def _unfilter_row(f: int, line: bytearray, prev: bytearray,
                  bpp: int) -> bytearray:
    n = len(line)
    if f == 0:
        return line
    if f == 2:
        return bytearray((a + b) & 0xFF for a, b in zip(line, prev))
    cur = bytearray(line)
    if f == 1:
        for x in range(bpp, n):
            cur[x] = (cur[x] + cur[x - bpp]) & 0xFF
        return cur
    if f == 3:
        for x in range(n):
            left = cur[x - bpp] if x >= bpp else 0
            cur[x] = (cur[x] + ((left + prev[x]) >> 1)) & 0xFF
        return cur
    if f == 4:
        for x in range(n):
            up = prev[x]
            if x >= bpp:
                left, diag = cur[x - bpp], prev[x - bpp]
            else:
                left = diag = 0
            p = left + up - diag
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - diag)
            if pa <= pb and pa <= pc:
                pred = left
            elif pb <= pc:
                pred = up
            else:
                pred = diag
            cur[x] = (cur[x] + pred) & 0xFF
        return cur
    raise PngError(f"unknown filter type {f}")


def read(data: bytes) -> tuple[np.ndarray, np.ndarray, int]:
    """PNG bytes to ((H, W*C) uint8 unfiltered rows, (H,) filter bytes,
    colour type). Raises PngError on anything malformed: a bad signature
    or CRC, a missing or repeated critical chunk, a depth other than 8,
    interlacing, or image data of the wrong length."""
    if data[:8] != SIGNATURE:
        raise PngError("not a PNG signature")
    pos, ihdr, idat, end = 8, None, [], False
    while pos < len(data):
        if pos + 8 > len(data):
            raise PngError("truncated chunk header")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        name = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise PngError(f"truncated {name!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(name + body) & 0xFFFFFFFF:
            raise PngError(f"bad CRC in {name!r}")
        pos += 12 + length
        if name == b"IHDR":
            if ihdr is not None or length != 13:
                raise PngError("bad IHDR")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif name == b"IDAT":
            idat.append(body)
        elif name == b"IEND":
            end = True
            break
        elif name[0] & 0x20 == 0 and name != b"PLTE":
            raise PngError(f"unknown critical chunk {name!r}")
    if ihdr is None or not idat or not end:
        raise PngError("missing IHDR, IDAT or IEND")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if depth != 8 or ctype not in CHANNELS or comp or filt or interlace:
        raise PngError(f"unsupported IHDR {ihdr}")
    bpp = CHANNELS[ctype]
    n = w * bpp
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PngError(f"bad zlib stream: {e}") from None
    if len(raw) != h * (n + 1):
        raise PngError(f"{len(raw)} bytes of image data, {h * (n + 1)} due")
    rows = np.empty((h, n), np.uint8)
    filters = np.empty(h, np.uint8)
    prev = bytearray(n)
    for y in range(h):
        start = y * (n + 1)
        filters[y] = raw[start]
        cur = _unfilter_row(raw[start], bytearray(raw[start + 1:start + 1 + n]),
                            prev, bpp)
        rows[y] = np.frombuffer(bytes(cur), np.uint8)
        prev = cur
    return rows, filters, ctype
