"""Plain writers of the two PNG formats that upstream's suite adds to the
benchmark's inputs, gray (colour type 0) and palette with transparency
(colour type 3: PLTE and tRNS), and a reader of any 8-bit PNG of colour
type 0, 2, 3, 4 or 6 back to RGBA: zlib and the PNG specification
(ISO/IEC 15948: IHDR colour types, 11.2.2; PLTE, 11.2.3; tRNS for
indexed colour, 11.3.2.1; the filters, section 9), nothing else.

A palette entry is a (colour, alpha) pair; tRNS holds the alphas of the
first entries up to the last that is not opaque, and the entries past it
are opaque. A decoder expands each index to its entry, as libpng's
expansion of an indexed image to RGBA does.

Imports numpy and the reference's own ``png`` only.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from benchmark.reference import png


def write_gray(gray: np.ndarray) -> bytes:
    """(H, W) uint8 gray levels as a colour type 0 PNG."""
    return png.write(np.ascontiguousarray(gray)[..., None])


def palette_of(rgba: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(H, W, 4) uint8 RGBA as ((H, W) uint8 indices, (N, 4) uint8
    entries), the entries the distinct pixels in ascending order. Raises
    ValueError where there are more than 256."""
    entries, inverse = np.unique(rgba.reshape(-1, 4), axis=0,
                                 return_inverse=True)
    if len(entries) > 256:
        raise ValueError(f"{len(entries)} distinct pixels, a palette holds "
                         f"256")
    return inverse.reshape(rgba.shape[:2]).astype(np.uint8), entries


def write_palette(indices: np.ndarray, entries: np.ndarray,
                  level: int = 6) -> bytes:
    """(H, W) uint8 indices into (N, 4) uint8 (colour, alpha) entries as a
    colour type 3 PNG with PLTE and, where an entry is not opaque, tRNS.
    Every row takes filter 0 (none), as the specification advises for
    indexed colour (12.8)."""
    h, w = indices.shape
    entries = np.asarray(entries, np.uint8)
    if not 0 < len(entries) <= 256 or int(indices.max()) >= len(entries):
        raise ValueError("indices outside the palette")
    lines = np.zeros((h, w + 1), np.uint8)
    lines[:, 1:] = indices
    chunks = [(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0)),
              (b"PLTE", entries[:, :3].tobytes())]
    see_through = np.flatnonzero(entries[:, 3] != 255)
    if len(see_through):
        chunks.append((b"tRNS", entries[:see_through[-1] + 1, 3].tobytes()))
    chunks += [(b"IDAT", zlib.compress(lines.tobytes(), level)),
               (b"IEND", b"")]
    return png.SIGNATURE + b"".join(png._chunk(n, b) for n, b in chunks)


def _chunks(data: bytes):
    """(name, body) of each chunk up to IEND, CRCs checked."""
    if data[:8] != png.SIGNATURE:
        raise png.PngError("not a PNG signature")
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise png.PngError("truncated chunk header")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        name = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise png.PngError(f"truncated {name!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(name + body) & 0xFFFFFFFF:
            raise png.PngError(f"bad CRC in {name!r}")
        pos += 12 + length
        yield name, body
        if name == b"IEND":
            return
    raise png.PngError("no IEND")


def color_type(data: bytes) -> int:
    """The colour type in a PNG's IHDR."""
    for name, body in _chunks(data):
        if name == b"IHDR" and len(body) == 13:
            return body[9]
        raise png.PngError("IHDR is not the first chunk")
    raise png.PngError("no IHDR")


def read_palette(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """An 8-bit, non-interlaced colour type 3 PNG as ((H, W) uint8
    indices, (256, 4) uint8 entries): PLTE's colours, tRNS's alphas, 255
    past tRNS and zeros past PLTE. Raises PngError on anything malformed,
    an index past PLTE among it."""
    ihdr = plte = trns = None
    idat = []
    for name, body in _chunks(data):
        if name == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body) if len(body) == 13 else ()
        elif name == b"PLTE":
            plte = body
        elif name == b"tRNS":
            trns = body
        elif name == b"IDAT":
            idat.append(body)
    if not ihdr or ihdr[2:] != (8, 3, 0, 0, 0):
        raise png.PngError(f"not an 8-bit palette IHDR: {ihdr}")
    if plte is None or not plte or len(plte) % 3 or len(plte) > 768:
        raise png.PngError("bad or missing PLTE")
    n = len(plte) // 3
    if trns is not None and len(trns) > n:
        raise png.PngError("tRNS longer than PLTE")
    w, h = ihdr[:2]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise png.PngError(f"bad zlib stream: {e}") from None
    if len(raw) != h * (w + 1):
        raise png.PngError(f"{len(raw)} bytes of image data, {h * (w + 1)} "
                           f"due")
    indices = np.empty((h, w), np.uint8)
    prev = bytearray(w)
    for y in range(h):
        start = y * (w + 1)
        cur = png._unfilter_row(raw[start],
                                bytearray(raw[start + 1:start + 1 + w]),
                                prev, 1)
        indices[y] = np.frombuffer(bytes(cur), np.uint8)
        prev = cur
    if int(indices.max(initial=0)) >= n:
        raise png.PngError("an index past PLTE")
    entries = np.zeros((256, 4), np.uint8)
    entries[:n, :3] = np.frombuffer(plte, np.uint8).reshape(n, 3)
    entries[:n, 3] = 255
    if trns:
        entries[:len(trns), 3] = np.frombuffer(trns, np.uint8)
    return indices, entries


def read_rgba(data: bytes) -> np.ndarray:
    """An 8-bit, non-interlaced PNG of colour type 0, 2, 3, 4 or 6 as
    (H, W, 4) uint8 RGBA: gray to R = G = B, opaque where the type has no
    alpha, a palette's indices to their entries."""
    if color_type(data) == 3:
        indices, entries = read_palette(data)
        return entries[indices]
    rows, _, ctype = png.read(data)
    c = png.CHANNELS[ctype]
    px = rows.reshape(len(rows), -1, c)
    out = np.full((*px.shape[:2], 4), 255, np.uint8)
    if ctype in (0, 4):
        out[..., :3] = px[..., :1]
        if ctype == 4:
            out[..., 3] = px[..., 1]
    else:
        out[..., :c] = px
    return out
