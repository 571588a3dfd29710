"""Host-side PNG codec: decode to RGBA8 arrays, encode from pixels + filters.

Two implementations with the same byte-level behavior:
  * `pypng` — pure Python/numpy + zlib (correctness reference, always there)
  * `native` — C++ (zlib) for production throughput, built from native/

`decode`/`encode` dispatch to the native codec when it builds/loads, else to
pypng. Set PNGLOSS_NO_NATIVE=1 to force the pure-Python path.

The port's own copy of ``pngloss_tpu/codec/__init__.py``: the port imports nothing
of the JAX package.
"""

from pngloss_tpu_torch.codec.pypng import (
    Chunk,
    DecodedImage,
    PngDecodeError,
    TooLargeFile,
    detect_colorspace,
    msad_filter_choice,
    pack_pixels,
)
from pngloss_tpu_torch.codec import pypng


def decode(data: bytes, strip: bool = False) -> DecodedImage:
    from pngloss_tpu_torch.codec import native

    if native.available():
        img = native.decode(data, strip=strip)
    else:
        img = pypng.decode(data, strip=strip)
    from pngloss_tpu_torch.codec import icc

    if icc.enabled():
        try:
            img.icc_note = icc.apply(data, img)
        except Exception as e:
            # a malformed profile/curve must not fail the decode — lcms in
            # the reference likewise skips the transform when the profile
            # cannot be opened (rwpng.c:315)
            import sys

            print(f"pngloss-tpu: ignoring unusable ICC data ({e})",
                  file=sys.stderr)
    return img


def encode(rgba, row_filters=None, gamma: float = 0.45455,
           color_transform: str = pypng.COLOR_GAMA_ONLY, chunks=None,
           maximum_file_size: int = 0) -> bytes:
    from pngloss_tpu_torch.codec import native

    if native.available():
        return native.encode(rgba, row_filters=row_filters, gamma=gamma,
                             color_transform=color_transform, chunks=chunks,
                             maximum_file_size=maximum_file_size)
    return pypng.encode(rgba, row_filters=row_filters, gamma=gamma,
                        color_transform=color_transform, chunks=chunks,
                        maximum_file_size=maximum_file_size)


__all__ = [
    "Chunk",
    "DecodedImage",
    "PngDecodeError",
    "TooLargeFile",
    "decode",
    "encode",
    "detect_colorspace",
    "msad_filter_choice",
    "pack_pixels",
    "pypng",
]
