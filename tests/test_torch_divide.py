"""The kernels' division by an invariant divisor (``csrc/quantize.cuh``'s
``make_divisor`` / ``udiv``) against C truncating division, over the
divisors the kernels see (s+1 for s in [0, 255], bleed in [1, 32767]) and
dividends across [0, 2^31).

The row and image kernels divide by s+1 and by bleed at every channel
step, and both divisors are fixed for the launch, so they multiply by a
magic number instead: the round-up method of Granlund and Montgomery
("Division by invariant integers using multiplication", PLDI 1994, figure
4.1), exact for every 32-bit unsigned dividend and every divisor >= 1. The
kernels divide the magnitude of a signed dividend and give the quotient
the dividend's sign, which is C's truncating division. The mirror below
follows that arithmetic step for step on numpy uint64 arrays; one test
compiles the header's own functions with the host C++ compiler and holds
them to the mirror and to C's ``/``, so the two cannot drift apart.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

BAND = range(1, 257)            # s + 1
BLEED = range(1, 32768)
TOP = (1 << 31) - 1             # largest magnitude of an int32 dividend
HEADER = os.path.join(os.path.dirname(__file__), os.pardir,
                      "pngloss_tpu_torch", "csrc", "quantize.cuh")


def invariant_divisor(d: int) -> tuple[int, int, int]:
    """(m, s1, s2) of ``make_divisor(d)`` for a divisor 1 <= d < 2^31."""
    if not 1 <= d < 1 << 31:
        raise ValueError(f"divisor {d} out of range")
    ell = (d - 1).bit_length()                       # ceil(log2(d))
    m = ((1 << 32) * ((1 << ell) - d)) // d + 1
    return m, min(ell, 1), max(ell - 1, 0)


def udiv(n, div: tuple[int, int, int]):
    """``udiv(n, div)`` of quantize.cuh: n // d for 0 <= n < 2^32."""
    m, s1, s2 = div
    n = np.asarray(n, np.uint64)
    t = (n * np.uint64(m)) >> np.uint64(32)          # __umulhi
    return (t + ((n - t) >> np.uint64(s1))) >> np.uint64(s2)


def tdiv(n, div: tuple[int, int, int]):
    """C truncating division of signed n (|n| < 2^31) the kernels' way:
    the magnitude's quotient with the dividend's sign."""
    n = np.asarray(n, np.int64)
    q = udiv(np.abs(n), div).astype(np.int64)
    return np.where(n < 0, -q, q)


def _c_tdiv(n, d):
    """C's truncating division on int64 arrays."""
    q = np.abs(n) // d
    return np.where(n < 0, -q, q)


def test_magic_numbers_fit_the_kernel_types():
    for d in (1, 2, 3, 7, 9, 255, 256, 257, 32767):
        m, s1, s2 = invariant_divisor(d)
        assert 0 < m < 1 << 32 and s1 in (0, 1) and 0 <= s2 < 31
    with pytest.raises(ValueError):
        invariant_divisor(0)


@pytest.mark.parametrize("lo", range(0, 256, 64))
def test_band_divisors_exhaustive_below_2_17(lo):
    """Every s+1 a launch can have, against every dividend below 2^17 (the
    band's dividend is |here - pred|, a byte plus the carried error)."""
    n = np.arange(1 << 17, dtype=np.uint64)
    for d in range(lo + 1, lo + 65):
        np.testing.assert_array_equal(udiv(n, invariant_divisor(d)),
                                      n // np.uint64(d), err_msg=f"d={d}")


def _edges(d: int) -> np.ndarray:
    """Dividends where a quotient steps: multiples of d +-1 at every scale
    up to 2^31, and the top of the range."""
    k = np.unique(np.concatenate([
        np.arange(0, 64), np.geomspace(64, TOP // d, 48).astype(np.int64)]))
    k = k[k * d <= TOP]
    n = np.concatenate([k * d - 1, k * d, k * d + 1, [TOP - 1, TOP]])
    return n[(n >= 0) & (n <= TOP)].astype(np.uint64)


@pytest.mark.parametrize("chunk", range(8))
def test_bleed_divisors_at_every_quotient_scale(chunk):
    """Every bleed, at the dividends where its quotient steps, up to
    2^31 - 1 (at bleed 1 the carried error grows with the image, so the
    kernels may see any int32 magnitude)."""
    for d in range(1 + chunk * 4096, min(32768, 1 + (chunk + 1) * 4096)):
        n = _edges(d)
        np.testing.assert_array_equal(udiv(n, invariant_divisor(d)),
                                      n // np.uint64(d), err_msg=f"d={d}")


@pytest.mark.parametrize("d", [1, 2, 3, 9, 16, 20, 256, 4099, 32767])
def test_signed_dividends_truncate_like_c(d):
    rng = np.random.default_rng(d)
    n = np.concatenate([np.arange(-4 * d - 3, 4 * d + 4),
                        rng.integers(-TOP, TOP + 1, 4096), [-TOP, TOP]])
    np.testing.assert_array_equal(tdiv(n, invariant_divisor(d)),
                                  _c_tdiv(n, d))


# the header's division, from "struct Divisor" up to the next section,
# built for the host: CUDA's qualifiers become plain C++, __umulhi a
# 64-bit product
HOST_SHIM = r"""
#define __host__
#define __device__
#define __forceinline__ inline
static inline unsigned __umulhi(unsigned a, unsigned b) {
  return static_cast<unsigned>((static_cast<unsigned long long>(a) * b) >> 32);
}
%s
extern "C" void magic(unsigned d, unsigned* m, int* s1, int* s2) {
  const Divisor v = make_divisor(d);
  *m = v.m; *s1 = v.s1; *s2 = v.s2;
}
extern "C" long long dense_mismatches(unsigned d_lo, unsigned d_hi,
                                      unsigned n_hi) {
  long long bad = 0;
  for (unsigned d = d_lo; d <= d_hi; ++d) {
    const Divisor v = make_divisor(d);
    for (unsigned n = 0; n < n_hi; ++n) bad += udiv(n, v) != n / d;
  }
  return bad;
}
extern "C" long long mismatches(unsigned d, const unsigned* n, long long k) {
  const Divisor v = make_divisor(d);
  long long bad = 0;
  for (long long i = 0; i < k; ++i) bad += udiv(n[i], v) != n[i] / d;
  return bad;
}
"""


@pytest.fixture(scope="module")
def header_division(tmp_path_factory):
    """The header's make_divisor / udiv, compiled on the host."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    with open(HEADER) as fh:
        src = fh.read()
    start = src.index("struct Divisor")
    end = src.index("// PNG predictor")
    d = tmp_path_factory.mktemp("divide")
    with open(d / "divide.cpp", "w") as fh:
        fh.write(HOST_SHIM % src[start:end])
    subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-o", str(d / "div.so"),
                    str(d / "divide.cpp")], check=True, capture_output=True,
                   timeout=120)
    lib = ctypes.CDLL(str(d / "div.so"))
    lib.dense_mismatches.restype = ctypes.c_longlong
    lib.mismatches.restype = ctypes.c_longlong
    return lib


def test_header_division_is_the_mirror_and_c_division(header_division):
    """quantize.cuh's own arithmetic: its magic numbers equal the mirror's
    for every divisor the kernels see, and its udiv equals C's ``/`` on
    every band divisor below 2^17 and on every bleed where its quotient
    steps."""
    lib = header_division
    m, s1, s2 = ctypes.c_uint(), ctypes.c_int(), ctypes.c_int()
    for d in sorted(set(BAND) | set(BLEED)):
        lib.magic(d, ctypes.byref(m), ctypes.byref(s1), ctypes.byref(s2))
        assert (m.value, s1.value, s2.value) == invariant_divisor(d), d
    assert lib.dense_mismatches(1, 256, 1 << 17) == 0
    for d in BLEED:
        n = np.ascontiguousarray(_edges(d).astype(np.uint32))
        ptr = n.ctypes.data_as(ctypes.POINTER(ctypes.c_uint))
        assert lib.mismatches(d, ptr, len(n)) == 0, d
