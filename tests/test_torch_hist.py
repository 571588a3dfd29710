"""Port's original-frequency pre-pass vs the JAX package's Pallas kernel
(interpret mode) and the scalar model. Integer histograms: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pngloss_tpu.core import reference as ref
from pngloss_tpu.ops.pallas_hist import original_frequencies_pallas
from pngloss_tpu_torch.ops import hist
from pngloss_tpu_torch.ops.edges import HIST_EDGES, hist_edge_inputs


def _pallas(rows, bpp, w_real=None, h_real=None):
    b, h, wb = rows.shape
    imgs = jnp.asarray(rows.reshape(b, h, wb // bpp, bpp).astype(np.int32))
    wr = None if w_real is None else jnp.asarray(w_real, jnp.int32)
    hr = None if h_real is None else jnp.asarray(h_real, jnp.int32)
    return np.asarray(original_frequencies_pallas(imgs, bpp, wr, hr,
                                                  interpret=True))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_matches_pallas_and_reference(bpp):
    rng = np.random.default_rng(100 + bpp)
    rows = rng.integers(0, 256, (2, 6, 7 * bpp), dtype=np.uint8)
    rows[1, :, :3] = 7          # runs of equal bytes: hot bins
    got = hist.original_frequencies(torch.from_numpy(rows), bpp).numpy()
    assert got.dtype == np.int32 and got.shape == (2, 5, 256)
    np.testing.assert_array_equal(got, _pallas(rows, bpp))
    for i in range(2):
        np.testing.assert_array_equal(got[i],
                                      ref.original_frequencies(rows[i], bpp))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_ragged_masks(bpp):
    rng = np.random.default_rng(110 + bpp)
    sizes = [(6, 7), (3, 4), (5, 2)]
    hp, wp = 8, 9
    rows = rng.integers(0, 256, (len(sizes), hp, wp * bpp), dtype=np.uint8)
    w_real = [w for _, w in sizes]
    h_real = [h for h, _ in sizes]
    got = hist.original_frequencies(torch.from_numpy(rows), bpp,
                                    torch.tensor(w_real, dtype=torch.int32),
                                    torch.tensor(h_real, dtype=torch.int32))
    got = got.numpy()
    np.testing.assert_array_equal(got, _pallas(rows, bpp, w_real, h_real))
    for i, (h, w) in enumerate(sizes):
        np.testing.assert_array_equal(
            got[i], ref.original_frequencies(rows[i, :h, :w * bpp], bpp))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(HIST_EDGES))
def test_edges_of_the_kernels_design(name, bpp):
    """The contract the CUDA kernel is held to on the card (row pitches of
    1 to 16396 bytes, a constant image, real sizes of 1 x 1 and of the
    whole plane, 1 image and 33): the plain version on those inputs
    against the Pallas kernel."""
    for rows, _, w_real, h_real in hist_edge_inputs(name, bpp, "cpu"):
        got = hist.original_frequencies(rows, bpp, w_real, h_real).numpy()
        if w_real is not None:
            w_real, h_real = w_real.numpy(), h_real.numpy()
        np.testing.assert_array_equal(
            got, _pallas(rows.numpy(), bpp, w_real, h_real))


def test_edge_cases_are_what_they_say():
    b, h, w, shift, _ = HIST_EDGES["w4099"]
    (rows, *_), (_, _, w_real, h_real) = hist_edge_inputs("w4099", 1, "cpu")
    assert rows.shape == (b, h, 4099) and rows.stride(1) == 4099
    assert (w_real[0], h_real[0]) == (w, h) and (w_real[-1], h_real[-1]) == (1, 1)
    assert [HIST_EDGES[n][0] for n in ("b1", "b33")] == [1, 33]
    const = hist_edge_inputs("w176-constant", 3, "cpu")[0]
    counts = hist.original_frequencies(*const)
    # one hot bin a filter: all but the first row's and column's samples
    assert bool((counts[0].max(1).values * 10 > counts[0].sum(1) * 9).all())
    for name in ("w64-base-off-by-1", "w64-base-off-by-4"):
        rows = hist_edge_inputs(name, 2, "cpu")[0][0]
        assert rows.storage_offset() == HIST_EDGES[name][3] > 0
