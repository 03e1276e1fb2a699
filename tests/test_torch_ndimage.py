"""The port's ndimage helpers against tike_tpu.utils.ndimage.

The same seeded float32 arrays go through both; every result agrees to
1e-6 relative to its largest value (float32 sums of the same taps in
another order). Shifts and medians pick values and agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tike_tpu.utils.ndimage as jnd

import tike_tpu_torch.utils.ndimage as tnd

from . import _torch_parity as H


@pytest.mark.parametrize("mode", ["constant", "wrap", "nearest"])
@pytest.mark.parametrize(
    "sigma, truncate", [(1.5, 4.0), ((2.0, 0.7), 4.0), (16 / 3, 6.0), (3.0, 8.0)]
)
def test_gaussian_filter2d_matches_jax(mode, sigma, truncate):
    """The last case has more taps than the array is wide, so the padding
    wraps or repeats more than once."""
    x = H.rng(40).uniform(0, 1, (2, 13, 16)).astype(np.float32)
    want = jnd.gaussian_filter2d(jnp.asarray(x), sigma, mode=mode, truncate=truncate)
    got = tnd.gaussian_filter2d(H.t(x), sigma, mode=mode, truncate=truncate)
    assert got.dtype == torch.float32
    H.assert_close(got, want, rtol=1e-6, atol=1e-6, scale=True)


def test_gaussian_kernel_taps_match_jax():
    for sigma, truncate in ((21.333, 6.0), (16.0, 4.0), (0.3, 4.0)):
        np.testing.assert_array_equal(
            tnd._gaussian_kernel1d(sigma, truncate),
            jnd._gaussian_kernel1d(sigma, truncate),
        )


@pytest.mark.parametrize("size", [1, 2, 3, (2, 3), (4, 1)])
def test_median_filter2d_matches_jax(size):
    """Even windows take the mean of their two middle values."""
    x = H.rng(41).uniform(0, 1, (3, 9, 11)).astype(np.float32)
    want = jnd.median_filter2d(jnp.asarray(x), size)
    got = tnd.median_filter2d(H.t(x), size)
    H.assert_close(got, want, rtol=1e-6, atol=0)


def test_center_of_mass2d_matches_jax():
    x = H.rng(42).uniform(0, 1, (12, 17)).astype(np.float32)
    for g, w in zip(tnd.center_of_mass2d(H.t(x)), jnd.center_of_mass2d(jnp.asarray(x))):
        H.assert_close(g, w, rtol=1e-6)


@pytest.mark.parametrize("dy", [-1, 0, 1])
@pytest.mark.parametrize("dx", [-1, 0, 1])
def test_integer_shift2d_matches_jax(dy, dx):
    x = H.crandn(H.rng(43), 2, 6, 7)
    want = jnd.integer_shift2d(jnp.asarray(x), (jnp.int32(dy), jnp.int32(dx)))
    # The offsets may be device tensors, as constrain_center_peak passes.
    got = tnd.integer_shift2d(H.t(x), (torch.tensor(dy), torch.tensor(dx)))
    np.testing.assert_array_equal(H.n(got), np.asarray(want))
    np.testing.assert_array_equal(H.n(tnd.integer_shift2d(H.t(x), (dy, dx))), H.n(got))
