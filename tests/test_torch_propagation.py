"""The port's Fresnel propagators against tike_tpu's on the CPU.

The transfer function's phase d sqrt((2 pi / lambda)^2 - Kx^2 - Ky^2) is
hundreds to thousands of radians, so H is held to the rounding of that
phase in float32, |d k| 2^-23 rad with k = 2 pi / lambda (1.1e-4 rad at
lambda 1.4e-10 m, d 2e-8 m), and its modulus to 1e-6. Both packages build
it with the same float32 operations in the same order, and the geometries
below give the same bits. Propagated waves pass through two FFTs of two
libraries: 1e-5 of the largest value.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from tike_tpu.ops import propagation as jprop
from tike_tpu.ops.ptycho import PtychoConfig as JConfig

from tike_tpu_torch.ops import propagation as tprop
from tike_tpu_torch.ops.ptycho import PtychoConfig as TConfig

from . import _torch_parity as H

GEOMETRIES = [
    # the multislice reference test's, the defaults, and a rectangle with
    # another field of view per axis
    ((16, 16), (1e-6, 1e-6), 2e-8, 1.4e-10),
    ((24, 24), (1e-6, 1e-6), 1e-6, 1e-9),
    ((16, 20), (2e-6, 1e-6), 5e-8, 1.4e-10),
    ((32, 32), (1e-7, 1e-7), 1e-6, 1e-9),  # evanescent corners
]


def _phase_tol(distance, wavelength):
    return abs(distance * 2 * math.pi / wavelength) * 2.0**-23


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=str)
def test_propagator_matches_jax(geometry):
    shape, fov, d, lam = geometry
    want = np.asarray(jprop.fresnel_spectrum_propagator(shape, fov, d, lam))
    got = H.n(tprop.fresnel_spectrum_propagator(shape, fov, d, lam, device="cpu"))
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=1e-6, atol=1e-30)
    live = np.abs(want) > 1e-20
    phase = np.abs(np.angle(got[live] / want[live]))
    assert phase.max() <= _phase_tol(d, lam), phase.max()


def test_config_propagator_matches_jax():
    kw = dict(
        probe_shape=16, detector_shape=24, nz=40, n=40, nslices=3,
        probe_wavelength=1.4e-10, probe_FOV_lengths=(1e-6, 1e-6),
        multislice_propagation_distance=5e-8,
    )
    got = TConfig(**kw).propagator("cpu")
    H.assert_close(got, JConfig(**kw).propagator(), rtol=1e-6, atol=1e-6)
    # built once per geometry and device
    assert TConfig(**kw).propagator("cpu") is got
    assert TConfig(**{**kw, "nslices": 1}).propagator("cpu") is None


@pytest.mark.parametrize("direction", ["fwd", "adj"])
def test_fresnel_matches_jax(direction):
    gen = H.rng(11)
    x = H.crandn(gen, 5, 2, 16, 16)
    prop = np.asarray(jprop.fresnel_spectrum_propagator((16, 16), (1e-6, 1e-6), 2e-8, 1.4e-10))
    want = getattr(jprop, f"fresnel_{direction}")(jnp.asarray(x), jnp.asarray(prop))
    got = getattr(tprop, f"fresnel_{direction}")(H.t(x), H.t(prop))
    H.assert_close(got, want, rtol=1e-5, atol=1e-5, scale=True)


@pytest.mark.parametrize("geometry", GEOMETRIES[:3], ids=str)
def test_fresnel_adjointness(geometry):
    """<F x, y> = <x, F* y> for the port's pair, to float32 rounding."""
    shape, fov, d, lam = geometry
    gen = H.rng(12)
    x = H.t(H.crandn(gen, 3, *shape))
    y = H.t(H.crandn(gen, 3, *shape))
    prop = tprop.fresnel_spectrum_propagator(shape, fov, d, lam, device="cpu")
    a = complex((tprop.fresnel_fwd(x, prop) * y.conj()).sum())
    b = complex((x * tprop.fresnel_adj(y, prop).conj()).sum())
    assert abs(a - b) <= 1e-5 * abs(a), (a, b)
