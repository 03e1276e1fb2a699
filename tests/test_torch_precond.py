"""Both preconditioner formulations of the port against tike_tpu's.

The gather formulation runs the patch operators per position; the FFT one
scatters bilinear point densities and convolves/correlates them with
full-object fields. Each port function is held against the same JAX
function on the same inputs; both sum many float32 terms in different
orders, so the tolerance is 1e-4 relative plus 1e-5 of the largest value.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tike_tpu.ops.ptycho import PtychoConfig as JConfig
from tike_tpu.ptycho.solvers import _preconditioner as jpre

from tike_tpu_torch.ops.ptycho import PtychoConfig as TConfig
from tike_tpu_torch.ptycho.solvers import _preconditioner as tpre

from . import _torch_parity as H

Hh, Ww, P, N = 120, 100, 16, 150


@pytest.fixture(scope="module")
def setup():
    gen = H.rng(7)
    psi = H.crandn(gen, 1, Hh, Ww)
    probe = H.crandn(gen, 1, 1, 2, P, P)
    scan = np.stack(
        [gen.uniform(2, Hh - P - 3, N), gen.uniform(2, Ww - P - 3, N)], -1
    ).astype(np.float32)
    scan[:10] = np.floor(scan[:10])  # integer corners: degenerate weights
    w = (gen.random(N) > 0.2).astype(np.float32)  # padded slots drop out
    kw = dict(probe_shape=P, detector_shape=P, nz=Hh, n=Ww)
    return JConfig(**kw), TConfig(**kw), psi, probe, scan, w


def _check(got, want):
    H.assert_close(got, want, rtol=1e-4, atol=1e-5, scale=True)


def test_psi_precond_gather_matches_jax(setup):
    jc, tc, psi, probe, scan, w = setup
    want = jpre._psi_precond_math(
        jc, jnp.asarray(psi), jnp.asarray(scan), jnp.asarray(probe), jnp.asarray(w)
    )
    got = tpre._psi_precond_math(tc, H.t(psi), H.t(scan), H.t(probe), H.t(w))
    _check(got, want)


def test_probe_precond_gather_matches_jax(setup):
    jc, tc, psi, probe, scan, w = setup
    want = jpre._probe_precond_math(
        jc, jnp.asarray(psi), jnp.asarray(scan), jnp.asarray(w)
    )
    got = tpre._probe_precond_math(tc, H.t(psi), H.t(scan), H.t(w))
    _check(got, want)


def test_psi_precond_fft_matches_jax(setup):
    jc, tc, psi, probe, scan, w = setup
    want = jpre._psi_precond_fft_math(
        jc, jnp.asarray(scan), jnp.asarray(probe), jnp.asarray(w)
    )
    got = tpre._psi_precond_fft_math(tc, H.t(scan), H.t(probe), H.t(w))
    _check(got, want)


def test_probe_precond_fft_matches_jax(setup):
    jc, tc, psi, probe, scan, w = setup
    want = jpre._probe_precond_fft_math(
        jc, jnp.asarray(psi), jnp.asarray(scan), jnp.asarray(w)
    )
    got = tpre._probe_precond_fft_math(tc, H.t(psi), H.t(scan), H.t(w))
    _check(got, want)


@pytest.mark.parametrize("which", ["psi", "probe"])
def test_port_formulations_agree(setup, which):
    """The port's FFT and gather formulations are the same sum."""
    _, tc, psi, probe, scan, w = setup
    if which == "psi":
        gather = tpre._psi_precond_math(tc, H.t(psi), H.t(scan), H.t(probe), H.t(w))
        fft = tpre._psi_precond_fft_math(tc, H.t(scan), H.t(probe), H.t(w))
    else:
        gather = tpre._probe_precond_math(tc, H.t(psi), H.t(scan), H.t(w))
        fft = tpre._probe_precond_fft_math(tc, H.t(psi), H.t(scan), H.t(w))
    H.assert_close(fft, gather, rtol=2e-4, atol=2e-3, scale=True)


@pytest.mark.parametrize(
    "n_positions, probe_shape, nz, n",
    [
        (10_000, 128, 1500, 1500),
        (516, 128, 501, 501),
        (120, 16, 160, 160),
        (2_000, 64, 700, 300),
    ],
)
def test_fft_precond_profitable_same_rule(n_positions, probe_shape, nz, n):
    assert tpre.fft_precond_profitable(
        n_positions, probe_shape, nz, n
    ) == jpre.fft_precond_profitable(n_positions, probe_shape, nz, n)
    for m in (1, 97, 1500, 1501, 1651):
        assert tpre._fft_len(m) == jpre._fft_len(m)
