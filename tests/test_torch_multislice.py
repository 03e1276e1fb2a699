"""Multislice ptychography's operators in the port against tike_tpu on the
CPU.

The operators (``multislice_fwd``, ``ptycho_fwd_with_probes``,
``ptycho_adj``), rPIE's batch math and both gather preconditioners get the
same seeded inputs on both sides (the JAX functions jitted, as its solvers
run them) and agree to 1e-5 of the largest value:
the Fresnel transfer function is the same bits in both packages
(``test_torch_propagation.py``), and what differs is float32 rounding of
two FFT libraries and of sums taken in other orders (the preconditioners,
as in ``test_torch_precond.py``, 1e-4 relative plus 1e-5 of the largest
value). The whole reconstruction is in ``test_torch_multislice_recon.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tike_tpu.ops import ptycho as jops
from tike_tpu.ptycho.solvers import _preconditioner as jpre

from tike_tpu_torch.ops import ptycho as tops
from tike_tpu_torch.ptycho.solvers import _preconditioner as tpre

from . import _torch_parity as H

jrpie = importlib.import_module("tike_tpu.ptycho.solvers.rpie")
trpie = importlib.import_module("tike_tpu_torch.ptycho.solvers.rpie")

# tests/operators/test_ptycho.py's operator geometry
NZ, N, P, DET, B, M = 60, 65, 16, 24, 11, 3
OPTICS = dict(
    probe_wavelength=1.4e-10,
    probe_FOV_lengths=(1e-6, 1e-6),
    multislice_propagation_distance=5e-8,
)
TOL = H.SLICE_TOL


def _close(got, want, tol=TOL):
    H.assert_close(got, want, rtol=tol, atol=tol, scale=True)


def _configs(nslices, detector=DET, nz=NZ, n=N):
    kw = dict(probe_shape=P, detector_shape=detector, nz=nz, n=n, nslices=nslices, **OPTICS)
    return jops.PtychoConfig(**kw), tops.PtychoConfig(**kw)


def _operator_inputs(nslices, seed=0):
    gen = H.rng(seed)
    psi = (0.8 + 0.2 * H.crandn(gen, nslices, NZ, N)).astype(np.complex64)
    probe = H.crandn(gen, 1, M, P, P)
    scan = np.stack(
        [gen.uniform(1, NZ - P - 2, B), gen.uniform(1, N - P - 2, B)], -1
    ).astype(np.float32)
    far = H.crandn(gen, B, M, DET, DET)
    return psi, probe, scan, far


@pytest.mark.parametrize("nslices", [1, 2, 3])
def test_multislice_fwd_matches_jax(nslices):
    jc, tc = _configs(nslices)
    psi, probe, scan, _ = _operator_inputs(nslices)
    want = jops.multislice_fwd(jc, jnp.asarray(psi), jnp.asarray(scan), jnp.asarray(probe))
    got = tops.multislice_fwd(tc, H.t(psi), H.t(scan), H.t(probe))
    assert len(got) == 2
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


def test_ptycho_fwd_with_probes_matches_jax():
    jc, tc = _configs(3)
    psi, probe, scan, _ = _operator_inputs(3, seed=1)
    want = jops.ptycho_fwd_with_probes(jc, jnp.asarray(psi), jnp.asarray(scan), jnp.asarray(probe))
    got = tops.ptycho_fwd_with_probes(tc, H.t(psi), H.t(scan), H.t(probe))
    for g, w in zip(got, want):
        _close(g, w)


def _inner(a, b) -> complex:
    return complex(torch.sum(a * b.conj()))


@pytest.mark.parametrize("nslices", [1, 3])
def test_ptycho_adj_matches_jax(nslices):
    """Both gradients against tike_tpu's, and the adjointness of
    tests/operators/test_ptycho.py:49-90 in the port: in the probe at any
    depth (the forward is linear in the probe), in psi at one slice."""
    jc, tc = _configs(nslices)
    psi, probe, scan, far = _operator_inputs(nslices, seed=2)
    want = jops.ptycho_adj(jc, jnp.asarray(far), jnp.asarray(probe), jnp.asarray(scan), jnp.asarray(psi))
    got = tops.ptycho_adj(tc, H.t(far), H.t(probe), H.t(scan), H.t(psi))
    for g, w, shape in zip(got, want, (psi.shape, probe.shape)):
        assert tuple(g.shape) == shape
        _close(g, w)
    f = tops.ptycho_fwd(tc, H.t(psi), H.t(scan), H.t(probe))
    a = _inner(f, H.t(far))
    b = _inner(H.t(probe), got[1])
    assert abs(a - b) <= 1e-4 * abs(a), (a, b)
    if nslices == 1:
        b = _inner(H.t(psi), got[0])
        assert abs(a - b) <= 1e-4 * abs(a), (a, b)


def test_single_slice_forward_is_the_direct_product():
    """The single-slice forward of the LSQML path is the nslices = 1 case
    of the general one, bit for bit."""
    _, tc = _configs(1)
    psi, probe, scan, _ = _operator_inputs(1, seed=3)
    from tike_tpu_torch.ops.patch import patch_fwd
    from tike_tpu_torch.ops.propagation import propagation_fwd

    patches = patch_fwd(H.t(psi)[0], H.t(scan), P)
    direct = propagation_fwd(tops._pad_to_detector(patches[:, None] * H.t(probe), tc))
    np.testing.assert_array_equal(H.n(tops.ptycho_fwd(tc, H.t(psi), H.t(scan), H.t(probe))), H.n(direct))


@pytest.fixture(scope="module")
def batch_inputs():
    """One padded batch of 3-mode data on a 3-slice object."""
    gen = H.rng(20)
    h, npos = 64, 30
    scan = H.positions(gen, npos, h, h, P)
    psi = (0.9 + 0.1 * H.crandn(gen, 3, h, h)).astype(np.complex64)
    probe = H.crandn(gen, 1, 1, M, P, P)
    data = np.abs(H.crandn(gen, npos, DET, DET)) ** 2
    idx = np.arange(24, dtype=np.int32)
    idx[20:] = idx[0]
    mask = (np.arange(24) < 20).astype(np.float32)
    mp = gen.random((DET, DET)) > 0.1
    eig = (0.1 * H.crandn(gen, 1, 1, M, P, P)).astype(np.complex64)
    weights = np.zeros((npos, 2, M), np.float32)
    weights[:, 0] = 1
    weights[:, 1] = gen.uniform(-0.5, 0.5, (npos, M))
    return dict(
        h=h, data=data[idx].astype(np.float32), scan=scan, idx=idx, mask=mask,
        psi=psi, probe=probe, mp=mp, eig=eig, weights=weights,
    )


@pytest.mark.parametrize("nslices, eigen", [(2, False), (3, False), (3, True)])
def test_batch_gradients_multislice_matches_jax(batch_inputs, nslices, eigen):
    b = batch_inputs
    jc, tc = _configs(nslices, nz=b["h"], n=b["h"])
    eig = b["eig"] if eigen else None
    weights = b["weights"] if eigen else None
    args = [b["data"], b["scan"], b["idx"], b["mask"], b["psi"][:nslices], b["probe"],
            eig, weights, b["mp"]]
    kw = dict(noise_model="gaussian", steplength_usemodes="all_modes", recover_probe=True)
    want = jax.jit(jrpie._batch_gradients_math, static_argnums=0, static_argnames=tuple(kw))(
        jc, *[None if a is None else jnp.asarray(a) for a in args], 0.5, 0.5, 1.0, **kw
    )
    targs = [None if a is None else H.t(a) for a in args]
    targs[2] = targs[2].long()
    got = trpie._batch_gradients_math(tc, *targs, 0.5, 0.5, 1.0, **kw)
    assert tuple(got[1].shape) == (nslices, b["h"], b["h"])
    assert tuple(got[2].shape) == (nslices, 1, 1, M, P, P)
    for g, w in zip(got, want):
        if w is None:
            assert g is None and not eigen
            continue
        _close(g, w)


@pytest.fixture(scope="module")
def precond_inputs():
    gen = H.rng(21)
    psi = (0.9 + 0.1 * H.crandn(gen, 3, NZ, N)).astype(np.complex64)
    probe = H.crandn(gen, 1, 1, 2, P, P)
    scan = np.stack(
        [gen.uniform(2, NZ - P - 3, 40), gen.uniform(2, N - P - 3, 40)], -1
    ).astype(np.float32)
    w = (gen.random(40) > 0.2).astype(np.float32)
    return psi, probe, scan, w


def _check_precond(got, want):
    H.assert_close(got, want, rtol=1e-4, atol=1e-5, scale=True)


def test_psi_precond_multislice_matches_jax(precond_inputs):
    psi, probe, scan, w = precond_inputs
    jc, tc = _configs(3)
    want = jax.jit(jpre._psi_precond_math, static_argnums=0)(
        jc, *(jnp.asarray(a) for a in (psi, scan, probe, w))
    )
    got = tpre._psi_precond_math(tc, *(H.t(a) for a in (psi, scan, probe, w)))
    assert tuple(got.shape) == (3, NZ, N)
    _check_precond(got, want)


def test_probe_precond_multislice_matches_jax(precond_inputs):
    psi, _, scan, w = precond_inputs
    jc, tc = _configs(3)
    want = jax.jit(jpre._probe_precond_math, static_argnums=0)(
        jc, *(jnp.asarray(a) for a in (psi, scan, w))
    )
    got = tpre._probe_precond_math(tc, *(H.t(a) for a in (psi, scan, w)))
    assert tuple(got.shape) == (3, P, P)
    _check_precond(got, want)


def test_fft_preconditioners_stay_single_slice(precond_inputs):
    """The FFT formulation is single-slice, as in the JAX package, whose
    epochs take the gather one for several slices."""
    psi, probe, scan, w = precond_inputs
    _, tc = _configs(3)
    with pytest.raises(ValueError, match="single-slice"):
        tpre._psi_precond_fft_math(tc, H.t(scan), H.t(probe), H.t(w))
    with pytest.raises(ValueError, match="single-slice"):
        tpre._probe_precond_fft_math(tc, H.t(psi), H.t(scan), H.t(w))
