"""One LSQML mini-batch of the port against tike_tpu's ``_lstsq_batch_math``.

Same seeded state into both: random object and probe (so the far field has
no near-zero pixels, see ``_torch_parity.slice_inputs``), measured data from
another object, a padded batch with masked slots, and the gather psi
preconditioner. Every returned array agrees to 1e-5 relative to its
largest magnitude: the two differ only in float32 summation order and FFT
library.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tike_tpu.ops.ptycho import PtychoConfig as JConfig
from tike_tpu.ptycho.solvers import lstsq as jlstsq
from tike_tpu.ptycho.solvers.rpie import _masked_mean_each_pattern
from tike_tpu.ptycho.solvers._preconditioner import _psi_precond_math

from tike_tpu_torch.ops import objective as tobj
from tike_tpu_torch.ops.ptycho import PtychoConfig as TConfig
from tike_tpu_torch.ops.ptycho import simulate_intensity
from tike_tpu_torch.ptycho.solvers import lstsq as tlstsq

from . import _torch_parity as H

Hh, P, DET, N, B = 96, 16, 24, 60, 25


@pytest.fixture(scope="module")
def state():
    gen = H.rng(11)
    psi = (0.5 + 0.1 * H.crandn(gen, 1, Hh, Hh)).astype(np.complex64)
    probe = H.crandn(gen, 1, 1, 1, P, P)
    scan = H.positions(gen, N, Hh, Hh, P)
    idx = gen.permutation(N)[:B].astype(np.int32)
    bmask = np.ones(B, np.float32)
    bmask[-4:] = 0
    data = gen.uniform(0.0, 2.0, (B, DET, DET)).astype(np.float32)
    mp = np.ones((DET, DET), bool)
    mp[0, :3] = False  # a few unmeasured pixels
    kw = dict(probe_shape=P, detector_shape=DET, nz=Hh, n=Hh)
    jc, tc = JConfig(**kw), TConfig(**kw)
    pre = np.asarray(
        _psi_precond_math(jc, jnp.asarray(psi), jnp.asarray(scan), jnp.asarray(probe))
    )
    arrays = (data, scan, idx, bmask, psi, probe)
    return jc, tc, arrays, mp, pre


@pytest.mark.parametrize(
    "recover_psi, recover_probe", [(True, True), (True, False), (False, True)]
)
def test_lstsq_batch_matches_jax(state, recover_psi, recover_probe):
    jc, tc, arrays, mp, pre = state
    kw = dict(
        num_batch=3.0,
        noise_model="gaussian",
        steplength_usemodes="all_modes",
        recover_psi=recover_psi,
        recover_probe=recover_probe,
        recover_positions=False,
    )
    want = jlstsq._lstsq_batch_math(
        jc, *map(jnp.asarray, arrays), None, None, jnp.asarray(mp),
        jnp.asarray(pre), 0.5, 0.5, 0.8, **kw,
    )
    targs = [H.t(a) for a in arrays]
    targs[2] = targs[2].long()
    got = tlstsq._lstsq_batch_math(
        tc, *targs, None, None, H.t(mp), H.t(pre), 0.5, 0.5, 0.8, **kw
    )
    assert sorted(got) == sorted(want)
    for key in want:
        H.assert_close(got[key], want[key], rtol=1e-5, atol=1e-5, scale=True)


def test_precondition_object_update_matches_jax():
    gen = H.rng(12)
    upd = H.crandn(gen, 1, 40, 30)
    pre = gen.uniform(0, 3, (1, 40, 30)).astype(np.float32)
    H.assert_close(
        tlstsq._precondition_object_update(H.t(upd), H.t(pre)),
        jlstsq._precondition_object_update(jnp.asarray(upd), jnp.asarray(pre)),
        rtol=1e-6,
    )


def test_masked_mean_each_pattern_matches_jax():
    gen = H.rng(13)
    elem = gen.uniform(0, 1, (6, 12, 12)).astype(np.float32)
    mask = gen.random((12, 12)) > 0.3
    H.assert_close(
        tobj._masked_mean_each_pattern(H.t(elem), H.t(mask)),
        _masked_mean_each_pattern(jnp.asarray(elem), jnp.asarray(mask)),
        rtol=1e-6,
    )


@pytest.mark.parametrize(
    "change, match",
    [
        pytest.param(dict(eigen_probe=True), "all_modes", id="change0-eigen"),
        pytest.param(dict(recover_positions=True), "dominant_mode", id="change1-position"),
        pytest.param(dict(), "all_modes", id="change2-poisson"),
    ],
)
def test_unported_options_raise(state, change, match):
    """The Poisson step, which used to raise, matches tike_tpu's: alone,
    with eigen probes and weights, and with position correction on, in
    both step-length modes (``match``).

    The data is the model's own intensity times 0.8-1.2 noise: with
    ``state``'s data, which is unrelated to the model, ``1 - data /
    intensity`` is large where the modeled intensity is small, and float32
    FFT rounding there moves the object update by ~3e-5.
    """
    jc, tc, arrays, mp, pre = state
    data, scan, idx, _, psi, probe = arrays
    model = simulate_intensity(tc, H.t(psi), H.t(scan[idx]), H.t(probe[0]))
    noise = H.rng(14).uniform(0.8, 1.2, data.shape).astype(np.float32)
    arrays = (H.n(model) * noise, *arrays[1:])
    targs = [H.t(a) for a in arrays]
    targs[2] = targs[2].long()
    kw = dict(
        eigen_probe=False,
        num_batch=3.0,
        noise_model="poisson",
        steplength_usemodes=match,
        recover_psi=True,
        recover_probe=True,
        recover_positions=False,
    )
    kw.update(change)
    eigen, weights = None, None
    if kw.pop("eigen_probe"):
        eigen = np.zeros((1, 1, 1, P, P), np.complex64)
        weights = np.ones((N, 2, 1), np.float32)
    want = jlstsq._lstsq_batch_math(
        jc, *map(jnp.asarray, arrays),
        None if eigen is None else jnp.asarray(eigen),
        None if weights is None else jnp.asarray(weights),
        jnp.asarray(mp), jnp.asarray(pre), 0.5, 0.5, 0.8, **kw,
    )
    got = tlstsq._lstsq_batch_math(
        tc, *targs,
        None if eigen is None else H.t(eigen),
        None if weights is None else H.t(weights),
        H.t(mp), H.t(pre), 0.5, 0.5, 0.8, **kw,
    )
    assert sorted(got) == sorted(want)
    for key in want:
        if want[key] is None:
            assert got[key] is None
            continue
        H.assert_close(got[key], want[key], rtol=1e-5, atol=1e-5, scale=True)
