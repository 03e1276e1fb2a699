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

from tike_tpu_torch.ops.ptycho import PtychoConfig as TConfig
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
        tlstsq._masked_mean_each_pattern(H.t(elem), H.t(mask)),
        _masked_mean_each_pattern(jnp.asarray(elem), jnp.asarray(mask)),
        rtol=1e-6,
    )


@pytest.mark.parametrize(
    "change, match",
    [
        (dict(eigen_probe=torch.zeros(1)), "eigen"),
        (dict(recover_positions=True), "position"),
        (dict(noise_model="poisson"), "poisson"),
    ],
)
def test_unported_options_raise(state, change, match):
    _, tc, arrays, mp, pre = state
    targs = [H.t(a) for a in arrays]
    targs[2] = targs[2].long()
    kw = dict(
        eigen_probe=None,
        num_batch=3.0,
        noise_model="gaussian",
        steplength_usemodes="all_modes",
        recover_psi=True,
        recover_probe=True,
        recover_positions=False,
    )
    kw.update(change)
    eigen = kw.pop("eigen_probe")
    with pytest.raises(NotImplementedError, match=match):
        tlstsq._lstsq_batch_math(
            tc, *targs, eigen, None, H.t(mp), H.t(pre), 0.5, 0.5, 1.0, **kw
        )
