"""The port's multi-mode and eigen-probe (OPR) math against tike_tpu's.

Each test hands the same seeded numpy inputs to the JAX function (on the
CPU) and to its port (on CPU tensors, the plain PyTorch path). Tolerances:
1e-6 relative where the two compute the same few float32 operations in
the same order (the blend, the helpers), 1e-5 relative to the largest
magnitude where sums over a batch or an FFT round differently (measured
below 2e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tike_tpu.linalg as jla
import tike_tpu.opt as jopt
import tike_tpu.ptycho as jp
import tike_tpu.ptycho.probe as jprobe
from tike_tpu.ops.ptycho import PtychoConfig as JConfig
from tike_tpu.ptycho.solvers import lstsq as jlstsq
from tike_tpu.ptycho.solvers._preconditioner import _psi_precond_math

import tike_tpu_torch.ptycho as tp
import tike_tpu_torch.ptycho.probe as tprobe
from tike_tpu_torch import convert, linalg as tla, opt as topt
from tike_tpu_torch.ops.ptycho import PtychoConfig as TConfig
from tike_tpu_torch.ptycho.solvers import lstsq as tlstsq

from . import _torch_parity as H

Hh, P, DET, B = 96, 16, 24, 30


@pytest.mark.parametrize("eigen, modes_with_eigen", [(1, 3), (2, 3), (2, 1), (0, 0)])
def test_get_varying_probe_matches_jax(eigen, modes_with_eigen):
    gen = H.rng(20)
    probe = H.crandn(gen, 1, 1, 3, P, P)
    weights = gen.standard_normal((B, eigen + 1, 3)).astype(np.float32)
    eig = H.crandn(gen, 1, eigen, modes_with_eigen, P, P) if eigen else None
    want = jprobe.get_varying_probe(
        jnp.asarray(probe), None if eig is None else jnp.asarray(eig), jnp.asarray(weights)
    )
    got = tprobe.get_varying_probe(
        H.t(probe), None if eig is None else H.t(eig), H.t(weights)
    )
    assert got.shape == (B, 1, 3, P, P) and got.dtype == torch.complex64
    H.assert_close(got, want, rtol=1e-6, atol=1e-6, scale=True)


def test_get_varying_probe_without_weights_is_the_shared_probe():
    probe = H.t(H.crandn(H.rng(21), 1, 1, 2, P, P))
    assert tprobe.get_varying_probe(probe) is probe


@pytest.mark.parametrize("n_eigen, c", [(1, 1), (2, 1), (2, 2)])
def test_update_eigen_probe_matches_jax(n_eigen, c):
    """With one eigen probe (config 2), and with two: c=1 updates the
    first, c=2 the second (the loop's second pass, after the projection);
    padded slots masked."""
    gen = H.rng(22)
    R = H.crandn(gen, B, 1, 1, P, P)
    eig = H.crandn(gen, 1, n_eigen, 3, P, P)
    weights = gen.standard_normal((B, n_eigen + 1, 3)).astype(np.float32)
    patches = H.crandn(gen, B, 1, 1, P, P)
    diff = H.crandn(gen, B, 1, 3, P, P)
    valid = np.ones(B, np.float32)
    valid[-3:] = 0
    args = (R, eig, weights, patches, diff, valid)
    want = jprobe.update_eigen_probe(*map(jnp.asarray, args), β=0.1, c=c, m=0)
    got = tprobe.update_eigen_probe(*map(H.t, args), β=0.1, c=c, m=0)
    for g, w in zip(got, want):
        H.assert_close(g, w, rtol=1e-5, atol=1e-6, scale=True)
    # Only the updated eigen probe and its weight column move.
    keep = [i for i in range(n_eigen) if i != c - 1]
    np.testing.assert_array_equal(H.n(got[0])[:, keep], eig[:, keep])
    np.testing.assert_array_equal(H.n(got[1])[-3:], weights[-3:])


def test_add_modes_cartesian_hermite_matches_jax():
    _, _, probe, _ = H.slice_inputs()
    want = jprobe.add_modes_cartesian_hermite(probe, 4)
    got = tprobe.add_modes_cartesian_hermite(probe, 4)
    assert got.shape == (1, 1, 4, 16, 16) and got.dtype == np.complex64
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="nmodes"):
        tprobe.add_modes_cartesian_hermite(probe, 0)


def test_add_modes_random_phase_matches_jax():
    _, _, probe, _ = H.slice_inputs()
    want = jprobe.add_modes_random_phase(probe, 3, rng=H.rng(3))
    got = tprobe.add_modes_random_phase(probe, 3, rng=H.rng(3))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_eigen, with_modes", [(3, 2), (1, 1), (0, 1)])
def test_init_varying_probe_matches_jax(num_eigen, with_modes):
    scan, _, probe, _ = H.opr_inputs()
    want = jprobe.init_varying_probe(scan, probe, num_eigen, with_modes, rng=H.rng(4))
    got = tprobe.init_varying_probe(scan, probe, num_eigen, with_modes, rng=H.rng(4))
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        # numpy's float32 mean against XLA's: a few ulps.
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_init_varying_probe_rejects_too_many_modes():
    scan, _, probe, _ = H.opr_inputs()
    with pytest.raises(ValueError, match="probes_with_modes"):
        tprobe.init_varying_probe(scan, probe, 2, 4)


@pytest.mark.parametrize("epoch, want", [(0, False), (2, True), (3, False), (4, True)])
def test_recover_probe_schedule(epoch, want):
    opts = tprobe.ProbeOptions(update_start=2, update_period=2)
    ref = jprobe.ProbeOptions(update_start=2, update_period=2)
    assert opts.recover_probe(epoch) == ref.recover_probe(epoch) == want


@pytest.mark.parametrize("fn", ["norm", "inner", "projection"])
def test_linalg_matches_jax(fn):
    gen = H.rng(23)
    a, b = H.crandn(gen, 4, 5, 6), H.crandn(gen, 4, 5, 6)
    if fn == "norm":
        want = jla.norm(jnp.asarray(a), axis=(-2, -1), keepdims=True)
        got = tla.norm(H.t(a), dim=(-2, -1), keepdim=True)
    elif fn == "inner":
        want = jla.inner(jnp.asarray(a), jnp.asarray(b), axis=-1)
        got = tla.inner(H.t(a), H.t(b), dim=-1)
    else:
        want = jla.projection(jnp.asarray(a), jnp.asarray(b), axis=(-2, -1))
        got = tla.projection(H.t(a), H.t(b), dim=(-2, -1))
    H.assert_close(got, want, rtol=1e-5, atol=1e-6, scale=True)


def test_adam_matches_jax():
    """Three steps from zero moments, as the position step takes them."""
    gen = H.rng(24)
    jv = jm = tv = tm = None
    for _ in range(3):
        g = gen.standard_normal((50, 2)).astype(np.float32)
        jd, jv, jm = jopt.adam(jnp.asarray(g), jv, jm, vdecay=0.99, mdecay=0.8)
        td, tv, tm = topt.adam(H.t(g), tv, tm, vdecay=0.99, mdecay=0.8)
        for got, want in ((td, jd), (tv, jv), (tm, jm)):
            H.assert_close(got, want, rtol=1e-5, atol=1e-6, scale=True)


@pytest.fixture(scope="module")
def batch_state():
    """One mini-batch of config 2 at a small size: 3 shared modes, two
    eigen probes over the first two modes, a padded batch."""
    gen = H.rng(25)
    n = 60
    psi = (0.5 + 0.1 * H.crandn(gen, 1, Hh, Hh)).astype(np.complex64)
    probe = jprobe.add_modes_cartesian_hermite(H.crandn(gen, 1, 1, 1, P, P), 3)
    scan = H.positions(gen, n, Hh, Hh, P)
    eig, weights = jprobe.init_varying_probe(scan, probe, 3, 2, rng=gen)
    weights[:, 1:] += 0.1 * gen.standard_normal(weights[:, 1:].shape).astype(np.float32)
    idx = gen.permutation(n)[:B].astype(np.int32)
    bmask = np.ones(B, np.float32)
    bmask[-4:] = 0
    data = gen.uniform(0.0, 2.0, (B, DET, DET)).astype(np.float32)
    mp = np.ones((DET, DET), bool)
    mp[0, :3] = False
    kw = dict(probe_shape=P, detector_shape=DET, nz=Hh, n=Hh)
    jc, tc = JConfig(**kw), TConfig(**kw)
    pre = np.asarray(
        _psi_precond_math(jc, jnp.asarray(psi), jnp.asarray(scan), jnp.asarray(probe))
    )
    return jc, tc, (data, scan, idx, bmask, psi, probe, eig, weights), mp, pre


@pytest.mark.parametrize("eigen", [True, False])
@pytest.mark.parametrize("recover_positions", [True, False])
def test_lstsq_batch_with_opr_and_positions_matches_jax(
    batch_state, eigen, recover_positions
):
    """Every key of the batch math with eigen weights (with and without
    eigen probes) and position terms on."""
    jc, tc, arrays, mp, pre = batch_state
    arrays = list(arrays)
    if not eigen:
        arrays[6] = None
        arrays[7] = arrays[7][:, :1]
    kw = dict(
        num_batch=3.0,
        noise_model="gaussian",
        steplength_usemodes="all_modes",
        recover_psi=True,
        recover_probe=True,
        recover_positions=recover_positions,
    )
    want = jlstsq._lstsq_batch_math(
        jc,
        *[None if a is None else jnp.asarray(a) for a in arrays],
        jnp.asarray(mp), jnp.asarray(pre), 0.5, 0.5, 0.8, **kw,
    )
    targs = [None if a is None else H.t(a) for a in arrays]
    targs[2] = targs[2].long()
    got = tlstsq._lstsq_batch_math(
        tc, *targs, H.t(mp), H.t(pre), 0.5, 0.5, 0.8, **kw
    )
    assert sorted(got) == sorted(want)
    for key in want:
        if want[key] is None:
            assert got[key] is None, key
            continue
        H.assert_close(got[key], want[key], rtol=1e-5, atol=1e-5, scale=True)
    # Padded slots leave their weight rows untouched.
    np.testing.assert_array_equal(H.n(got["w_b"])[-4:], arrays[7][arrays[2][-4:]])


def _slice_parameters(pkg, scan, probe, psi0, eig, weights, **position):
    return pkg.PtychoParameters(
        probe=probe,
        psi=psi0,
        scan=scan,
        eigen_probe=eig,
        eigen_weights=weights,
        algorithm_options=pkg.LstsqOptions(
            num_batch=3, batch_method="compact", rescale_period=2
        ),
        object_options=pkg.ObjectOptions(),
        probe_options=pkg.ProbeOptions(),
        position_options=pkg.PositionOptions(
            initial_scan=scan, update_magnitude_limit=2.0, **position
        ),
        exitwave_options=pkg.ExitWaveOptions(
            measured_pixels=np.ones((DET, DET), bool)
        ),
    )


def test_padded_batches_update_every_eigen_weight():
    """121 positions in 3 compact batches (41/40/40): two batches carry a
    padded slot that repeats the batch's first position.

    tike_tpu writes the batch's weight rows back with ``.at[idx].set``; the
    padded slot's stale copy is written last and wins, so it drops the OPR
    update of that first position (ROADMAP.md §3). The port writes through
    the real slots only: its first positions move, and every other row,
    and psi, probe, eigen probe and scan, equal tike_tpu's after the epoch.
    """
    scan, psi, probe, psi0 = H.opr_inputs(npos=121)
    data = np.asarray(jp.simulate(DET, probe, scan, psi))
    eig, weights = H.bench_eigen(probe, len(scan))
    jparams = _slice_parameters(jp, scan, probe, psi0, eig, weights)
    tparams = convert.parameters_from_jax(jparams)
    with jp.Reconstruction(data, jparams, random_seed=0) as context:
        context.iterate(1)
        want = convert.parameters_to_numpy(context.get_result())
    with tp.Reconstruction(data, tparams, device="cpu", random_seed=0) as context:
        idx, mask = context.batches
        first = [context.order[i[0]] for i, m in zip(idx, mask) if m.min() == 0]
        context.iterate(1)
        got = convert.parameters_to_numpy(context.get_result())

    assert len(first) == 2, mask.sum(axis=1)
    for i in first:
        np.testing.assert_array_equal(want["eigen_weights"][i], weights[i])
        assert np.all(got["eigen_weights"][i, :, 0] != weights[i, :, 0])
    rest = np.setdiff1d(np.arange(len(scan)), first)
    H.assert_close(
        got["eigen_weights"][rest], want["eigen_weights"][rest],
        rtol=1e-5, atol=1e-5, scale=True,
    )
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=1e-5)
    np.testing.assert_allclose(got["scan"], want["scan"], rtol=0, atol=1e-4)
    for key in ("psi", "probe", "eigen_probe"):
        H.assert_close(got[key], want[key], rtol=1e-5, atol=1e-5, scale=True)


def test_simulate_with_eigen_probe_matches_jax():
    scan, psi, probe, _ = H.opr_inputs()
    eig, weights = jprobe.init_varying_probe(scan, probe, 2, 3, rng=H.rng(6))
    weights[:, 1] = 0.3
    want = np.asarray(jp.simulate(DET, probe, scan, psi, eigen_probe=eig, eigen_weights=weights))
    got = tp.simulate(
        DET, probe, scan, psi, eigen_probe=eig, eigen_weights=weights, device="cpu"
    )
    H.assert_close(got, want, rtol=1e-5, atol=1e-5, scale=True)
