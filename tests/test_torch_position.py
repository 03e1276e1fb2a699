"""The port's position correction against tike_tpu's, and config 2 end to end.

The host-numpy pieces (the affine model, the RANSAC fit, the options'
split and join) get equal seeded generators on both sides and must agree
to float64 rounding. The gradient and the step run on float32 tensors and
agree to 1e-6 relative. The whole slice, ``Reconstruction`` over 3 epochs
with 3 probe modes, eigen weights and position correction, agrees with
tike_tpu's fused path to 1e-5 relative in costs and fields (measured
1.2e-7 to 1.7e-6) and in scan to 1e-4 px, or 5e-4 px with AdaM (measured
1.5e-5 px, and 5.3e-5 to 1.2e-4 px with AdaM, after moves of 2-4 px).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tike_tpu.ptycho as jp
import tike_tpu.ptycho.position as jpos
import tike_tpu.ptycho.solvers.lstsq as jlstsq
import tike_tpu.ptycho.solvers.options as jopts
from tike_tpu.ptycho.probe import get_varying_probe as jax_get_varying_probe

import tike_tpu_torch.ptycho as tp
import tike_tpu_torch.ptycho.position as tpos
import tike_tpu_torch.ptycho.solvers.lstsq as tlstsq
import tike_tpu_torch.ptycho.solvers.options as topts
from tike_tpu_torch import convert

from . import _torch_parity as H

DET = 24


@pytest.mark.parametrize("complex_input", [True, False])
def test_gaussian_gradient_matches_jax(complex_input):
    gen = H.rng(30)
    x = H.crandn(gen, 5, 1, 1, 16, 16)
    if not complex_input:
        x = x.real.copy()
    want = jpos.gaussian_gradient(jnp.asarray(x), sigma=0.333)
    got = tpos.gaussian_gradient(H.t(x), sigma=0.333)
    for g, w in zip(got, want):
        assert g.dtype == H.t(x).dtype
        H.assert_close(g, w, rtol=1e-6, atol=1e-6, scale=True)


def test_gaussian_gradient_wider_kernel_matches_jax():
    """At sigma=1 all five taps and the edge padding are exercised."""
    x = H.rng(31).standard_normal((3, 9, 11)).astype(np.float32)
    want = jpos.gaussian_gradient(jnp.asarray(x), sigma=1.0, truncate=2.0)
    got = tpos.gaussian_gradient(H.t(x), sigma=1.0, truncate=2.0)
    for g, w in zip(got, want):
        H.assert_close(g, w, rtol=1e-6, atol=1e-6, scale=True)


@pytest.mark.parametrize("n", [7, 100, 1000])
def test_trim_mean_matches_jax(n):
    x = H.rng(32).standard_normal((n, 2)).astype(np.float32)
    H.assert_close(
        tlstsq._trim_mean(H.t(x), 0.05, dim=0),
        jlstsq._trim_mean(jnp.asarray(x), 0.05, axis=0),
        rtol=1e-5,
        atol=1e-7,
    )
    assert tlstsq._POS_EDGE == jlstsq._POS_EDGE


def test_affine_transform_matches_jax():
    args = (1.1, 0.9, 0.05, 0.2, 3.0, -2.0)
    x = H.rng(33).uniform(0, 100, (20, 2))
    j, t = jpos.AffineTransform(*args), tpos.AffineTransform(*args)
    np.testing.assert_array_equal(t.asarray3(), j.asarray3())
    np.testing.assert_array_equal(t(x), j(x))
    np.testing.assert_array_equal(t(x, shift=False), j(x, shift=False))
    assert t.resample(2.0).astuple() == j.resample(2.0).astuple()
    assert tpos.AffineTransform.frombuffer(t.asbuffer()) == t
    back = tpos.AffineTransform.fromarray(t.asarray3())
    np.testing.assert_allclose(back.astuple(), args, rtol=1e-6, atol=1e-6)
    assert back.astuple() == jpos.AffineTransform.fromarray(j.asarray3()).astuple()


def _moved_positions(n=200, seed=34):
    gen = H.rng(seed)
    p0 = gen.uniform(10, 150, (n, 2))
    true = tpos.AffineTransform(1.02, 0.98, 0.01, 0.05, 1.5, -0.5)
    p1 = true(p0) + 0.1 * gen.standard_normal((n, 2))
    p1[:10] += 80  # outliers
    return p0, p1


def test_estimate_global_transformation_matches_jax():
    p0, p1 = _moved_positions()
    w = H.rng(35).uniform(0.5, 1.0, len(p0))
    for weights in (None, w):
        jt, jf = jpos.estimate_global_transformation(p0, p1, weights)
        tt, tf = tpos.estimate_global_transformation(p0, p1, weights)
        assert tt.astuple() == jt.astuple() and tf == jf


def test_ransac_with_equal_generators_matches_jax():
    p0, p1 = _moved_positions()
    jt, jf = jpos.estimate_global_transformation_ransac(p0, p1, rng=H.rng(7))
    tt, tf = tpos.estimate_global_transformation_ransac(p0, p1, rng=H.rng(7))
    assert tt.astuple() == jt.astuple() and tf == jf
    # The fit found the model despite the outliers.
    np.testing.assert_allclose(tt.astuple()[:2], (1.02, 0.98), atol=0.01)


@pytest.mark.parametrize("regularize", [False, True])
def test_affine_position_regularization_matches_jax(regularize):
    p0, p1 = _moved_positions()
    p0, p1 = p0.astype(np.float32), p1.astype(np.float32)
    kw = dict(use_position_regularization=regularize, origin=np.array([5.0, 5.0]))
    jout, jopt = jpos.affine_position_regularization(
        p1, jpos.PositionOptions(initial_scan=p0, **kw), rng=H.rng(8)
    )
    tout, topt = tpos.affine_position_regularization(
        torch.tensor(p1), tpos.PositionOptions(initial_scan=p0, **kw), rng=H.rng(8)
    )
    assert isinstance(tout, torch.Tensor) and tout.dtype == torch.float32
    assert topt.transform.astuple() == jopt.transform.astuple()
    np.testing.assert_allclose(H.n(tout), np.asarray(jout), rtol=1e-6, atol=1e-5)
    if not regularize:
        np.testing.assert_array_equal(H.n(tout), p1)


def _position_options(pkg, scan, adam):
    opts = pkg.PositionOptions(
        initial_scan=scan, use_adaptive_moment=adam, update_magnitude_limit=2.0
    )
    if adam:
        opts._momentum[:] = H.rng(36).standard_normal(opts._momentum.shape)
    return opts


@pytest.mark.parametrize("adam", [False, True])
def test_position_options_split_join_and_copies(adam):
    scan = H.positions(H.rng(37), 30, 80, 80, 16)
    order = H.rng(38).permutation(len(scan))
    j = _position_options(jpos, scan, adam).split(order)
    t = _position_options(tpos, scan, adam).split(order)
    t = t.copy_to_device("cpu")
    assert isinstance(t.initial_scan, torch.Tensor)
    t = t.copy_to_host()
    for name in ("initial_scan", "confidence", "_momentum"):
        want, got = getattr(j, name), getattr(t, name)
        if want is None:
            assert got is None
            continue
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    reorder = np.argsort(order)
    jj = jpos.PositionOptions.join([j], reorder)
    tj = tpos.PositionOptions.join([t], reorder)
    np.testing.assert_array_equal(tj.initial_scan, scan)
    np.testing.assert_array_equal(tj.initial_scan, jj.initial_scan)
    if adam:
        np.testing.assert_array_equal(tj.v, jj.v)
        np.testing.assert_array_equal(tj.m, jj.m)
    assert tpos.PositionOptions.join([None], reorder) is None


def test_ptycho_parameters_join_matches_jax():
    """``PtychoParameters.join`` of 1, 2 and 3 parts, each with its own psi,
    against tike_tpu's with the same ``stripe_start``: bit for bit."""
    for n_parts in (1, 2, 3):
        _check_join(n_parts)


def _check_join(n_parts):
    scan, _, probe, psi0 = H.opr_inputs(npos=40)
    eig, weights = H.bench_eigen(probe, len(scan))
    weights[:, 1] = np.arange(len(scan))[:, None]
    order = H.rng(39).permutation(len(scan))
    reorder = np.argsort(order)
    cuts = np.array_split(order, n_parts)
    stripe_start = [0, 50, 97][:n_parts]
    gen = H.rng(40)
    psis = [(psi0 + 0.1 * H.crandn(gen, *psi0.shape)).astype(np.complex64) for _ in cuts]

    def parts(pkg):
        x = pkg.PtychoParameters(
            probe=probe, psi=psi0, scan=scan, eigen_probe=eig, eigen_weights=weights,
            position_options=_position_options(pkg, scan, True),
        )
        out = []
        for cut, psi in zip(cuts, psis):
            part = pkg.PtychoParameters.split(cut, x=x)
            part.psi = psi
            out.append(part)
        return out

    want = jopts.PtychoParameters.join(parts(jp), reorder, stripe_start=stripe_start)
    got = topts.PtychoParameters.join(parts(tp), reorder, stripe_start=stripe_start)
    for key in ("probe", "psi", "scan", "eigen_probe", "eigen_weights"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    np.testing.assert_array_equal(got.eigen_weights, weights)
    np.testing.assert_array_equal(
        got.position_options._momentum, want.position_options._momentum
    )
    if n_parts > 1:
        w = probe.shape[-2] // 2
        np.testing.assert_array_equal(got.psi[:, 50 + w : 97 + w if n_parts > 2 else None],
                                      psis[1][:, 50 + w : 97 + w if n_parts > 2 else None])


@pytest.fixture(scope="module")
def slice_data():
    scan, psi, probe, psi0 = H.opr_inputs()
    data = np.asarray(jp.simulate(DET, probe, scan, psi))
    return scan, probe, psi0, data


def _parameters(pkg, scan, probe, psi0, eigen, adam):
    if eigen:
        eig, weights = H.bench_eigen(probe, len(scan))
    else:
        eig, weights = tp.probe.init_varying_probe(scan, probe, 1, rng=H.rng(9))
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
            initial_scan=scan, update_magnitude_limit=2.0, use_adaptive_moment=adam
        ),
        exitwave_options=pkg.ExitWaveOptions(
            measured_pixels=np.ones((DET, DET), bool)
        ),
    )


def _without_0d_eigen_probe(shared, eigen_probe=None, weights=None):
    """tike_tpu's fused path hands a 0-d placeholder for a missing eigen
    probe to ``get_varying_probe``, which then fails on its shape
    (ROADMAP.md §3); read the placeholder as None."""
    if eigen_probe is not None and eigen_probe.ndim == 0:
        eigen_probe = None
    return jax_get_varying_probe(shared, eigen_probe, weights)


@pytest.mark.parametrize("eigen", [True, False], ids=["eigen_probe", "weights_only"])
@pytest.mark.parametrize("adam", [False, True], ids=["plain", "adam"])
def test_config2_slice_matches_jax(slice_data, monkeypatch, eigen, adam):
    """3 epochs of config 2 at the small size: 120 positions in 3 unpadded
    compact batches, 3 probe modes, eigen weights with or without an eigen
    probe, position correction with or without AdaM."""
    scan, probe, psi0, data = slice_data
    monkeypatch.setattr(jlstsq, "get_varying_probe", _without_0d_eigen_probe)
    jparams = _parameters(jp, scan, probe, psi0, eigen, adam)
    tparams = convert.parameters_from_jax(jparams)
    assert isinstance(tparams.position_options.transform, tpos.AffineTransform)
    with jp.Reconstruction(data, jparams, random_seed=0) as context:
        context.iterate(3)
        jresult = context.get_result()
        want = convert.parameters_to_numpy(jresult)
    with tp.Reconstruction(data, tparams, device="cpu", random_seed=0) as context:
        np.testing.assert_array_equal(context.batches[1], 1.0)
        context.iterate(3)
        tresult = context.get_result()
        got = convert.parameters_to_numpy(tresult)
        np.testing.assert_array_equal(context.get_scan(), got["scan"])
        probes = context.get_probe()

    assert np.all(np.isfinite(got["costs"])) and got["costs"][-1] < got["costs"][0]
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=1e-5)
    # AdaM divides each step by the root of its own second moment: its
    # first step is sign(gradient) px whatever the gradient's size, and
    # later steps keep the gradient's rounding undamped. Measured on the
    # CPU: 1.5e-5 px without AdaM, 5.3e-5 and 1.2e-4 px with it.
    scan_tol = 5e-4 if adam else 1e-4
    np.testing.assert_allclose(got["scan"], want["scan"], rtol=0, atol=scan_tol)
    assert np.max(np.abs(got["scan"] - scan)) > 0.5  # the positions moved
    for key in ("psi", "probe", "eigen_probe", "eigen_weights"):
        if want[key] is None:
            assert got[key] is None and not eigen
            continue
        H.assert_close(got[key], want[key], rtol=1e-5, atol=1e-5, scale=True)
    for got_p, key in zip(probes, ("probe", "eigen_probe", "eigen_weights")):
        if got[key] is None:
            assert got_p is None
        else:
            np.testing.assert_array_equal(got_p, got[key])
    # Position options come back in the user's order, momentum included.
    tpo, jpo = tresult.position_options, jresult.position_options
    np.testing.assert_array_equal(tpo.initial_scan, scan)
    np.testing.assert_array_equal(tpo.confidence, jpo.confidence)
    if adam:
        H.assert_close(tpo._momentum, jpo._momentum, rtol=1e-4, atol=1e-5, scale=True)
    else:
        assert tpo._momentum is None and jpo._momentum is None
    assert tpo.transform != tpos.AffineTransform()


def test_iterate_in_pieces_equals_one_call(slice_data):
    """iterate(1) then iterate(2) carries the eigen state, the positions and
    their AdaM moments as iterate(3) does."""
    scan, probe, psi0, data = slice_data
    results = []
    for pieces in ([3], [1, 2]):
        params = convert.parameters_from_jax(
            _parameters(jp, scan, probe, psi0, True, True)
        )
        with tp.Reconstruction(data, params, device="cpu", random_seed=0) as c:
            for k in pieces:
                c.iterate(k)
            results.append(convert.parameters_to_numpy(c.get_result()))
    for key in ("psi", "scan", "eigen_weights", "eigen_probe", "costs"):
        np.testing.assert_array_equal(results[1][key], results[0][key])


def test_positions_stay_in_the_allowed_window(slice_data):
    """Positions pushed at the edges by a large step limit are clamped to
    check_allowed_positions's window."""
    scan, probe, psi0, data = slice_data
    edge = scan.copy()
    edge[:4] = [[1.0, 1.0], [1.0, 140.5], [140.5, 1.0], [140.99, 140.99]]
    params = _parameters(tp, edge, probe, psi0, True, False)
    params.position_options.update_magnitude_limit = 50.0
    with tp.Reconstruction(data, params, device="cpu", random_seed=0) as c:
        c.iterate(2)
        got = c.get_scan()
    tp.check_allowed_positions(got, psi0, probe.shape)
    assert got.min() >= 1.0 and got.max() <= 160 - 16 - 1 / 256


@pytest.mark.parametrize("which", ["use_position_regularization", "poisson"])
def test_unported_config2_options_raise(slice_data, monkeypatch, which):
    """Config 2 options the port once refused now run. Poisson noise: one
    epoch with a finite cost. Position regularization with an eigen probe
    (the per-epoch path, which constrains the eigen probes every
    probe-recovery epoch): 3 epochs against tike_tpu, costs and fields at
    1e-5, positions at 1e-4 px."""
    scan, probe, psi0, data = slice_data
    if which == "poisson":
        params = _parameters(tp, scan, probe, psi0, True, False)
        params.exitwave_options.noise_model = "poisson"
        with tp.Reconstruction(data, params, device="cpu", random_seed=0) as c:
            c.iterate(1)
            assert np.isfinite(c.get_convergence()[0][-1][0])
        return
    H.seed_jax_position_fit(monkeypatch)
    jparams = _parameters(jp, scan, probe, psi0, True, False)
    jparams.position_options.use_position_regularization = True
    got, want = H.run_both_packages(data, jparams, 3, fused=False)
    H.check_epoch_run(got, want)
    for key in ("eigen_probe", "eigen_weights"):
        H.assert_close(got[key], want[key], rtol=H.SLICE_TOL, atol=H.SLICE_TOL, scale=True)
