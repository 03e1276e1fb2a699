"""Multigrid, resampling, fly scans and the eigen-probe constraint of the
port against tike_tpu's, on the CPU.

The resize helpers are host numpy and scipy in both packages, copied, so
they and ``PtychoParameters.resample`` agree bit for bit. Multigrid runs
the same reconstruction at each level: with the Lanczos probe resize it
agrees at 1e-5 (measured 2.2e-6 in psi). With the default Fourier resize
(``_resize_fft``) the upsampled probe's spectrum is zero outside the
coarse band (three quarters of it at 2 levels), so many far-field pixels of
the fine level start near zero, where the Gaussian gradient is the phase of
FFT rounding noise (ROADMAP.md section 3): from one start, one fine epoch
already parts the two packages by 2.3e-5 in psi, and the two-level run by
2.6e-4 (the reference's own psi moves by 6.9e-5 for a one-ulp change of
its start). There the costs are held at 1e-5 and the fields at
``FFT_FIELD_TOL``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tike_tpu.linalg as jla
import tike_tpu.ptycho as jp
import tike_tpu.ptycho.probe as jprobe
import tike_tpu.ptycho.solvers.options as jopts

import tike_tpu_torch.linalg as tla
import tike_tpu_torch.ptycho as tp
import tike_tpu_torch.ptycho.probe as tprobe
import tike_tpu_torch.ptycho.solvers.options as topts
from tike_tpu_torch import convert

from . import _torch_parity as H

TOL = 1e-5
FFT_FIELD_TOL = 5e-4
Hh, P, DET, NPOS = 128, 16, 32, 100
RESIZE = ["_resize_fft", "_resize_linear", "_resize_cubic", "_resize_lanczos"]


@pytest.fixture(scope="module")
def slice_data():
    scan, psi, probe, psi0 = H.slice_inputs(h=Hh, p=P, det=DET, npos=NPOS)
    data = np.asarray(jp.simulate(DET, probe, scan, psi))
    return scan, probe, psi0, data


def _parameters(pkg, scan, probe, psi0, num_batch=1, num_iter=2):
    return pkg.PtychoParameters(
        probe=probe,
        psi=psi0,
        scan=scan,
        algorithm_options=pkg.LstsqOptions(
            num_batch=num_batch, num_iter=num_iter, batch_method="compact"
        ),
        object_options=pkg.ObjectOptions(),
        probe_options=pkg.ProbeOptions(),
        exitwave_options=pkg.ExitWaveOptions(measured_pixels=np.ones((DET, DET), bool)),
    )


@pytest.mark.parametrize("name", RESIZE)
@pytest.mark.parametrize("factor", [0.5, 2.0])
def test_resize_helpers_match_jax(name, factor):
    x = H.crandn(H.rng(1), 1, 2, 3, 16, 16)
    np.testing.assert_array_equal(getattr(topts, name)(x, factor), getattr(jopts, name)(x, factor))
    np.testing.assert_array_equal(
        topts._resize_spline(x, factor), jopts._resize_spline(x, factor)
    )


def test_fourier_crop_and_pad_match_jax_and_keep_tensors_on_their_device():
    x = H.crandn(H.rng(2), 3, 12, 12)
    for w in (4, 7, 12):
        want = jopts.crop_fourier_space(x, w)
        np.testing.assert_array_equal(topts.crop_fourier_space(x, w), want)
        got = topts.crop_fourier_space(torch.as_tensor(x), w)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        topts.pad_fourier_space(x, 20), jopts.pad_fourier_space(x, 20)
    )


def test_resample_matches_jax(slice_data):
    """Every array bit for bit; the moments reset (probe and object
    options: none; positions: zeros); the algorithm options passed on as
    the same object; the detector mask cropped."""
    scan, probe, psi0, _ = slice_data
    eig, weights = H.bench_eigen(probe, len(scan))
    jparams = _parameters(jp, scan, probe, psi0)
    jparams.eigen_probe, jparams.eigen_weights = eig, weights
    jparams.object_options = jp.ObjectOptions(use_adaptive_moment=True)
    jparams.probe_options = jp.ProbeOptions(use_adaptive_moment=True)
    jparams.position_options = jp.PositionOptions(
        initial_scan=scan, use_adaptive_moment=True,
        transform=jp.AffineTransform(t0=1.5, t1=-2.0),
    )
    jparams.algorithm_options.costs = [[1.0], [0.5]]
    tparams = convert.parameters_from_jax(jparams)
    tparams.object_options.m = torch.ones(3)
    tparams.probe_options.power = [np.ones(1)]
    for factor in (0.5, 2.0):
        want = jparams.resample(factor)
        got = tparams.resample(factor)
        for key in ("probe", "psi", "scan", "eigen_probe", "eigen_weights"):
            np.testing.assert_array_equal(getattr(got, key), np.asarray(getattr(want, key)))
            assert getattr(got, key).dtype == np.asarray(getattr(want, key)).dtype
        assert got.algorithm_options is tparams.algorithm_options
        assert got.object_options.m is None and got.object_options.v is None
        assert got.probe_options.power is tparams.probe_options.power
        np.testing.assert_array_equal(
            got.exitwave_options.measured_pixels, want.exitwave_options.measured_pixels
        )
        gp, wp = got.position_options, want.position_options
        np.testing.assert_array_equal(gp.initial_scan, wp.initial_scan)
        np.testing.assert_array_equal(gp._momentum, wp._momentum)
        assert gp.transform.astuple() == wp.transform.astuple()
        np.testing.assert_array_equal(gp.origin, wp.origin)


@pytest.mark.parametrize("interp", ["_resize_lanczos", None], ids=["lanczos", "fft"])
def test_reconstruct_multigrid_matches_jax(slice_data, interp):
    """Two levels (16^2 then 32^2 patterns), 2 LSQML epochs each, one
    batch, so the reference's unseeded clustering draws nothing."""
    scan, probe, psi0, data = slice_data
    jparams = _parameters(jp, scan, probe, psi0)
    tparams = convert.parameters_from_jax(jparams)
    with pytest.warns(UserWarning, match="64 pixels"):
        want = jp.reconstruct_multigrid(
            data, jparams, num_levels=2, interp=interp and getattr(jopts, interp)
        )
    with pytest.warns(UserWarning, match="64 pixels"):
        got = tp.reconstruct_multigrid(
            data, tparams, num_levels=2, interp=interp and getattr(topts, interp),
            device="cpu",
        )
    got, want = convert.parameters_to_numpy(got), convert.parameters_to_numpy(want)
    assert len(got["costs"]) == 4 and np.all(np.isfinite(got["costs"]))
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=TOL)
    tol = TOL if interp else FFT_FIELD_TOL
    for key in ("psi", "probe", "scan"):
        H.assert_close(got[key], want[key], rtol=tol, atol=tol, scale=True)
    assert got["psi"].shape == psi0.shape and got["probe"].shape == probe.shape


def test_multigrid_levels_compose_with_a_seed(slice_data):
    """``num_batch=3`` with seeded batches: the port's
    ``reconstruct_multigrid(random_seed=0)`` equals its own level-by-level
    composition bit for bit, and that composition, done in tike_tpu with the
    same seed, at 1e-5 (Lanczos resize)."""
    scan, probe, psi0, data = slice_data
    interp = (jopts._resize_lanczos, topts._resize_lanczos)
    out = []
    for pkg, resize, kw in ((jp, interp[0], {}), (tp, interp[1], dict(device="cpu"))):
        params = _parameters(pkg, scan, probe, psi0, num_batch=3)
        if pkg is tp:
            params = convert.parameters_from_jax(params)
        params = params.resample(0.5, resize)
        for level in (1, 0):
            level_data = data if level == 0 else jopts.crop_fourier_space(data, DET // 2)
            with pkg.Reconstruction(level_data, params, random_seed=0, **kw) as context:
                context.iterate(params.algorithm_options.num_iter)
                result = context.get_result()
            params = result.resample(2.0, resize) if level else result
        out.append(convert.parameters_to_numpy(params))
    want, got = out
    with pytest.warns(UserWarning, match="64 pixels"):
        direct = tp.reconstruct_multigrid(
            data, convert.parameters_from_jax(_parameters(jp, scan, probe, psi0, num_batch=3)),
            num_levels=2, interp=interp[1], device="cpu", random_seed=0,
        )
    direct = convert.parameters_to_numpy(direct)
    for key in ("psi", "probe", "scan"):
        np.testing.assert_array_equal(direct[key], got[key])
        H.assert_close(got[key], want[key], rtol=TOL, atol=TOL, scale=True)
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=TOL)


def test_multigrid_refuses_what_is_not_ported(slice_data, monkeypatch):
    """Before any level runs: the striped object without a mesh
    (``ValueError``, as in tike_tpu), and a mesh that is not the port's;
    and as its level opens, on a mesh across the processes of a process
    group, a data block that is not this process's stripe."""
    import tike_tpu_torch.parallel as tpar

    scan, probe, psi0, data = slice_data
    params = _parameters(tp, scan, probe, psi0)
    for kw in (dict(num_gpu=2), dict(use_mpi=True), dict()):
        with pytest.raises(ValueError, match="requires a mesh"):
            tp.reconstruct_multigrid(data, params, device="cpu", object_sharding="striped", **kw)
    with monkeypatch.context() as m:
        m.setattr(torch.distributed, "is_initialized", lambda: True)
        m.setattr(torch.distributed, "get_world_size", lambda *a: 2)
        m.setattr(torch.distributed, "get_rank", lambda *a: 0)
        with pytest.raises(ValueError, match="this process's stripe"):
            tp.reconstruct_multigrid(data[:5], params, device="cpu", num_levels=1,
                                     mesh=tpar.Mesh(["cpu", tpar.Remote(1, "cpu")]))
    with pytest.raises(TypeError, match="parallel.Mesh"):
        tp.reconstruct_multigrid(data, params, device="cpu", mesh=object())
    assert params.psi is psi0  # nothing resampled or run


def test_multigrid_keeps_tensor_data_a_tensor(slice_data, monkeypatch):
    """Data given as a tensor is cropped by indexing, level by level, and
    reaches each level's Reconstruction as a tensor on its device."""
    scan, probe, psi0, data = slice_data
    seen = []
    enter = tp.Reconstruction.__init__

    def spy(self, data, *args, **kwargs):
        seen.append((type(data), tuple(data.shape)))
        enter(self, data, *args, **kwargs)

    monkeypatch.setattr(tp.Reconstruction, "__init__", spy)
    params = _parameters(tp, scan, probe, psi0, num_iter=1)
    with pytest.warns(UserWarning):
        tp.reconstruct_multigrid(torch.as_tensor(data), params, num_levels=2, device="cpu")
    assert seen == [(torch.Tensor, (NPOS, 16, 16)), (torch.Tensor, (NPOS, DET, DET))]


@pytest.mark.parametrize("fly", [2, 5])
def test_simulate_fly_scan_matches_jax(slice_data, fly):
    """Each group of ``fly`` consecutive positions is one exposure: their
    intensities are summed."""
    scan, probe, psi0, _ = slice_data
    want = np.asarray(jp.simulate(DET, probe, scan, psi0, fly=fly))
    got = tp.simulate(DET, probe, scan, psi0, fly=fly, device="cpu")
    assert got.shape == (NPOS // fly, DET, DET) == want.shape
    H.assert_close(got, want, rtol=TOL, atol=TOL, scale=True)
    single = tp.simulate(DET, probe, scan, psi0, device="cpu")
    np.testing.assert_allclose(
        got, single.reshape(NPOS // fly, fly, DET, DET).sum(1), rtol=1e-6
    )


def _eigen_state(seed, npos=40, eigen=3, shared=2, p=8, tie=False):
    gen = H.rng(seed)
    eig = H.crandn(gen, 1, eigen, shared, p, p) * np.float32(0.3)
    weights = gen.standard_normal((npos, eigen + 1, shared)).astype(np.float32)
    weights[3, 1, 0] = 40.0  # an outlier
    if tie:
        weights[:, 2, :] = weights[:, 1, :]
        eig[:, 1] = eig[:, 0]
    return eig.astype(np.complex64), weights


@pytest.mark.parametrize("tie", [False, True])
def test_constrain_variable_probe_matches_jax(tie):
    """Normalized, orthogonalized, sorted by energy per mode (ties in
    numpy's argsort order), outliers clipped at 1.5 x the 95th
    percentile."""
    eig, weights = _eigen_state(4, tie=tie)
    want = jprobe.constrain_variable_probe(jnp.asarray(eig), jnp.asarray(weights))
    got = tprobe.constrain_variable_probe(torch.as_tensor(eig), torch.as_tensor(weights))
    for g, w in zip(got, want):
        H.assert_close(g, w, rtol=TOL, atol=TOL, scale=True)
    assert float(got[1][3, 1, 0]) < 40.0  # the outlier was clipped


def test_linalg_helpers_match_jax():
    gen = H.rng(6)
    x = H.crandn(gen, 2, 4, 5, 6)
    H.assert_close(
        tla.orthogonalize_gs(torch.as_tensor(x), dim=(-2, -1)),
        jla.orthogonalize_gs(x, axis=(-2, -1)), rtol=TOL, atol=TOL, scale=True,
    )
    a = gen.standard_normal((7, 30, 2)).astype(np.float32)
    b = gen.standard_normal((7, 30, 1)).astype(np.float32)
    w = gen.uniform(0.5, 1.5, (7, 30)).astype(np.float32)
    for weights in (None, w):
        H.assert_close(
            tla.lstsq(torch.as_tensor(a), torch.as_tensor(b),
                      None if weights is None else torch.as_tensor(weights)),
            jla.lstsq(a, b, weights), rtol=1e-4, atol=1e-5, scale=True,
        )
