"""The fused path's other options in the port against tike_tpu, on the CPU:
LSQML with non-compact batches, momenta and Poisson noise, rPIE with
Poisson noise and random batches; moment states carried between the
packages; and what still raises.

Slices run as in ``test_torch_rpie.py`` (3 epochs, the same seed, 1e-5 in
costs and fields, 1e-4 in moment states).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import tike_tpu.ptycho as jp
import tike_tpu.ptycho.exitwave as jexitwave

import tike_tpu_torch.ptycho.exitwave as texitwave

import tike_tpu_torch.ptycho as tp
from tike_tpu_torch import convert

from . import _torch_parity as H

Hh, P, DET, NPOS = 160, 16, 24, 120
TOL, MOMENT_TOL = H.SLICE_TOL, H.MOMENT_TOL


def _close(got, want, tol=TOL):
    H.assert_close(got, want, rtol=tol, atol=tol, scale=True)


@pytest.mark.parametrize("usemodes", ["all_modes", "dominant_mode"])
def test_poisson_steplength_matches_jax(usemodes):
    """Both step-length solvers on the same seeded far fields, 1e-6."""
    gen = H.rng(80)
    B, M, D = 5, 3, 12
    farplane = H.crandn(gen, B, 1, M, D, D)
    abs2 = np.abs(farplane) ** 2
    intensity = np.sum(abs2, axis=(1, 2)).astype(np.float32)
    data = (intensity * gen.uniform(0.8, 1.2, intensity.shape)).astype(np.float32)
    xi = (1 - data / (intensity + 1e-9))[:, None, None].astype(np.float32)
    mp = gen.random((D, D)) > 0.1
    step = np.full((B, 1, M, 1, 1), 0.5, np.float32)
    args = (xi, intensity, data, mp, step)
    if usemodes == "all_modes":
        args = (xi, abs2.astype(np.float32), *args[1:])
    fn = f"poisson_steplength_{usemodes}"
    want = getattr(jexitwave, fn)(*map(jnp.asarray, args), 0.5)
    got = getattr(texitwave, fn)(*map(H.t, args), 0.5)
    H.assert_close(got, want, rtol=1e-6, atol=1e-6, scale=True)


@pytest.fixture(scope="module")
def slice_data():
    scan, psi, probe, psi0 = H.opr_inputs(h=Hh, p=P, det=DET, npos=NPOS)
    data = np.asarray(jp.simulate(DET, probe, scan, psi))
    return scan, probe, psi0, data


@pytest.mark.parametrize(
    "case",
    sorted(k for k in H.FUSED_CASES if k.startswith("lstsq")) + ["rpie_poisson", "rpie_random"],
)
def test_slice_matches_jax(slice_data, case):
    H.check_fused_slice(*H.fused_slice(slice_data, case), case)


def test_convert_carries_moments_and_alpha(slice_data):
    """Moment states left by a tike_tpu run and RpieOptions.alpha reach the
    port as numpy; a port run continues from them as tike_tpu does."""
    scan, probe, psi0, data = slice_data
    data = H.fused_case_data(data, "rpie_adam")
    jparams = H.fused_parameters(jp, scan, probe, psi0, "rpie_adam")
    jparams.algorithm_options.alpha = 0.2
    with jp.Reconstruction(data, jparams, random_seed=0) as context:
        context.iterate(1)
        jresult = context.get_result()
    tparams = convert.parameters_from_jax(jresult)
    assert tparams.algorithm_options.alpha == 0.2
    for opts, jopts in (
        (tparams.object_options, jresult.object_options),
        (tparams.probe_options, jresult.probe_options),
    ):
        for name in ("v", "m"):
            value = getattr(opts, name)
            assert isinstance(value, np.ndarray)
            np.testing.assert_array_equal(value, np.asarray(getattr(jopts, name)))
    # One more epoch on each side from the same state.
    with jp.Reconstruction(data, jresult, random_seed=1) as context:
        context.iterate(1)
        want = convert.parameters_to_numpy(context.get_result())
    with tp.Reconstruction(data, tparams, device="cpu", random_seed=1) as context:
        context.iterate(1)
        got = convert.parameters_to_numpy(context.get_result())
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=TOL)
    for key in ("psi", "probe"):
        _close(got[key], want[key])
    for key in ("object_v", "object_m", "probe_v", "probe_m"):
        _close(got[key], want[key], MOMENT_TOL)


def _ported(scan):
    """Options the port refused before rPIE and the fused path's options
    were ported."""
    yield dict(algorithm_options=tp.RpieOptions())
    yield dict(algorithm_options=tp.LstsqOptions())
    yield dict(
        exitwave_options=tp.ExitWaveOptions(
            measured_pixels=np.ones((DET, DET), bool), noise_model="poisson"
        )
    )
    yield dict(probe_options=tp.ProbeOptions(probe_support=0.1, force_orthogonality=True))
    yield dict(
        object_options=tp.ObjectOptions(
            positivity_constraint=0.1, smoothness_constraint=0.01, clip_magnitude=True
        )
    )
    yield dict(
        object_options=tp.ObjectOptions(use_adaptive_moment=True),
        probe_options=tp.ProbeOptions(use_adaptive_moment=True),
    )
    yield dict(
        algorithm_options=tp.LstsqOptions(rescale_method="constant_probe_photons")
    )


@pytest.mark.parametrize("which", range(7))
def test_ported_options_no_longer_raise(slice_data, which):
    scan, probe, psi0, data = slice_data
    kw = dict(
        probe=probe,
        psi=psi0,
        scan=scan,
        algorithm_options=tp.LstsqOptions(batch_method="compact"),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
        exitwave_options=tp.ExitWaveOptions(measured_pixels=np.ones((DET, DET), bool)),
    )
    kw.update(list(_ported(scan))[which])
    with tp.Reconstruction(data, tp.PtychoParameters(**kw), device="cpu") as c:
        assert c._make_plan() is not None
