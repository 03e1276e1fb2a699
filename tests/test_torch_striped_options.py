"""The striped object's solver options against tike_tpu's striped path.

The cases of ``tests/parallel/test_striped.py`` at tier-1 sizes, each on
a mesh of CPU shards against tike_tpu's on ``make_mesh`` of the same
size (the conftest's virtual CPU devices), from the same numpy inputs and
seed, at ``_torch_parity.SLICE_TOL`` (1e-5 of the largest value; the
positions within 1e-4 px): the probe schedule and a fixed probe, a measured-pixels mask, multislice rPIE,
empty stripes, ``constant_probe_photons`` and classical momentum, also
host-streamed.
"""

import numpy as np
import pytest

import tike_tpu.ptycho as jp

import tike_tpu_torch.parallel as tpar
import tike_tpu_torch.ptycho as tp
from tike_tpu_torch import convert

from . import _torch_parity as H
from . import _torch_striped_cases as C


run_both, check = C.run_both, C.check


@pytest.fixture(scope="module")
def one_mode():
    return C.problem(n=128)


def test_striped_probe_schedule_and_fixed_probe(one_mode):
    """``update_start`` past the last epoch and no probe options leave the
    probe as it was in both packages; with recovery on, it moves, as
    tike_tpu's does (rPIE, 2 stripes)."""
    psi, probe, scan, data = one_mode
    for popts in (dict(update_start=5), None, {}):
        jparams = C.parameters(jp, probe, C.start(psi), scan, "rpie", probe_options=popts)
        got, want = run_both(data, jparams, 2, epochs=2)
        check(got, want)
        if popts == {}:
            assert np.max(np.abs(got["probe"] - probe)) > 1e-5
        else:
            np.testing.assert_allclose(got["probe"], probe, atol=1e-6)


def test_striped_measured_pixels_mask(one_mode):
    """A central 4 x 4 beamstop in ``measured_pixels`` (rPIE, 4 stripes)."""
    psi, probe, scan, data = one_mode
    det = data.shape[-1]
    mask = np.ones((det, det), bool)
    mask[det // 2 - 2 : det // 2 + 2, det // 2 - 2 : det // 2 + 2] = False
    jparams = C.parameters(
        jp, probe, C.start(psi), scan, "rpie",
        exitwave_options=jp.ExitWaveOptions(measured_pixels=mask, noise_model="gaussian"),
    )
    got, want = run_both(data, jparams, 4)
    check(got, want)
    assert got["costs"][-1][0] < got["costs"][0][0]


def test_striped_multislice_rpie():
    """A two-slice object with rPIE on 4 stripes: each window carries both
    slices, propagated between them."""
    rng = np.random.default_rng(0)
    p, hw, n = 16, 128, 96
    yy, xx = np.mgrid[0:hw, 0:hw] / hw
    psi = np.stack(
        [
            np.exp(1j * 0.4 * np.sin(5 * yy) * np.cos(3 * xx)),
            np.exp(1j * 0.3 * np.cos(4 * yy * xx * 7)),
        ]
    ).astype(np.complex64)
    g = tp.gaussian(p)
    probe = (g * np.exp(1j * 0.1 * g))[None, None, None].astype(np.complex64)
    scan = np.stack(
        [rng.uniform(2, hw - p - 3, n), rng.uniform(2, hw - p - 3, n)], -1
    ).astype(np.float32)
    optics = dict(probe_wavelength=1.4e-10, probe_FOV_lengths=(1e-6, 1e-6))
    data = tp.simulate(
        p, probe, scan, psi, multislice_propagation_distance=2e-8, device="cpu", **optics
    ).astype(np.float32)
    jparams = jp.PtychoParameters(
        probe=probe.copy(),
        psi=(0.9 + 0.05 * H.crandn(rng, *psi.shape)).astype(np.complex64),
        scan=scan.copy(),
        algorithm_options=jp.RpieOptions(num_batch=2, num_iter=3, batch_method="compact"),
        object_options=jp.ObjectOptions(multislice_propagation_distance=2e-8),
        probe_options=jp.ProbeOptions(init_rescale_from_measurements=False, **optics),
    )
    got, want = run_both(data, jparams, 4)
    check(got, want)
    assert got["psi"].shape == psi.shape


@pytest.mark.parametrize("batch_method", ["compact", "wobbly_center"])
@pytest.mark.parametrize("solver", ["rpie", "lstsq"])
def test_striped_empty_stripes_stay_finite(solver, batch_method):
    """Positions in the top half of a 96-row object on 8 stripes: the
    bottom stripes are empty, weigh 0 in the probe's mean and stay finite;
    both packages agree."""
    rng = np.random.default_rng(0)
    hw, p, npos = 96, 16, 96
    yy, xx = np.mgrid[0:hw, 0:hw] / hw
    psi = np.exp(1j * 0.4 * np.sin(5 * yy) * np.cos(3 * xx)).astype(np.complex64)[None]
    g = tp.gaussian(p)
    probe = (g * np.exp(1j * 0.2 * g))[None, None, None].astype(np.complex64)
    scan = np.stack(
        [rng.uniform(2, hw // 2 - p, npos), rng.uniform(2, hw - p - 3, npos)], -1
    ).astype(np.float32)
    data = tp.simulate(p, probe, scan, psi, device="cpu").astype(np.float32)
    jparams = C.parameters(
        jp, probe, C.start(psi), scan, solver, algo=dict(batch_method=batch_method)
    )
    got, want = run_both(data, jparams, 8, epochs=2)
    for key in ("psi", "probe"):
        assert np.all(np.isfinite(got[key])), key
    check(got, want)


def test_striped_constant_probe_photons(one_mode):
    """``rescale_method='constant_probe_photons'`` every 2 epochs (rPIE, 4
    stripes), and the refusal without ``probe_photons``."""
    psi, probe, scan, data = one_mode
    photons = float(np.sum(np.abs(probe) ** 2))
    jparams = C.parameters(
        jp, probe, C.start(psi), scan, "rpie",
        algo=dict(rescale_method="constant_probe_photons", rescale_period=2, num_iter=4),
        probe_options=dict(probe_photons=photons),
    )
    got, want = run_both(data, jparams, 4, epochs=4)
    check(got, want)
    tparams = convert.parameters_from_jax(
        C.parameters(jp, probe, C.start(psi), scan, "rpie",
                     algo=dict(rescale_method="constant_probe_photons"))
    )
    with pytest.raises(ValueError, match="probe_photons"):
        with tp.Reconstruction(data, tparams, mesh=tpar.make_mesh(devices=["cpu"] * 2),
                               object_sharding="striped", device="cpu"):
            pass


@pytest.mark.parametrize("stream", [False, True])
def test_striped_classical_momentum(one_mode, stream):
    """LSQML with object momentum and wobbly-center batches (classical
    momentum per batch, batch orders drawn per epoch), resident and
    host-streamed, on 4 stripes."""
    psi, probe, scan, data = one_mode
    jparams = C.parameters(
        jp, probe, C.start(psi), scan, "lstsq", algo=dict(batch_method="wobbly_center")
    )
    jparams.object_options = jp.ObjectOptions(use_adaptive_moment=True)
    got, want = run_both(data, jparams, 4, store_data_on_device=not stream)
    check(got, want)
    assert got["costs"][-1][0] < got["costs"][0][0]
