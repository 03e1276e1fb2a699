"""Multislice rPIE through ``Reconstruction`` in the port against tike_tpu
on the CPU.

The whole slice runs ``Reconstruction`` with rPIE for 3 epochs from the
same ``random_seed`` on both sides, the parameters carried from a
``tike_tpu`` PtychoParameters by ``convert.parameters_from_jax``:

- from a perturbed object and a random-phase probe, costs and fields agree
  to ``_torch_parity.SLICE_TOL`` (1e-5);
- on the reference test's own problem (``tests/ptycho/
  test_multislice_recon.py``: a constant 0.9 object and a smooth Gaussian
  probe), many far-field pixels are near 0, where the Gaussian gradient is
  the phase of FFT rounding noise, so a one-ulp change of the start moves
  ``tike_tpu`` itself far beyond 1e-5 after 3 epochs. The port is held
  within twice that move, measured in the test (``-s`` prints both: 6.1e-3,
  2.6e-3 and 6.7e-5 for psi, the probe and the costs against the port's
  5.0e-3, 2.1e-3 and 9.7e-5).
"""

import numpy as np
import pytest

import chip_smoke
import tike_tpu.ptycho as jp

import tike_tpu_torch.ptycho as tp
from tike_tpu_torch import convert

from . import _torch_parity as H

P = 16
TOL = H.SLICE_TOL


def _close(got, want, tol=TOL):
    H.assert_close(got, want, rtol=tol, atol=tol, scale=True)


WAVELENGTH, FOV, DISTANCE = (
    chip_smoke.MULTISLICE_OPTICS[k]
    for k in ("probe_wavelength", "probe_FOV_lengths", "multislice_propagation_distance")
)


@pytest.fixture(scope="module")
def reference_problem():
    """tests/ptycho/test_multislice_recon.py's problem (``chip_smoke.py``
    phase 18a builds it): 2 slices of 96^2, 120 positions of a 16^2
    Gaussian probe, simulated by tike_tpu."""
    scan, psi, probe = chip_smoke.multislice_reference_problem()
    optics = dict(
        probe_wavelength=WAVELENGTH, probe_FOV_lengths=FOV,
        multislice_propagation_distance=DISTANCE,
    )
    data = np.asarray(jp.simulate(probe.shape[-1], probe, scan, psi, **optics))
    return psi, probe, scan, data.astype(np.float32), optics


def test_simulate_matches_jax(reference_problem):
    psi, probe, scan, data, optics = reference_problem
    got = tp.simulate(probe.shape[-1], probe, scan, psi, device="cpu", **optics)
    H.assert_close(got, data, rtol=1e-5, atol=1e-5, scale=True)


def _jax_parameters(psi0, probe, scan, num_iter=3, distance=DISTANCE):
    return jp.PtychoParameters(
        probe=probe.copy(),
        psi=psi0.copy(),
        scan=scan,
        algorithm_options=jp.RpieOptions(num_batch=3, num_iter=num_iter),
        object_options=jp.ObjectOptions(multislice_propagation_distance=distance),
        probe_options=jp.ProbeOptions(probe_wavelength=WAVELENGTH, probe_FOV_lengths=FOV),
    )


def test_parameters_from_jax_carry_multislice():
    gen = H.rng(22)
    psi = H.crandn(gen, 3, 40, 40)
    jparams = _jax_parameters(psi, H.crandn(gen, 1, 1, 1, P, P), H.positions(gen, 5, 40, 40, P),
                              distance=3e-8)
    got = convert.parameters_from_jax(jparams)
    np.testing.assert_array_equal(got.psi, psi)
    assert got.object_options.multislice_propagation_distance == 3e-8
    assert got.probe_options.probe_wavelength == WAVELENGTH
    assert tuple(got.probe_options.probe_FOV_lengths) == FOV
    with tp.Reconstruction(
        np.ones((5, P, P), np.float32), got, device="cpu", random_seed=0
    ) as context:
        cfg = context.operator
    assert (cfg.nslices, cfg.multislice_propagation_distance, cfg.probe_wavelength) == (
        3, 3e-8, WAVELENGTH
    )
    assert tuple(cfg.probe_FOV_lengths) == FOV


def _run_both(data, jparams, epochs=3):
    with jp.Reconstruction(data, jparams, random_seed=0) as context:
        assert context._fused_eligible()
        context.iterate(epochs)
        want = convert.parameters_to_numpy(context.get_result())
    params = convert.parameters_from_jax(jparams)
    with tp.Reconstruction(data, params, device="cpu", random_seed=0) as context:
        assert context._fused_eligible()
        assert not context._make_plan().fft_precond
        context.iterate(epochs)
        got = convert.parameters_to_numpy(context.get_result())
    return got, want


def test_rpie_multislice_slice_matches_jax(reference_problem):
    """From a perturbed object and a random-phase probe: 1e-5."""
    psi, probe, scan, data, _ = reference_problem
    gen = H.rng(3)
    psi0 = (0.9 + 0.05 * H.crandn(gen, *psi.shape)).astype(np.complex64)
    probe0 = (np.abs(probe) * np.exp(1j * gen.uniform(-np.pi, np.pi, probe.shape))).astype(
        np.complex64
    )
    got, want = _run_both(data, _jax_parameters(psi0, probe0, scan))
    assert got["psi"].shape == psi.shape
    for key in ("psi", "probe"):
        _close(got[key], want[key])
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=TOL)


def _gaps(got, want) -> dict:
    """psi's and the probe's largest difference relative to the largest
    value, and the costs' largest relative difference."""
    out = {k: float(np.max(np.abs(got[k] - want[k])) / np.max(np.abs(want[k])))
           for k in ("psi", "probe")}
    out["costs"] = float(np.max(np.abs(np.asarray(got["costs"]) / np.asarray(want["costs"]) - 1)))
    return out


def test_rpie_multislice_reference_problem(reference_problem):
    """The reference test's start, held within twice tike_tpu's own move
    under a one-ulp change of that start (module docstring); then its
    convergence assertion over its 6 epochs, in the port alone."""
    psi, probe, scan, data, _ = reference_problem
    start = np.full_like(psi, 0.9)
    got, want = _run_both(data, _jax_parameters(start, probe, scan))
    with jp.Reconstruction(
        data, _jax_parameters(H.one_ulp(H.rng(5), start), probe, scan), random_seed=0
    ) as context:
        context.iterate(3)
        moved = convert.parameters_to_numpy(context.get_result())
    port, ulp = _gaps(got, want), _gaps(moved, want)
    print(f"port against tike_tpu {port}; tike_tpu under a one-ulp start {ulp}")
    for key in port:
        assert port[key] <= 2 * ulp[key], (key, port, ulp)

    params = convert.parameters_from_jax(_jax_parameters(start, probe, scan, num_iter=6))
    result = tp.reconstruct(data, params, device="cpu")
    costs = [c[0] for c in result.algorithm_options.costs]
    assert np.all(np.isfinite(costs)), costs
    assert costs[-1] < 0.5 * costs[0], costs
    assert result.psi.shape == psi.shape
