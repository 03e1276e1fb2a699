"""The per-epoch path of ``iterate`` in the port against tike_tpu's, on the CPU.

``Reconstruction.iterate`` has two paths in both packages: all epochs of a
call at once (tike_tpu's fused program), or a host loop that per epoch
checks ``time_limit``, runs one solver epoch, fits the affine position
model, records the epoch's own time and asks ``is_converged``. A finite
``time_limit``, ``use_position_regularization``, position options with rPIE
and host streaming take the loop; ``convergence_window`` runs the fused path
in chunks. Each case here asserts that both packages take the same path,
run the same number of epochs, and agree on costs, psi and probe at 1e-5
(measured 1e-7 to 1.5e-6: float32 summation order and the FFT library) and
on the positions at 1e-4 px (measured 8e-6).

tike_tpu's ``iterate`` fits the affine position model with an unseeded
generator; the tests hand it the port's seeded one
(``_torch_parity.seed_jax_position_fit``).
"""

import types

import numpy as np
import pytest

import tike_tpu.constants as jconstants
import tike_tpu.opt as jopt
import tike_tpu.ptycho as jp

import tike_tpu_torch.constants as tconstants
import tike_tpu_torch.opt as topt
import tike_tpu_torch.ptycho as tp
import tike_tpu_torch.ptycho.probe as tprobe

from . import _torch_parity as H

Hh, P, DET, NPOS = 160, 16, 24, 120


@pytest.fixture(scope="module")
def slice_data():
    scan, psi, probe, psi0 = H.slice_inputs(h=Hh, p=P, det=DET, npos=NPOS)
    data = np.asarray(jp.simulate(DET, probe, scan, psi))
    return scan, probe, psi0, data


@pytest.mark.parametrize("name", jconstants.__all__)
def test_constants_equal_jax(name):
    """The port's own copy of the constants module: the same names, the
    same numbers and, for the relations, the same values bit for bit."""
    assert tconstants.__all__ == jconstants.__all__
    want, got = getattr(jconstants, name), getattr(tconstants, name)
    assert got.__module__ == "tike_tpu_torch.constants" if callable(got) else got == want
    if not callable(want):
        return
    x = np.linspace(0.5, 30.0, 7)
    grid = (H.crandn(H.rng(0), 4, 4) if name.startswith("complex") else x)
    np.testing.assert_array_equal(got(grid), want(grid))


COST_SERIES = {
    "falling": [10.0, 8.0, 7.0, 6.5, 6.2, 6.1, 6.05, 6.0],
    "rising_tail": [10.0, 8.0, 7.0, 6.0, 6.1, 6.2, 6.3, 6.4],
    "flat": [5.0] * 8,
    "noisy": [9.0, 9.5, 8.7, 9.1, 8.9, 9.3, 8.8, 9.2, 9.0],
    "two_entries_per_epoch": [[4.0, 2.0], [3.0, 2.5], [3.5, 2.6], [3.6, 3.0], [3.9, 3.2]],
}


@pytest.mark.parametrize("series", sorted(COST_SERIES))
@pytest.mark.parametrize("window", [0, 1, 2, 3, 4, 5])
def test_is_converged_equals_jax(series, window):
    """The same answer on every prefix of the same cost lists, including
    the ``% window // 2`` test of which lengths are looked at."""
    costs = [c if isinstance(c, list) else [c] for c in COST_SERIES[series]]
    answers = []
    for fn in (jopt.is_converged, topt.is_converged):
        answers.append(
            [
                fn(types.SimpleNamespace(convergence_window=window, costs=costs[:k]))
                for k in range(len(costs) + 1)
            ]
        )
    assert answers[1] == answers[0]
    if window in (2, 3, 4) and series == "rising_tail":
        assert any(answers[1])
    if window < 2 or series == "falling":
        assert not any(answers[1])


@pytest.mark.parametrize(
    "solver, batch_method",
    [
        ("rpie", "wobbly_center"),
        ("rpie", "compact"),
        ("lstsq", "compact"),
        ("lstsq", "wobbly_center"),
    ],
)
def test_finite_time_limit_takes_the_per_epoch_path(slice_data, solver, batch_method):
    scan, probe, psi0, data = slice_data
    algo = dict(time_limit=1e6, batch_method=batch_method)
    jparams = H.epoch_loop_parameters(jp, scan, probe, psi0, solver, algo)
    got, want = H.run_both_packages(data, jparams, 3, fused=False)
    assert len(got["costs"]) == 3 and got["costs"][-1][0] < got["costs"][0][0]
    H.check_epoch_run(got, want)
    np.testing.assert_array_equal(got["scan"], scan)


@pytest.mark.parametrize("solver", ["rpie", "lstsq"])
def test_time_limit_stops_both_after_the_same_epoch(slice_data, solver):
    """The limit is held against the recorded times before each epoch: a
    limit below any epoch's time lets the first epoch run (no time is
    recorded yet) and stops before the second."""
    scan, probe, psi0, data = slice_data
    algo = dict(time_limit=1e-9, batch_method="compact")
    jparams = H.epoch_loop_parameters(jp, scan, probe, psi0, solver, algo)
    got, want = H.run_both_packages(data, jparams, 5, fused=False)
    assert len(got["costs"]) == len(want["costs"]) == 1
    H.check_epoch_run(got, want)


def test_per_epoch_times_are_each_epochs_own(slice_data):
    scan, probe, psi0, data = slice_data
    params = H.epoch_loop_parameters(
        tp, scan, probe, psi0, "rpie", dict(time_limit=1e6, batch_method="compact")
    )
    with tp.Reconstruction(data, params, device="cpu", random_seed=0) as context:
        context.iterate(3)
        _, times = context.get_convergence()
        power = context.parameters.probe_options.power
    assert len(times) == 3 and all(t > 0 for t in times)
    assert len(set(times)) == 3  # not the call's mean three times
    assert len(power) == 3


def test_convergence_window_runs_all_epochs_while_the_cost_falls(slice_data):
    scan, probe, psi0, data = slice_data
    algo = dict(convergence_window=4, batch_method="compact")
    jparams = H.epoch_loop_parameters(jp, scan, probe, psi0, "lstsq", algo)
    got, want = H.run_both_packages(data, jparams, 5, fused=True)
    assert len(got["costs"]) == 5
    H.check_epoch_run(got, want)


@pytest.mark.parametrize("solver, fused", [("lstsq", True), ("rpie", False)])
def test_convergence_window_stops_both_after_the_same_epoch(slice_data, solver, fused):
    """A run that continues from three epochs of (made-up) tiny costs sees
    a rising cost in its window and stops: on the fused path after its
    first ``window // 2`` chunk, on the per-epoch path (a finite
    ``time_limit``) after its first epoch, instead of running all six."""
    scan, probe, psi0, data = slice_data
    algo = dict(convergence_window=4, batch_method="compact")
    if not fused:
        algo["time_limit"] = 1e6
    jparams = H.epoch_loop_parameters(jp, scan, probe, psi0, solver, algo)
    history = ([1e-9, 2e-9, 3e-9], [0.1, 0.1, 0.1])
    got, want = H.run_both_packages(data, jparams, 6, fused=fused, history=history)
    assert len(got["costs"]) == len(want["costs"]) == 3 + (2 if fused else 1)
    H.check_epoch_run(got, want)


@pytest.mark.parametrize(
    "batch_method, adaptive", [("compact", False), ("wobbly_center", True)]
)
def test_position_regularization_every_epoch(slice_data, monkeypatch, batch_method, adaptive):
    """LSQML with ``use_position_regularization``: the affine model is
    fitted and applied after every epoch, so the next epoch starts from the
    relaxed positions."""
    scan, probe, psi0, data = slice_data
    H.seed_jax_position_fit(monkeypatch)
    position = dict(use_position_regularization=True, use_adaptive_moment=adaptive)
    jparams = H.epoch_loop_parameters(
        jp, scan, probe, psi0, "lstsq", dict(batch_method=batch_method), position
    )
    got, want = H.run_both_packages(data, jparams, 3, fused=False)
    H.check_epoch_run(got, want)
    assert np.max(np.abs(got["scan"] - scan)) > 1e-3  # the positions moved
    np.testing.assert_allclose(got["transform"], want["transform"], rtol=1e-4, atol=1e-5)
    if adaptive:
        H.assert_close(
            got["position_momentum"], want["position_momentum"],
            rtol=H.MOMENT_TOL, atol=H.MOMENT_TOL, scale=True,
        )


@pytest.mark.parametrize("regularize", [False, True])
def test_position_options_with_rpie(slice_data, monkeypatch, regularize):
    """rPIE never reads the position options: the solver leaves the
    positions where they are, and the per-epoch fit still runs (and, with
    ``use_position_regularization``, is applied to them)."""
    scan, probe, psi0, data = slice_data
    H.seed_jax_position_fit(monkeypatch)
    position = dict(use_position_regularization=regularize)
    jparams = H.epoch_loop_parameters(
        jp, scan, probe, psi0, "rpie", dict(batch_method="wobbly_center"), position
    )
    got, want = H.run_both_packages(data, jparams, 3, fused=False)
    H.check_epoch_run(got, want)
    if not regularize:
        np.testing.assert_array_equal(got["scan"], scan)
    np.testing.assert_allclose(got["transform"], want["transform"], rtol=1e-4, atol=1e-5)


def test_get_psi_equals_the_results_psi(slice_data):
    scan, probe, psi0, data = slice_data
    params = H.epoch_loop_parameters(tp, scan, probe, psi0, "rpie", dict(batch_method="compact"))
    with tp.Reconstruction(data, params, device="cpu", random_seed=0) as context:
        context.iterate(1)
        psi = context.get_psi()
        assert isinstance(psi, np.ndarray) and psi.dtype == np.complex64
        np.testing.assert_array_equal(psi, context.get_result().psi)
    assert hasattr(jp.Reconstruction, "get_psi")


def test_eigen_probes_on_the_per_epoch_path_raise(monkeypatch):
    """Eigen probes on the per-epoch path, which the port once refused:
    BASELINE config 2 (LSQML, compact batches, 3 probe modes, one eigen
    probe with weights, position correction) with a finite ``time_limit``,
    3 epochs. The loop constrains the eigen probes on probe-recovery epochs
    (``constrain_variable_probe``: normalized, orthogonalized, sorted by
    energy, outliers clipped), as tike_tpu's does, and nothing raises.
    Costs and fields at 1e-5, positions at 1e-4 px."""
    scan, psi, probe, psi0 = H.opr_inputs(h=Hh, p=P, det=DET, npos=NPOS)
    data = np.asarray(jp.simulate(DET, probe, scan, psi))
    H.seed_jax_position_fit(monkeypatch)
    calls = []
    constrain = tprobe.constrain_variable_probe
    monkeypatch.setattr(
        tprobe, "constrain_variable_probe", lambda *a: calls.append(1) or constrain(*a)
    )
    jparams = H.epoch_loop_parameters(
        jp, scan, probe, psi0, "lstsq", dict(time_limit=60.0, batch_method="compact"),
        dict(update_magnitude_limit=2.0),
    )
    jparams.eigen_probe, jparams.eigen_weights = H.bench_eigen(probe, len(scan))
    got, want = H.run_both_packages(data, jparams, 3, fused=False)
    H.check_epoch_run(got, want)
    for key in ("eigen_probe", "eigen_weights"):
        H.assert_close(got[key], want[key], rtol=H.SLICE_TOL, atol=H.SLICE_TOL, scale=True)
    assert len(calls) == 3  # every epoch recovers the probe
