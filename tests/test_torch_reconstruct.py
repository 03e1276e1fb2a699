"""The port's LSQML slice against tike_tpu's, end to end on the CPU.

Both packages get the same seeded state through
``tike_tpu_torch.convert.parameters_from_jax`` and run a compact LSQML
``Reconstruction`` with the same ``random_seed`` (so the same batches),
a detector wider than the probe (so the pad/crop runs) and
``rescale_period=2`` (so the mean-abs rescale fires inside 3 epochs), once
with each preconditioner formulation. Per-epoch costs, psi and probe agree
to 1e-5 relative; they differ only in float32 summation order and FFT
library (measured ~5e-7).

From ``bench.py``'s own start (constant object, smooth probe) the two agree
less closely, and so does the reference with itself: see
``test_slice_from_bench_start_matches_jax``.
"""

import inspect

import numpy as np
import pytest
import torch

import tike_tpu.ptycho as jp
import tike_tpu.ptycho.solvers._preconditioner as jpre

import tike_tpu_torch.ptycho as tp
import tike_tpu_torch.ptycho.solvers._preconditioner as tpre
from tike_tpu_torch import convert

from . import _torch_parity as H

Hh, P, DET, NPOS = 160, 16, 24, 120


@pytest.fixture(scope="module")
def slice_data():
    scan, psi, probe, psi0 = H.slice_inputs(h=Hh, p=P, det=DET, npos=NPOS)
    data = np.asarray(jp.simulate(DET, probe, scan, psi))
    return scan, psi, probe, psi0, data


def _jax_parameters(scan, probe, psi0, **algo):
    opts = dict(num_batch=3, batch_method="compact", rescale_period=2)
    opts.update(algo)
    return jp.PtychoParameters(
        probe=probe,
        psi=psi0,
        scan=scan,
        algorithm_options=jp.LstsqOptions(**opts),
        object_options=jp.ObjectOptions(),
        probe_options=jp.ProbeOptions(),
        exitwave_options=jp.ExitWaveOptions(
            measured_pixels=np.ones((DET, DET), bool)
        ),
    )


def test_simulate_matches_jax(slice_data):
    scan, psi, probe, _, data = slice_data
    got = tp.simulate(DET, probe, scan, psi, device="cpu")
    assert isinstance(got, np.ndarray)
    assert got.dtype == np.float32 and got.shape == data.shape
    H.assert_close(got, data, rtol=1e-5, atol=1e-5, scale=True)


def test_simulate_returns_numpy_and_simulate_device_the_tensor(slice_data):
    """As in the JAX package: ``simulate`` gives the host array (a caller
    may ``.astype`` it), ``simulate_device`` the same values on the device,
    which ``Reconstruction`` takes as they are."""
    scan, psi, probe, psi0, data = slice_data
    want = jp.simulate(DET, probe, scan, psi)
    got = tp.simulate(DET, probe, scan, psi, device="cpu")
    assert type(got) is type(want) is np.ndarray
    assert got.dtype == want.dtype == np.float32
    assert got.astype(np.float64).shape == want.shape
    on_device = tp.simulate_device(DET, probe, scan, psi, device="cpu")
    assert isinstance(on_device, torch.Tensor)
    assert on_device.dtype == torch.float32 and on_device.device.type == "cpu"
    np.testing.assert_array_equal(on_device.numpy(), got)
    assert tp.simulate_device is not tp.simulate
    params = convert.parameters_from_jax(_jax_parameters(scan, probe, psi0))
    with tp.Reconstruction(on_device, params, device="cpu", random_seed=0) as c:
        c.iterate(1)
        assert np.isfinite(c.get_convergence()[0][-1][0])


def _leading(signature, count):
    return [
        (p.name, p.kind, p.default)
        for p in list(signature.parameters.values())[:count]
    ]


@pytest.mark.parametrize(
    "name, skip_self, carried",
    [("Reconstruction", 1, 8), ("reconstruct", 0, 6)],
)
def test_entry_point_signatures_match_jax(name, skip_self, carried):
    """The leading parameters of the port's entry points are the JAX
    package's: names, order, kinds and defaults (the private
    ``_force_stripes`` is not carried). What the port adds follows as
    keyword-only, ``device`` first."""
    target = lambda mod: getattr(mod, name).__init__ if skip_self else getattr(mod, name)
    want = inspect.signature(target(jp))
    got = inspect.signature(target(tp))
    n = skip_self + carried
    assert _leading(got, n) == _leading(want, n)
    assert [p.name for p in want.parameters.values()][n:] in ([], ["_force_stripes"])
    added = list(got.parameters.values())[n:]
    assert added[0].name == "device" and added[0].default == "cuda"
    assert all(p.kind is inspect.Parameter.KEYWORD_ONLY for p in added)


def test_num_gpu_in_third_place_is_not_a_device(slice_data, monkeypatch):
    """``Reconstruction(data, params, 1)`` is the reference's ``num_gpu=1``:
    it runs on the requested device, and is not read as ``cuda:1``."""
    scan, psi, probe, psi0, data = slice_data
    params = convert.parameters_from_jax(_jax_parameters(scan, probe, psi0))
    with tp.Reconstruction(data, params, 1, device="cpu", random_seed=0) as context:
        assert context.device == torch.device("cpu")
        context.iterate(1)
        assert np.isfinite(context.get_convergence()[0][-1][0])
    result = tp.reconstruct(data, params, (1,), False, None, "replicated", device="cpu")
    assert isinstance(result.psi, np.ndarray)
    # With no device named it asks for the card, whatever num_gpu says.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device cuda was requested"):
        tp.Reconstruction(data, params, 1)


@pytest.mark.parametrize(
    "match, kwargs",
    [
        ("num_gpu = 2", dict(num_gpu=2)),
        ("num_gpu = \\(1, 1\\)", dict(num_gpu=(1, 1))),
        ("use_mpi", dict(use_mpi=True)),
        ("a mesh", dict(mesh=object())),
        ("object_sharding='striped'", dict(object_sharding="striped", mesh=object())),
    ],
)
def test_unported_entry_point_arguments_raise(slice_data, match, kwargs):
    scan, _, probe, psi0, data = slice_data
    params = convert.parameters_from_jax(_jax_parameters(scan, probe, psi0))
    with pytest.raises(NotImplementedError, match=match):
        tp.Reconstruction(data, params, device="cpu", **kwargs)
    with pytest.raises(NotImplementedError, match=match):
        tp.reconstruct(data, params, device="cpu", **kwargs)
    with pytest.raises(ValueError, match="object_sharding"):
        tp.Reconstruction(data, params, device="cpu", object_sharding="rows")


@pytest.mark.parametrize("fft_precond", [False, True])
def test_slice_matches_jax(slice_data, monkeypatch, fft_precond):
    scan, _, probe, psi0, data = slice_data
    monkeypatch.setattr(jpre, "USE_FFT_PRECOND", True)
    monkeypatch.setattr(jpre, "fft_precond_profitable", lambda **_: fft_precond)
    monkeypatch.setattr(tpre, "fft_precond_profitable", lambda **_: fft_precond)

    jparams = _jax_parameters(scan, probe, psi0)
    tparams = convert.parameters_from_jax(jparams)
    with jp.Reconstruction(data, jparams, random_seed=0) as context:
        assert context._make_plan(context.parameters, 3).fft_precond == fft_precond
        context.iterate(3)
        want = convert.parameters_to_numpy(context.get_result())
    with tp.Reconstruction(data, tparams, device="cpu", random_seed=0) as context:
        assert context._make_plan().fft_precond == fft_precond
        context.iterate(3)
        got = convert.parameters_to_numpy(context.get_result())
        costs, times = context.get_convergence()

    assert len(costs) == len(times) == 3
    assert np.all(np.isfinite(costs)) and costs[-1][0] < costs[0][0]
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=1e-5)
    np.testing.assert_array_equal(got["scan"], want["scan"])
    for key in ("psi", "probe"):
        assert got[key].dtype == np.complex64
        H.assert_close(got[key], want[key], rtol=1e-5, atol=1e-5, scale=True)


@pytest.mark.parametrize(
    "epochs, cost_rtol, field_tol", [(1, 1e-5, 5e-3), (3, 3e-4, 1e-2)]
)
def test_slice_from_bench_start_matches_jax(epochs, cost_rtol, field_tol):
    """The timed configuration's start, held to the reference's own
    rounding sensitivity.

    A constant object under a smooth probe gives far-field pixels whose
    modeled intensity is ~0; there the Gaussian gradient's
    ``farplane / sqrt(intensity)`` is the phase of float32 FFT rounding
    noise. The witness: moving the reference's starting psi and probe by
    one ulp moves its own psi and probe by more than the port's distance
    from it. Measured on the CPU: port vs reference 2.7e-3 (psi) and 3.8e-3
    (probe) after 1 epoch, 5.6e-3 and 5.0e-3 after 3; the reference against
    its one-ulp self 3.2e-3 and 5.5e-3, then 7.6e-3 and 8.7e-3. Costs: 5.4e-6
    after 1 epoch, 1.1e-4 after 3 (the reference against itself 9.8e-5).
    """
    scan, psi, probe, psi0 = H.bench_start_inputs(h=Hh, p=P, det=DET, npos=NPOS)
    data = np.asarray(jp.simulate(DET, probe, scan, psi))
    gen = H.rng(1)

    def run_jax(probe, psi0):
        with jp.Reconstruction(
            data, _jax_parameters(scan, probe, psi0), random_seed=0
        ) as context:
            context.iterate(epochs)
            return convert.parameters_to_numpy(context.get_result())

    want = run_jax(probe, psi0)
    nudged = run_jax(H.one_ulp(gen, probe), H.one_ulp(gen, psi0))
    tparams = convert.parameters_from_jax(_jax_parameters(scan, probe, psi0))
    with tp.Reconstruction(data, tparams, device="cpu", random_seed=0) as context:
        context.iterate(epochs)
        got = convert.parameters_to_numpy(context.get_result())

    np.testing.assert_allclose(got["costs"], want["costs"], rtol=cost_rtol)
    for key in ("psi", "probe"):
        H.assert_close(got[key], want[key], rtol=0, atol=field_tol, scale=True)
        gap = np.max(np.abs(got[key] - want[key]))
        own = np.max(np.abs(nudged[key] - want[key]))
        assert gap <= 2 * own, (key, gap, own)


def test_iterate_in_pieces_equals_one_call(slice_data):
    """iterate(1) then iterate(2) runs the same epochs as iterate(3)."""
    scan, _, probe, psi0, data = slice_data
    results = []
    for pieces in ([3], [1, 2]):
        params = convert.parameters_from_jax(_jax_parameters(scan, probe, psi0))
        with tp.Reconstruction(data, params, device="cpu", random_seed=0) as c:
            for k in pieces:
                c.iterate(k)
            results.append(convert.parameters_to_numpy(c.get_result()))
    np.testing.assert_array_equal(results[1]["psi"], results[0]["psi"])
    np.testing.assert_array_equal(results[1]["costs"], results[0]["costs"])


def test_reconstruct_functional_api(slice_data):
    scan, _, probe, psi0, data = slice_data
    params = convert.parameters_from_jax(
        _jax_parameters(scan, probe, psi0, num_iter=2)
    )
    result = tp.reconstruct(data, params, device="cpu", random_seed=1)
    assert isinstance(result.psi, np.ndarray) and result.psi.dtype == np.complex64
    assert len(result.algorithm_options.costs) == 2
    assert np.isfinite(result.probe_options.probe_photons)
    np.testing.assert_array_equal(result.scan, scan)


def test_device_tensor_data_matches_host_data(slice_data):
    scan, _, probe, psi0, data = slice_data
    out = []
    for d in (data, torch.tensor(data)):
        params = convert.parameters_from_jax(_jax_parameters(scan, probe, psi0))
        with tp.Reconstruction(d, params, device="cpu", random_seed=0) as c:
            c.iterate(1)
            out.append(c.get_result().psi)
    np.testing.assert_array_equal(out[1], out[0])


def _unported(scan, probe, psi0):
    """What the port still refuses, after rPIE, the batch methods, Poisson
    and the probe and object constraints were ported."""
    yield "convergence_window", dict(
        algorithm_options=tp.LstsqOptions(convergence_window=4)
    )
    yield "time_limit", dict(algorithm_options=tp.RpieOptions(time_limit=60.0))
    yield "use_position_regularization", dict(
        position_options=tp.PositionOptions(
            initial_scan=scan, use_position_regularization=True
        )
    )
    yield "position correction with rpie", dict(
        algorithm_options=tp.RpieOptions(),
        position_options=tp.PositionOptions(initial_scan=scan),
    )
    yield "host streaming", dict(store_data_on_device=False)
    yield "multislice", dict(psi=np.concatenate([psi0, psi0]))
    yield "rescale_method", dict(
        algorithm_options=tp.LstsqOptions(rescale_method="no_such_method")
    )


@pytest.mark.parametrize("which", range(7))
def test_unported_options_raise(slice_data, which):
    scan, _, probe, psi0, data = slice_data
    match, change = list(_unported(scan, probe, psi0))[which]
    store = change.pop("store_data_on_device", True)
    kw = dict(
        probe=probe,
        psi=psi0,
        scan=scan,
        algorithm_options=tp.LstsqOptions(batch_method="compact"),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
        exitwave_options=tp.ExitWaveOptions(
            measured_pixels=np.ones((DET, DET), bool)
        ),
    )
    kw.update(change)
    with pytest.raises(NotImplementedError, match=match):
        tp.Reconstruction(
            data, tp.PtychoParameters(**kw), device="cpu", store_data_on_device=store
        )


def test_cuda_device_without_cuda_raises(slice_data, monkeypatch):
    """Asking for the card where there is none raises; nothing runs on the
    CPU instead."""
    scan, psi, probe, psi0, data = slice_data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = convert.parameters_from_jax(_jax_parameters(scan, probe, psi0))
    with pytest.raises(RuntimeError, match="cuda"):
        tp.Reconstruction(data, params, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tp.simulate(DET, probe, scan, psi, device="cuda")


def test_device_is_required(slice_data, monkeypatch):
    """With no device the entry points ask for the CUDA card, and raise
    where there is none; None is not a device."""
    scan, psi, probe, psi0, data = slice_data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = convert.parameters_from_jax(_jax_parameters(scan, probe, psi0))
    with pytest.raises(RuntimeError, match="cuda"):
        tp.Reconstruction(data, params)
    with pytest.raises(RuntimeError, match="cuda"):
        tp.reconstruct(data, params)
    with pytest.raises(RuntimeError, match="cuda"):
        tp.simulate(DET, probe, scan, psi)
    with pytest.raises(TypeError, match="device"):
        tp.reconstruct(data, params, device=None)
    # device is keyword-only: the reference's parameters fill the places.
    with pytest.raises(TypeError, match="positional"):
        tp.reconstruct(data, params, 1, False, None, "replicated", "cpu")
    with pytest.raises(TypeError, match="positional"):
        tp.Reconstruction(data, params, 1, False, None, None, None, "replicated", "cpu")


def test_cpu_device_runs_when_asked(slice_data):
    """``device="cpu"`` still runs: one epoch, finite cost, result on the
    host."""
    scan, psi, probe, psi0, data = slice_data
    params = convert.parameters_from_jax(_jax_parameters(scan, probe, psi0))
    with tp.Reconstruction(data, params, device="cpu", random_seed=0) as context:
        assert context.device == torch.device("cpu")
        context.iterate(1)
        result = context.get_result()
    assert np.all(np.isfinite(np.asarray(result.algorithm_options.costs)))
    assert result.psi.shape == psi0.shape


@pytest.mark.parametrize("where", ["data", "psi", "simulate"])
def test_tensor_on_another_device_raises(slice_data, where):
    """A tensor that lies off the CPU is never copied to the requested CPU
    device; the call raises and the tensor stays where it was."""
    scan, psi, probe, psi0, data = slice_data
    params = convert.parameters_from_jax(_jax_parameters(scan, probe, psi0))
    elsewhere = lambda x: torch.empty(x.shape, dtype=torch.complex64, device="meta")
    if where == "simulate":
        moved = elsewhere(psi)
        with pytest.raises(ValueError, match="psi is on meta"):
            tp.simulate(DET, probe, scan, moved, device="cpu")
    elif where == "psi":
        moved = params.psi = elsewhere(params.psi)
        with pytest.raises(ValueError, match="parameters.psi is on meta"):
            tp.Reconstruction(data, params, device="cpu")
    else:
        moved = torch.empty(data.shape, device="meta")
        with pytest.raises(ValueError, match="data is on meta"):
            tp.Reconstruction(moved, params, device="cpu")
    assert moved.device.type == "meta"


def test_bad_shapes_raise(slice_data):
    scan, _, probe, psi0, data = slice_data
    params = convert.parameters_from_jax(_jax_parameters(scan, probe, psi0))
    with pytest.raises(ValueError, match="data shape"):
        tp.Reconstruction(data[:-1], params, device="cpu")
    with pytest.raises(ValueError, match="data shape"):
        tp.Reconstruction(data[..., :-1], params, device="cpu")
    with pytest.raises(ValueError, match="Scan positions"):
        tp.PtychoParameters(probe=probe, psi=psi0, scan=scan - 2.0)
