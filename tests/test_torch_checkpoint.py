"""Checkpoints, online data (``append_new_data``) and the
gradient-of-intensity position update of the port against tike_tpu's, on
the CPU.

Checkpoints share one file format (an ``.npz`` of arrays with a JSON header
of option fields), so a file that either package writes loads in the other
with every array bit for bit, and a reconstruction resumed from it goes on
as one that never stopped (the port's to the bit; across the packages at
1e-5). ``append_new_data`` re-clusters from the reconstruction's own
generator, so 2 + 2 epochs with new positions appended in between agree at
1e-5 (measured below 2e-6). ``update_positions_pd`` solves a 2x2 system per
position from float32 derivative sums; new positions at 1e-5 px relative
and the new cost at 1e-5.
"""

import numpy as np
import pytest
import torch

import tike_tpu.checkpoint as jckpt
import tike_tpu.ptycho as jp
import tike_tpu.ptycho.position as jpos
from tike_tpu.ops.ptycho import PtychoConfig as JConfig

import tike_tpu_torch.checkpoint as tckpt
import tike_tpu_torch.ptycho as tp
from tike_tpu_torch import convert
from tike_tpu_torch.ops.ptycho import PtychoConfig as TConfig

from . import _torch_parity as H

TOL = 1e-5
Hh, P, DET, NPOS = 128, 16, 24, 96


@pytest.fixture(scope="module")
def slice_data():
    scan, psi, probe, psi0 = H.opr_inputs(h=Hh, p=P, det=DET, npos=NPOS)
    data = np.asarray(jp.simulate(DET, probe, scan, psi))
    return scan, probe, psi0, data


def _parameters(pkg, scan, probe, psi0, solver="lstsq", eigen=True, **algo):
    options = pkg.RpieOptions if solver == "rpie" else pkg.LstsqOptions
    eig, weights = H.bench_eigen(probe, len(scan)) if eigen else (None, None)
    return pkg.PtychoParameters(
        probe=probe,
        psi=psi0,
        scan=scan,
        eigen_probe=eig,
        eigen_weights=weights,
        algorithm_options=options(
            **{"num_batch": 3, "batch_method": "compact", "rescale_period": 2, **algo}
        ),
        object_options=pkg.ObjectOptions(use_adaptive_moment=True),
        probe_options=pkg.ProbeOptions(use_adaptive_moment=True),
        position_options=pkg.PositionOptions(
            initial_scan=scan, use_adaptive_moment=True, update_magnitude_limit=2.0
        ),
        exitwave_options=pkg.ExitWaveOptions(measured_pixels=np.ones((DET, DET), bool)),
    )


def _assert_same_parameters(a, b):
    """Every array of two parameter sets (either package) bit for bit, and
    the histories and option fields equal."""
    a, b = convert.parameters_to_numpy(a), convert.parameters_to_numpy(b)
    for key, value in a.items():
        if value is None:
            assert b[key] is None, key
        elif isinstance(value, np.ndarray):
            np.testing.assert_array_equal(b[key], value, err_msg=key)
        else:
            assert b[key] == value, key


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_checkpoints_cross_between_the_packages(slice_data, tmp_path, writer):
    """A result written by one package loads in both, bit for bit:
    arrays, costs and times, moments, the position transform and momentum."""
    scan, probe, psi0, data = slice_data
    jparams = _parameters(jp, scan, probe, psi0)
    tparams = convert.parameters_from_jax(jparams)
    if writer == "torch":
        with tp.Reconstruction(data, tparams, device="cpu", random_seed=0) as context:
            context.iterate(2)
            result = context.get_result()
        tckpt.save_parameters(tmp_path / "p.npz", result)
    else:
        with jp.Reconstruction(data, jparams, random_seed=0) as context:
            context.iterate(2)
            result = context.get_result()
        jckpt.save_parameters(tmp_path / "p.npz", result)
    for load in (tckpt.load_parameters, jckpt.load_parameters):
        loaded = load(tmp_path / "p.npz")
        _assert_same_parameters(result, loaded)
        assert loaded.position_options.transform.astuple() == pytest.approx(
            result.position_options.transform.astuple()
        )
        np.testing.assert_array_equal(
            np.asarray(loaded.position_options._momentum),
            np.asarray(result.position_options._momentum),
        )
        assert loaded.algorithm_options.name == "lstsq_grad"
        assert len(loaded.probe_options.power) == 2
        np.testing.assert_array_equal(
            np.asarray(loaded.object_options.m), np.asarray(result.object_options.m)
        )


def test_resume_from_a_checkpoint(slice_data, tmp_path):
    """2 epochs, a checkpoint, 2 more epochs from the file (the probe not
    rescaled again): the same as 4 epochs at once in the port, bit for bit
    (compact batches of unmoved positions, and the object and probe moments
    and the cost history restored), and as tike_tpu resumed from its own
    file at 1e-5. A checkpoint written from the live device state loads."""
    scan, probe, psi0, data = slice_data
    jparams = _parameters(jp, scan, probe, psi0, eigen=False)
    jparams.position_options = None

    def run(pkg, params, epochs, **kw):
        with pkg.Reconstruction(data, params, random_seed=0, **kw) as context:
            context.iterate(epochs)
            if pkg is tp:
                tckpt.save_parameters(tmp_path / "live.npz", context.parameters)
            return context.get_result()

    def resume(pkg, save, load, **kw):
        first = run(pkg, convert.parameters_from_jax(jparams) if pkg is tp else jparams, 2, **kw)
        save(tmp_path / "p.npz", first)
        loaded = load(tmp_path / "p.npz")
        loaded.probe_options.init_rescale_from_measurements = False
        return run(pkg, loaded, 2, **kw)

    straight = run(tp, convert.parameters_from_jax(jparams), 4, device="cpu")
    resumed = resume(tp, tckpt.save_parameters, tckpt.load_parameters, device="cpu")
    for key in ("psi", "probe", "scan"):
        np.testing.assert_array_equal(getattr(resumed, key), getattr(straight, key))
    assert resumed.algorithm_options.costs == straight.algorithm_options.costs
    assert tckpt.load_parameters(tmp_path / "live.npz").psi.shape == psi0.shape

    jresumed = resume(jp, jckpt.save_parameters, jckpt.load_parameters)
    got, want = convert.parameters_to_numpy(resumed), convert.parameters_to_numpy(jresumed)
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=TOL)
    for key in ("psi", "probe"):
        H.assert_close(got[key], want[key], rtol=TOL, atol=TOL, scale=True)


def _halves(data, scan):
    """Interleaved halves, so both cover the whole field of view."""
    return (data[0::2], scan[0::2]), (data[1::2], scan[1::2])


def test_append_new_data_matches_jax(slice_data):
    """Config 2 with wobbly-center batches: 2 epochs on half the positions,
    the other half appended, 2 more epochs: the same in both packages (the
    batches drawn again from each reconstruction's generator), with eigen
    weights padded by their means and the position state extended."""
    scan, probe, psi0, data = slice_data
    (d1, s1), (d2, s2) = _halves(data, scan)
    jparams = _parameters(jp, s1, probe, psi0, batch_method="wobbly_center")
    out = []
    for pkg, params, kw in (
        (jp, jparams, {}),
        (tp, convert.parameters_from_jax(jparams), dict(device="cpu")),
    ):
        context = pkg.Reconstruction(d1, params, random_seed=0, **kw)
        context.__enter__()
        context.iterate(2)
        assert context.append_new_data(d2, s2) is context
        p = context.parameters_host
        n = len(scan)
        assert p.scan.shape == (n, 2) and context.data_host.shape[0] == n
        assert p.probe_options.init_rescale_from_measurements is False
        np.testing.assert_allclose(
            p.eigen_weights[len(s1):],
            np.broadcast_to(p.eigen_weights[: len(s1)].mean(0), (len(s2), 2, 3)),
            rtol=1e-6,
        )
        popt = p.position_options
        assert popt.initial_scan.shape == popt.confidence.shape == (n, 2)
        assert popt._momentum.shape == (n, 4) and np.all(popt._momentum[len(s1):] == 0)
        context.iterate(2)
        out.append(convert.parameters_to_numpy(context.get_result()))
        context.__exit__(None, None, None)
    want, got = out
    assert len(got["costs"]) == 4 and got["costs"][3] < got["costs"][2]
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=TOL)
    for key in ("psi", "probe", "eigen_probe", "eigen_weights"):
        H.assert_close(got[key], want[key], rtol=TOL, atol=TOL, scale=True)
    H.assert_close(got["scan"], want["scan"], rtol=0, atol=5e-4)


def test_append_new_data_checks_its_inputs(slice_data):
    """The reference's shape checks (tests/ptycho/test_append.py), its
    warning on invalid patterns, and the refusal of data given on a
    device (here a stand-in: the check reads the tensor's device type)."""
    scan, probe, psi0, data = slice_data
    params = _parameters(tp, scan[:60], probe, psi0, eigen=False)
    context = tp.Reconstruction(data[:60], params, device="cpu")
    context.__enter__()
    with pytest.raises(ValueError, match="incompatible"):
        context.append_new_data(data[:4], scan[:3])
    with pytest.raises(ValueError, match="detector"):
        context.append_new_data(data[:4, :-2, :-2], scan[:4])
    with pytest.warns(UserWarning, match="invalid data"):
        context.append_new_data(-data[60:64], scan[60:64])
    assert context.data_host.shape[0] == 64
    context.__exit__(None, None, None)

    class OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("meta")

    context.data_host = torch.as_tensor(data[:64]).as_subclass(OnCard)
    with pytest.raises(NotImplementedError, match="host data"):
        context.append_new_data(data[64:68], scan[64:68])


def test_update_positions_pd_matches_jax(slice_data):
    """From positions 0.3-0.7 px off the true ones: the new positions and
    the Gaussian cost at them."""
    scan, probe, psi0, data = slice_data
    _, psi, _, _ = H.opr_inputs(h=Hh, p=P, det=DET, npos=NPOS)
    gen = H.rng(11)
    start = (scan + gen.uniform(0.3, 0.7, scan.shape) * gen.choice([-1, 1], scan.shape)).astype(
        np.float32
    )
    kw = dict(probe_shape=P, detector_shape=DET, nz=Hh, n=Hh)
    want_scan, want_cost = jpos.update_positions_pd(
        JConfig(**kw), data, psi, probe, start
    )
    got_scan, got_cost = tp.update_positions_pd(
        TConfig(**kw), torch.as_tensor(data), torch.as_tensor(psi), torch.as_tensor(probe),
        torch.as_tensor(start),
    )
    assert isinstance(got_scan, torch.Tensor) and isinstance(got_cost, float)
    H.assert_close(got_scan, want_scan, rtol=TOL, atol=TOL, scale=True)
    assert got_cost == pytest.approx(want_cost, rel=TOL)
    # The mean position stays where it was.
    np.testing.assert_allclose(got_scan.numpy().mean(0), start.mean(0), atol=1e-4)
