"""The port's rPIE, its options and the fused path's other options, against
tike_tpu on the CPU.

The batch math gets the same seeded inputs on both sides and agrees to
1e-5 relative to the largest value. The whole slice runs ``Reconstruction``
for 3 epochs with the same ``random_seed`` on both sides (so the same
batches and the same per-epoch batch orders), from the perturbed object
and random-phase probe of ``_torch_parity.slice_inputs``, and agrees with
tike_tpu's fused path to 1e-5 relative in costs, fields, eigen weights
and moment states. Orthogonalized probes are compared up to one phase per
mode (see ``test_torch_constraints.py``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

import tike_tpu.cluster as jcluster
import tike_tpu.ptycho as jp
from tike_tpu.ops.ptycho import PtychoConfig as JConfig

import tike_tpu_torch.cluster as tcluster
import tike_tpu_torch.ptycho as tp
from tike_tpu_torch import convert
from tike_tpu_torch.ops.ptycho import PtychoConfig as TConfig

from . import _torch_parity as H

# The modules, which the solvers packages' ``rpie`` functions shadow.
jrpie = importlib.import_module("tike_tpu.ptycho.solvers.rpie")
trpie = importlib.import_module("tike_tpu_torch.ptycho.solvers.rpie")

Hh, P, DET, NPOS = 160, 16, 24, 120
TOL = H.SLICE_TOL


def _close(got, want, tol=TOL):
    H.assert_close(got, want, rtol=tol, atol=tol, scale=True)


@pytest.fixture(scope="module")
def batch_inputs():
    """One padded batch of 3-mode data at the small size."""
    scan, psi, probe, psi0 = H.opr_inputs(h=Hh, p=P, det=DET, npos=40)
    data = np.asarray(jp.simulate(DET, probe, scan, psi))
    eig, weights = H.bench_eigen(probe, len(scan))
    weights[:, 1] = H.rng(70).uniform(-0.5, 0.5, (len(scan), probe.shape[-3]))
    idx = np.arange(24, dtype=np.int32)
    idx[20:] = idx[0]
    mask = (np.arange(24) < 20).astype(np.float32)
    mp = H.rng(71).random((DET, DET)) > 0.1
    return dict(
        data=data[idx], scan=scan, idx=idx, mask=mask, psi=psi0, probe=probe,
        eig=eig, weights=weights, mp=mp,
    )


@pytest.mark.parametrize(
    "noise_model, usemodes",
    [("gaussian", "all_modes"), ("poisson", "all_modes"), ("poisson", "dominant_mode")],
)
@pytest.mark.parametrize("eigen", [False, True], ids=["shared", "eigen"])
def test_batch_gradients_math_matches_jax(batch_inputs, noise_model, usemodes, eigen):
    b = batch_inputs
    eig = b["eig"] if eigen else None
    weights = b["weights"] if eigen else None
    kw = dict(noise_model=noise_model, steplength_usemodes=usemodes, recover_probe=True)
    jcfg = JConfig(probe_shape=P, detector_shape=DET, nz=Hh, n=Hh)
    tcfg = TConfig(probe_shape=P, detector_shape=DET, nz=Hh, n=Hh)
    args = [b["data"], b["scan"], b["idx"], b["mask"], b["psi"], b["probe"], eig, weights, b["mp"]]
    want = jrpie._batch_gradients_math(
        jcfg, *[None if a is None else jnp.asarray(a) for a in args], 0.5, 0.5, 1.0, **kw
    )
    targs = [None if a is None else H.t(a) for a in args]
    targs[2] = targs[2].long()
    got = trpie._batch_gradients_math(tcfg, *targs, 0.5, 0.5, 1.0, **kw)
    for g, w in zip(got, want):
        if w is None:
            assert g is None and not eigen
            continue
        assert g.shape == w.shape
        _close(g, w)
    # Padded slots add nothing.
    if eigen:
        np.testing.assert_array_equal(H.n(got[3])[20:], 0)


def test_normalize_eigen_weights_matches_jax(batch_inputs):
    w = batch_inputs["weights"].copy()
    w[:, 1, 2] = 0  # an all-zero column stays zero
    got = trpie._normalize_eigen_weights(H.t(w))
    _close(got, jrpie._normalize_eigen_weights(jnp.asarray(w)))
    np.testing.assert_array_equal(H.n(got)[:, 1, 2], 0)


@pytest.mark.parametrize(
    "method", ["compact", "wobbly_center", "wobbly_center_random_bootstrap", "random"]
)
def test_batch_methods_match_jax(method):
    """The same generator state gives the same batches."""
    scan = H.positions(H.rng(72), 90, 200, 200, 16)
    want = jcluster.by_scan_stripes_contiguous(
        scan, 1, method, 4, rng=np.random.default_rng(5)
    )
    got = tcluster.by_scan_stripes_contiguous(
        scan, 1, method, 4, rng=np.random.default_rng(5)
    )
    np.testing.assert_array_equal(got[0][0], want[0][0])
    for g, w in zip(got[1][0], want[1][0]):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]


@pytest.fixture(scope="module")
def slice_data():
    scan, psi, probe, psi0 = H.opr_inputs(h=Hh, p=P, det=DET, npos=NPOS)
    data = np.asarray(jp.simulate(DET, probe, scan, psi))
    return scan, probe, psi0, data


# rpie_random and rpie_poisson run in test_torch_fused.py, to keep each
# file short.
RPIE_CASES = sorted(
    k for k in H.FUSED_CASES if k.startswith("rpie") and k not in ("rpie_random", "rpie_poisson")
)


@pytest.mark.parametrize("case", RPIE_CASES)
def test_rpie_slice_matches_jax(slice_data, case):
    H.check_fused_slice(*H.fused_slice(slice_data, case), case)


def test_iterate_in_pieces_equals_one_call(slice_data):
    """iterate(1) then iterate(2) draws the same batch orders and carries
    the moment states and the cost tail as iterate(3) does."""
    scan, probe, psi0, data = slice_data
    results = []
    for case in ("rpie_adam", "lstsq_compact_checked"):
        case_data = H.fused_case_data(data, case)
        for pieces in ([3], [1, 2]):
            params = convert.parameters_from_jax(
                H.fused_parameters(jp, scan, probe, psi0, case)
            )
            with tp.Reconstruction(case_data, params, device="cpu", random_seed=0) as c:
                for k in pieces:
                    c.iterate(k)
                results.append(convert.parameters_to_numpy(c.get_result()))
        for key in ("psi", "probe", "costs", "object_m", "probe_m", "probe_v"):
            np.testing.assert_array_equal(results[-1][key], results[-2][key])


def test_defaults_of_both_solvers_run(slice_data):
    """RpieOptions() and LstsqOptions() as a user writes them: wobbly-center
    batches, which the port used to refuse."""
    scan, probe, psi0, data = slice_data
    for options in (tp.RpieOptions(), tp.LstsqOptions()):
        params = tp.PtychoParameters(
            probe=probe, psi=psi0, scan=scan, algorithm_options=options,
            object_options=tp.ObjectOptions(), probe_options=tp.ProbeOptions(),
            exitwave_options=tp.ExitWaveOptions(measured_pixels=np.ones((DET, DET), bool)),
        )
        with tp.Reconstruction(data, params, device="cpu", random_seed=0) as c:
            c.iterate(1)
            assert np.isfinite(c.get_convergence()[0][-1][0])


def test_constant_probe_photons_needs_a_photon_count(slice_data):
    scan, probe, psi0, data = slice_data
    params = convert.parameters_from_jax(
        H.fused_parameters(jp, scan, probe, psi0, "rpie_photons")
    )
    params.probe_options.init_rescale_from_measurements = False
    with pytest.raises(ValueError, match="probe_photons"):
        with tp.Reconstruction(data, params, device="cpu"):
            pass
