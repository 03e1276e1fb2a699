"""The per-epoch solver functions and their preconditioners against
tike_tpu on the CPU: ``update_preconditioners`` then ``solvers.rpie`` or
``solvers.lstsq_grad``, called by hand epoch by epoch, as a user's script
drives tike_tpu.

Both packages start from the same seeded parameters (the perturbed object
and random-phase probe of ``_torch_parity.slice_inputs``), the same padded
batches and a ``np.random.default_rng(seed)`` each, and are compared after
the first and the third epoch: costs, fields, eigen state and positions at
1e-5 relative to the largest value (positions to 1e-4 px), moment states at
1e-4.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tike_tpu.cluster as jcluster
import tike_tpu.ptycho as jp
from tike_tpu.ops.ptycho import PtychoConfig as JConfig

from tike_tpu_torch import convert
from tike_tpu_torch.ops.ptycho import PtychoConfig as TConfig

from . import _torch_parity as H

Hh, P, DET, NPOS = 160, 16, 24, 120
TOL, MOMENT_TOL = H.SLICE_TOL, H.MOMENT_TOL

# name: (solver, algorithm options, object options, probe options,
# position options or None, extra). extra: 'flat' data (N, DET, DET) rather
# than batch-major, 'eigen' (bench_eigen's state), 'brightness', 'unpadded'
# batches of equal length.
CASES = {
    "rpie_compact": ("rpie", dict(batch_method="compact"), {}, {}, None, {}),
    "rpie_wobbly_flat": (
        "rpie", dict(batch_method="wobbly_center"), {}, {}, None, dict(flat=True)
    ),
    "rpie_adam_gated": (
        "rpie",
        dict(batch_method="wobbly_center"),
        dict(use_adaptive_moment=True),
        # Epoch 1 is past update_start but off update_period.
        dict(use_adaptive_moment=True, update_start=1, update_period=2),
        None,
        dict(brightness=100.0),
    ),
    "rpie_checked": (
        "rpie",
        dict(batch_method="compact"),
        dict(use_adaptive_moment=True),
        dict(use_adaptive_moment=True),
        None,
        {},
    ),
    "rpie_eigen": (
        "rpie", dict(batch_method="wobbly_center"), {}, {}, None, dict(eigen=True)
    ),
    "lstsq_compact_position": (
        "lstsq",
        dict(batch_method="compact"),
        {},
        {},
        dict(use_adaptive_moment=True, update_magnitude_limit=0.5),
        {},
    ),
    "lstsq_wobbly_momentum_flat": (
        "lstsq",
        dict(batch_method="wobbly_center"),
        dict(use_adaptive_moment=True),
        dict(use_adaptive_moment=True),
        None,
        dict(flat=True),
    ),
    "lstsq_compact_checked": (
        "lstsq",
        dict(batch_method="compact"),
        dict(use_adaptive_moment=True),
        dict(use_adaptive_moment=True, update_start=1),
        None,
        {},
    ),
    # tike_tpu writes LSQML's eigen weights back through padded slots too
    # (ROADMAP.md §3), so this case takes batches of equal length. Unlimited,
    # its position steps reach 20-26 px an epoch, where float32 rounding
    # moves them by 2e-5 of a step (4.6e-4 px); a 1 px limit keeps them
    # physical.
    "lstsq_eigen": (
        "lstsq",
        dict(batch_method="wobbly_center"),
        {},
        {},
        dict(update_start=1, update_magnitude_limit=1.0),
        dict(eigen=True, unpadded=True),
    ),
}


@pytest.fixture(scope="module")
def slice_data():
    scan, psi, probe, psi0 = H.slice_inputs(h=Hh, p=P, det=DET, npos=NPOS)
    data = np.asarray(jp.simulate(DET, probe, scan, psi))
    return scan, probe, psi0, data


def _batches(scan, method, unpadded):
    if unpadded:
        return jcluster.batches_padded(np.array_split(H.rng(5).permutation(NPOS), 3))
    cluster = jcluster.compact if method == "compact" else jcluster.wobbly_center
    kw = dict(rng=H.rng(4)) if method == "compact" else {}
    return jcluster.batches_padded(cluster(scan, 3, **kw))


def _parameters(pkg, scan, probe, psi0, case):
    solver, algo, oopts, popts, position, extra = CASES[case]
    probe = (probe * extra.get("brightness", 1.0)).astype(np.complex64)
    eig, weights = H.bench_eigen(probe, len(scan)) if extra.get("eigen") else (None, None)
    if weights is not None:
        weights[:, 1] = H.rng(70).uniform(-0.5, 0.5, (len(scan), probe.shape[-3]))
    options = pkg.RpieOptions if solver == "rpie" else pkg.LstsqOptions
    return pkg.PtychoParameters(
        probe=probe,
        psi=psi0,
        scan=scan,
        eigen_probe=eig,
        eigen_weights=weights,
        algorithm_options=options(num_batch=3, **algo),
        object_options=pkg.ObjectOptions(**oopts),
        probe_options=pkg.ProbeOptions(**popts),
        position_options=None
        if position is None
        else pkg.PositionOptions(initial_scan=scan, **position),
        exitwave_options=pkg.ExitWaveOptions(measured_pixels=np.ones((DET, DET), bool)),
    )


def _run(solvers, cfg, params, data, batches, solver, epochs=3):
    """``epochs`` of the hand-written loop; the state after each epoch."""
    fn = solvers.rpie if solver == "rpie" else solvers.lstsq_grad
    rng = np.random.default_rng(3)
    out = []
    for epoch in range(epochs):
        params = solvers.update_preconditioners(cfg, params, batches)
        params = fn(params, data, batches, op=cfg, epoch=epoch, rng=rng)
        out.append(convert.parameters_to_numpy(params))
    return out


def _check(got, want, case):
    assert len(got["costs"]) == len(want["costs"])
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=TOL)
    for key in ("psi", "probe", "eigen_probe", "eigen_weights"):
        if want[key] is None:
            assert got[key] is None, key
            continue
        H.assert_close(got[key], want[key], rtol=TOL, atol=TOL, scale=True)
    H.assert_close(got["scan"], want["scan"], rtol=0, atol=1e-4)
    for key in ("object_v", "object_m", "probe_v", "probe_m", "position_momentum"):
        if want[key] is None:
            assert got[key] is None, key
            continue
        H.assert_close(got[key], want[key], rtol=MOMENT_TOL, atol=MOMENT_TOL, scale=True)


@pytest.mark.parametrize("case", list(CASES))
def test_per_epoch_solver_matches_jax(slice_data, case):
    scan, probe, psi0, data = slice_data
    solver, algo, _, _, _, extra = CASES[case]
    data = (data * extra.get("brightness", 1.0) ** 2).astype(np.float32)
    batches = _batches(scan, algo["batch_method"], extra.get("unpadded", False))
    idx = batches[0]
    jdata = data if extra.get("flat") else data[idx]
    jparams = _parameters(jp, scan, probe, psi0, case)
    tparams = convert.parameters_from_jax(jparams).copy_to_device("cpu")
    for key in ("psi", "probe", "scan", "eigen_probe", "eigen_weights"):
        if getattr(jparams, key) is not None:
            setattr(jparams, key, jnp.asarray(getattr(jparams, key)))
    want = _run(
        importlib.import_module("tike_tpu.ptycho.solvers"),
        JConfig(probe_shape=P, detector_shape=DET, nz=Hh, n=Hh),
        jparams, jnp.asarray(jdata), batches, solver,
    )
    got = _run(
        importlib.import_module("tike_tpu_torch.ptycho.solvers"),
        TConfig(probe_shape=P, detector_shape=DET, nz=Hh, n=Hh),
        tparams, torch.as_tensor(jdata), batches, solver,
    )
    assert np.all(np.isfinite(got[-1]["costs"])) and got[-1]["costs"][-1] < got[-1]["costs"][0]
    for epoch in (0, 2):
        _check(got[epoch], want[epoch], case)


# The multislice geometry of tests/test_torch_multislice.py.
MULTISLICE = dict(
    nz=60, n=65, nslices=3, probe_wavelength=1.4e-10, probe_FOV_lengths=(1e-6, 1e-6),
    multislice_propagation_distance=5e-8,
)


@pytest.mark.parametrize("layout", ["batches", "whole_scan", "multislice_batches"])
def test_update_preconditioners_matches_jax(layout):
    """With batches: the FFT formulation for one slice and the gather one
    summed batch by batch for three, complex64 as in tike_tpu; without: the
    gather one over the whole scan, float32. Both sum many float32 terms in
    different orders (tests/test_torch_precond.py's tolerance)."""
    geometry = MULTISLICE if layout.startswith("multislice") else dict(nz=Hh, n=Hh)
    gen = H.rng(11)
    nz, n, d = geometry["nz"], geometry["n"], geometry.get("nslices", 1)
    psi = (0.9 + 0.1 * H.crandn(gen, d, nz, n)).astype(np.complex64)
    probe = H.crandn(gen, 1, 1, 2, P, P)
    scan = np.stack(
        [gen.uniform(2, nz - P - 3, 50), gen.uniform(2, n - P - 3, 50)], -1
    ).astype(np.float32)
    batches = None if layout == "whole_scan" else jcluster.batches_padded(
        jcluster.wobbly_center(scan, 3)
    )
    out = []
    for pkg, config in (("tike_tpu", JConfig), ("tike_tpu_torch", TConfig)):
        ptycho = importlib.import_module(pkg + ".ptycho")
        params = ptycho.PtychoParameters(
            probe=probe, psi=psi, scan=scan, object_options=ptycho.ObjectOptions(),
            probe_options=ptycho.ProbeOptions(),
        )
        if pkg == "tike_tpu_torch":
            params = params.copy_to_device("cpu")
        cfg = config(probe_shape=P, detector_shape=DET, **geometry)
        params = ptycho.solvers.update_preconditioners(cfg, params, batches)
        out.append((params.object_options.preconditioner, params.probe_options.preconditioner))
    (jpsi, jprobe), (tpsi, tprobe) = out
    for got, want, shape in ((tpsi, jpsi, (d, nz, n)), (tprobe, jprobe, (d, P, P))):
        assert tuple(got.shape) == shape and H.n(got).dtype == H.n(want).dtype
        H.assert_close(got, want, rtol=1e-4, atol=1e-5, scale=True)


def test_solver_functions_shadow_their_modules():
    """``solvers.rpie`` is the per-epoch function, as in tike_tpu; the
    module of the same name is still reached by importlib."""
    import tike_tpu_torch.ptycho as tp

    module = importlib.import_module("tike_tpu_torch.ptycho.solvers.rpie")
    assert callable(tp.solvers.rpie) and tp.solvers.rpie is module.rpie
    assert tp.rpie is module.rpie and tp.lstsq_grad is tp.solvers.lstsq_grad
    assert callable(module._batch_gradients_math)


def test_host_parameters_go_to_the_card(monkeypatch, slice_data):
    """Host arrays go to the card, the entry points' default; without one
    that raises rather than running on the CPU. LSQML refuses several
    slices."""
    import tike_tpu_torch.ptycho as tp

    scan, probe, psi0, data = slice_data
    params = _parameters(tp, scan, probe, psi0, "rpie_compact")
    cfg = TConfig(probe_shape=P, detector_shape=DET, nz=Hh, n=Hh)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tp.update_preconditioners(cfg, params)
    assert isinstance(params.psi, np.ndarray)
    multislice = TConfig(probe_shape=P, detector_shape=DET, **MULTISLICE)
    with pytest.raises(ValueError, match="single-slice"):
        tp.lstsq_grad(params, data, _batches(scan, "wobbly_center", False), op=multislice, epoch=0)
