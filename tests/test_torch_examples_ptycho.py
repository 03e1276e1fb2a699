"""The port's ptychography example (``examples/torch/ptycho.py``) against
the JAX package's (``examples/ptycho.py``), on the CPU.

- Start: ``load_dataset()`` gives the JAX example's patterns, positions and
  object bit for bit, and its probe up to each mode's phase: the
  orthogonalization leaves an eigenvector's phase to LAPACK in
  ``tike_tpu`` (ROADMAP.md section 3). Both stages below start from the
  JAX example's probe.
- rPIE stage: 2 epochs on the first 65 patterns from the constant 0.5
  object, held to the reference's own sensitivity, as
  ``tests/test_torch_siemens.py`` holds rPIE on these data: moving the
  reference's start by one float32 ulp must move its result at least half
  as far as the port is from it.
- LSQML stage (two eigen probes over the 5 modes, position correction,
  ``convergence_window=8``): 2 epochs from the JAX rPIE stage's result,
  both packages' eigen probes drawn from seed 0 and tike_tpu's affine
  position fit seeded as the port seeds its own; costs, fields, eigen
  state and positions at ``_torch_parity.SLICE_TOL`` (1e-5), the
  tolerance of ``tests/test_torch_opr.py``. 65 patterns make 5 compact
  batches of 13, so that no batch is padded (with padding, tike_tpu drops
  the eigen-weight update of each position a padded slot repeats, and the
  port does not: ROADMAP.md section 3).
The bz2 archive is decompressed once for both examples.
"""

import io
import types

import numpy as np
import pytest

import tike_tpu.ptycho as jp

import tike_tpu_torch.ptycho as tp
from tike_tpu_torch import convert

from . import _torch_examples_cases as X
from . import _torch_parity as H

SMALL = X.SMALL_PTYCHO


@pytest.fixture(scope="module")
def examples():
    """Both examples, loading the archive from one decompressed copy."""
    import bz2

    reference, port = X.load_reference("examples", "ptycho"), X.load("examples", "ptycho")
    with bz2.open(port.DATA, "rb") as f:
        raw = f.read()
    cached = types.SimpleNamespace(open=lambda path, mode="rb": io.BytesIO(raw))
    reference.bz2 = port.bz2 = cached
    return reference, port


@pytest.fixture(scope="module")
def datasets(examples):
    reference, port = examples
    return reference.load_dataset(), port.load_dataset(device="cpu")


@pytest.fixture(scope="module")
def subset(datasets):
    """The JAX example's start on its first patterns."""
    (data, scan, probe, psi), _ = datasets
    n = SMALL["patterns"]
    return data[:n], scan[:n], probe, psi


def _jax_rpie(data, scan, probe, psi, epochs):
    params = jp.PtychoParameters(
        probe=probe, psi=psi, scan=scan,
        algorithm_options=jp.RpieOptions(num_batch=5, num_iter=epochs),
        object_options=jp.ObjectOptions(), probe_options=jp.ProbeOptions(),
    )
    with jp.Reconstruction(data, params, random_seed=0) as context:
        context.iterate(epochs)
        return convert.parameters_to_numpy(context.get_result())


@pytest.fixture(scope="module")
def rpie_runs(examples, subset):
    _, port = examples
    data, scan, probe, psi = subset
    epochs = SMALL["rpie_iter"]
    want = _jax_rpie(data, scan, probe, psi, epochs)
    gen = H.rng(1)
    nudged = _jax_rpie(data, scan, H.one_ulp(gen, probe), H.one_ulp(gen, psi), epochs)
    got = port.rpie_stage(data, scan, probe, psi, epochs, device="cpu")
    return convert.parameters_to_numpy(got), want, nudged


def test_load_dataset_matches_the_jax_example(datasets):
    (jdata, jscan, jprobe, jpsi), (data, scan, probe, psi) = datasets
    assert data.shape == (516, 128, 128) and probe.shape == (1, 1, 5, 128, 128)
    np.testing.assert_array_equal(data, jdata)
    np.testing.assert_array_equal(scan, jscan)
    np.testing.assert_array_equal(psi, jpsi)
    assert probe.dtype == np.complex64
    H.assert_close(H.phase_aligned(probe, jprobe), jprobe, rtol=1e-5, atol=1e-5, scale=True)


def test_rpie_stage_within_the_reference_s_own_sensitivity(rpie_runs):
    got, want, nudged = rpie_runs
    costs = np.ravel(got["costs"])
    assert len(costs) == SMALL["rpie_iter"]
    assert np.all(np.isfinite(costs)) and np.all(np.diff(costs) < 0)
    gap = np.max(np.abs(costs / np.ravel(want["costs"]) - 1))
    own = np.max(np.abs(np.ravel(nudged["costs"]) / np.ravel(want["costs"]) - 1))
    assert gap <= max(2 * own, 1e-5), (gap, own)
    for key in ("psi", "probe"):
        gap = np.max(np.abs(got[key] - want[key]))
        own = np.max(np.abs(nudged[key] - want[key]))
        assert gap <= 2 * own, (key, gap, own)


def _lsqml_parameters(pkg, start, epochs):
    params = pkg.PtychoParameters(
        probe=start["probe"].copy(), psi=start["psi"].copy(), scan=start["scan"].copy(),
        algorithm_options=pkg.RpieOptions(num_batch=5, num_iter=epochs),
        object_options=pkg.ObjectOptions(), probe_options=pkg.ProbeOptions(),
    )
    return params


def test_lsqml_stage_matches_jax(examples, subset, rpie_runs, monkeypatch):
    """The JAX example's stage 2, seeded, against the port's
    ``lsqml_stage`` from the same start."""
    _, port = examples
    data = subset[0]
    _, start, _ = rpie_runs
    epochs = SMALL["lsqml_iter"]
    H.seed_jax_position_fit(monkeypatch)
    jparams = _lsqml_parameters(jp, start, epochs)
    jparams.eigen_probe, jparams.eigen_weights = jp.init_varying_probe(
        jparams.scan, jparams.probe, num_eigen_probes=2,
        probes_with_modes=jparams.probe.shape[-3], rng=np.random.default_rng(0),
    )
    jparams.position_options = jp.PositionOptions(
        initial_scan=jparams.scan.copy(), update_magnitude_limit=2.0
    )
    jparams.algorithm_options = jp.LstsqOptions(num_batch=5, num_iter=epochs,
                                                convergence_window=8)
    with jp.Reconstruction(data, jparams, random_seed=0) as context:
        context.iterate(epochs)
        want = convert.parameters_to_numpy(context.get_result())
    got = convert.parameters_to_numpy(
        port.lsqml_stage(data, _lsqml_parameters(tp, start, epochs), epochs, device="cpu")
    )
    costs = np.ravel(got["costs"])
    assert len(costs) == epochs and np.all(np.isfinite(costs)) and np.all(np.diff(costs) < 0)
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=H.SLICE_TOL)
    for key in ("psi", "probe", "eigen_probe", "eigen_weights"):
        H.assert_close(got[key], want[key], rtol=H.SLICE_TOL, atol=H.SLICE_TOL, scale=True)
    H.assert_close(got["scan"], want["scan"], rtol=0, atol=1e-4)


def test_figure_is_written_where_asked(rpie_runs, examples, tmp_path):
    pytest.importorskip("matplotlib")
    _, port = examples
    got, _, _ = rpie_runs
    params = types.SimpleNamespace(psi=got["psi"], probe=got["probe"])
    path = tmp_path / "ptycho.png"
    assert port.save_figure(params, str(path))
    assert path.stat().st_size > 0
