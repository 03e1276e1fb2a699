"""The port's demo scripts (``scripts/torch/striped_demo.py`` and
``longaxis_demo.py``) against ``tike_tpu``, on the CPU.

- striped demo: its problem at 512^2 and 256 patterns on two CPU shards
  for 2 epochs, against ``tike_tpu``'s striped ``Reconstruction`` on
  ``make_mesh(2)`` from the same inputs and seed, at the tolerance of
  ``tests/test_torch_striped.py`` (``_torch_parity.SLICE_TOL``).
- long-axis demo: ``bench_all.py``'s ``stream_1m`` problem cut to 2,000
  patterns of 64^2 on a 512^2 object (the pattern count and object size
  are the cuts; detector, probe, batches and options are the demo's):
  streamed equal to resident bit for bit, and against ``tike_tpu``'s
  streamed run as ``tests/test_torch_stream.py`` holds one from a constant
  start: at 1e-5 or, where that fails, within twice what one float32 ulp
  on the reference's start moves the reference (the random patterns and
  the constant 0.5 object leave far-field pixels modeled near 0, where the
  Gaussian gradient carries float32 rounding; ROADMAP.md section 3).
"""

import numpy as np
import pytest

import tike_tpu.parallel as jpar
import tike_tpu.ptycho as jp

import tike_tpu_torch.parallel as tpar
from tike_tpu_torch import convert

from . import _torch_examples_cases as X
from . import _torch_parity as H
from . import _torch_striped_cases as C

STRIPED = dict(H=512, NPOS=256, epochs=2)
LONGAXIS = dict(n_patterns=2000, det=64, hw=512)


def _jax_parameters(params):
    """``tike_tpu``'s parameters with the port's arrays and options."""
    algo = params.algorithm_options
    options = jp.RpieOptions(num_batch=algo.num_batch, num_iter=algo.num_iter,
                             batch_method=algo.batch_method)
    return jp.PtychoParameters(
        probe=params.probe.copy(), psi=params.psi.copy(), scan=params.scan.copy(),
        algorithm_options=options, object_options=jp.ObjectOptions(),
        probe_options=jp.ProbeOptions(
            init_rescale_from_measurements=params.probe_options.init_rescale_from_measurements
        ),
    )


def test_striped_demo_matches_jax():
    demo = X.load("scripts", "striped_demo")
    record, result = demo.run(**STRIPED, mesh=tpar.make_mesh(devices=["cpu"] * 2), device="cpu")
    assert record["devices"] == 2 and record["epochs"] == STRIPED["epochs"]
    assert record["interior_corr_vs_truth"] > 0.9
    psi_true, probe, scan, data = demo.problem(STRIPED["H"], STRIPED["NPOS"], device="cpu")
    params = demo.parameters(probe, psi_true, scan, STRIPED["epochs"])
    with jp.Reconstruction(data, _jax_parameters(params), mesh=jpar.make_mesh(2),
                           object_sharding="striped", random_seed=0) as context:
        context.iterate(STRIPED["epochs"])
        want = convert.parameters_to_numpy(context.get_result())
    C.check(convert.parameters_to_numpy(result), want, keys=("psi", "probe"))


@pytest.fixture(scope="module")
def longaxis():
    return X.load("scripts", "longaxis_demo")


def test_longaxis_streamed_equals_resident(longaxis):
    runs = [longaxis.run(**LONGAXIS, store_data_on_device=store, device="cpu")
            for store in (False, True)]
    (streamed, got), (resident, want) = runs
    assert streamed["streamed"] and not resident["streamed"]
    assert streamed["costs"] == resident["costs"] and np.isfinite(streamed["costs"][0])
    for key in ("psi", "probe"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))


def test_longaxis_matches_jax_streamed(longaxis):
    record, result = longaxis.run(**LONGAXIS, device="cpu")
    data, params = longaxis.problem(**LONGAXIS)

    def run_jax(probe, psi):
        jparams = _jax_parameters(params)
        jparams.probe, jparams.psi = probe, psi
        with jp.Reconstruction(data, jparams, store_data_on_device=False,
                               random_seed=0) as context:
            assert isinstance(context.data, np.ndarray)  # host-resident
            context.iterate(1)
            return convert.parameters_to_numpy(context.get_result())

    want = run_jax(params.probe, params.psi)
    gen = H.rng(1)
    nudged = run_jax(H.one_ulp(gen, params.probe), H.one_ulp(gen, params.psi))
    got = convert.parameters_to_numpy(result)
    assert np.all(np.isfinite(got["costs"]))
    relative = lambda x, key: np.max(
        np.abs(np.ravel(x[key]) - np.ravel(want[key]))
    ) / np.max(np.abs(np.ravel(want[key])))
    for key in ("costs", "psi", "probe"):
        gap, own = relative(got, key), relative(nudged, key)
        assert gap <= max(2 * own, 1e-5), (key, gap, own)
    assert record["host_data_gb"] == pytest.approx(data.nbytes / 2**30, abs=1e-3)


def test_longaxis_report_goes_where_asked(longaxis, tmp_path):
    path = tmp_path / "report.md"
    record, _ = longaxis.run(n_patterns=200, det=64, hw=256, device="cpu")
    path.write_text(longaxis.report(record))
    assert "200 x 64x64" in path.read_text()
