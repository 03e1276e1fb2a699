"""The port's examples (``examples/torch/``) against the JAX package's
(``examples/``), on the CPU.

- scan: the port's example computes every waveform and trajectory that the
  JAX example computes (recorded from its own calls of ``tike_tpu.scan``),
  bit for bit.
- align: the JAX example's calls of ``tike_tpu.align`` recorded; the
  port's example at the same size gives the same simulated stack (1e-6)
  and the same shifts (atol 1e-6, as ``tests/test_torch_align.py``).
- lamino: the port's example at 16^3 and 8 angles against
  ``tike_tpu.lamino`` on the same inputs: simulate at 1e-5, cgrad's costs
  at 1e-4 with one CG step an outer iteration (from two on, the line
  search decides on ties; ROADMAP.md section 3), the Bucket operator and
  solver with the angles 0.1 rad off its ties
  (``tests/test_torch_bucket.py``).
Every example and script raises without a card unless asked for the CPU,
and so does every entry point they reach first (``precision.as_tensor``
checks the device, so a CPU-only PyTorch gives the same RuntimeError as a
CUDA build without a card).
"""

import types

import numpy as np
import pytest
import torch

import tike_tpu.align as jalign
import tike_tpu.lamino as jl
import tike_tpu.lamino.bucket as jbucket
import tike_tpu.scan as jscan

from . import _torch_examples_cases as X
from ._torch_parity import assert_close

TOL, COST_TOL = 1e-5, 1e-4


def test_scan_matches_the_jax_example(tmp_path, monkeypatch):
    reference = X.load_reference("examples", "scan")
    recorder = X.Recorder(jscan)
    monkeypatch.setattr(reference, "scan", recorder)
    monkeypatch.chdir(tmp_path)  # the JAX example saves its figure in the working directory
    reference.main()
    got = X.load("examples", "scan").main(figure=None, device="cpu")
    times, t2 = recorder.results("scantimes")
    np.testing.assert_array_equal(got["times"], times)
    np.testing.assert_array_equal(got["t2"], t2)
    assert len(got["waves"]) == 6 and len(got["trajectories"]) == 6
    for name, wave in got["waves"].items():
        (want,) = recorder.results(name)
        np.testing.assert_array_equal(wave, want, err_msg=name)
    for name, path in got["trajectories"].items():
        (want,) = recorder.results(name)
        for axis, w in zip(path, want):
            np.testing.assert_array_equal(axis, w, err_msg=name)


def test_scan_writes_its_figure_where_asked(tmp_path):
    pytest.importorskip("matplotlib")
    figure = tmp_path / "scan.png"
    X.load("examples", "scan").main(figure=str(figure), device="cpu")
    assert figure.stat().st_size > 0


def test_align_matches_the_jax_example(monkeypatch):
    reference = X.load_reference("examples", "align")
    recorder = X.Recorder(jalign)
    monkeypatch.setattr(reference, "tike_tpu", types.SimpleNamespace(align=recorder))
    reference.main()
    got = X.load("examples", "align").main(device="cpu")
    (unaligned,) = recorder.results("simulate")
    (result,) = recorder.results("reconstruct")
    assert_close(got["unaligned"], np.asarray(unaligned), rtol=TOL, atol=TOL, scale=True)
    np.testing.assert_allclose(got["shift"], np.asarray(result["shift"]), rtol=0, atol=1e-6)
    assert got["max_shift_error"] < 0.1 and got["residual"] < 0.05


@pytest.fixture(scope="module")
def lamino_runs():
    ex = X.load("examples", "lamino")
    small = X.SMALL_LAMINO
    got = ex.main(**small, device="cpu")
    obj, theta = ex.problem(small["n"], small["ntheta"], small["theta_shift"])
    data = jl.simulate(obj, theta, ex.TILT, eps=1e-6, upsample=2)
    want = jl.reconstruct(
        data, theta, ex.TILT, algorithm="cgrad", num_iter=small["num_iter"], rtol=1e-3,
        eps=1e-6, upsample=2, cg_iter=small["cg_iter"],
    )
    bdata = jbucket.simulate(obj, theta, ex.TILT, eps=0.2)
    bwant = jbucket.reconstruct(
        bdata, theta, ex.TILT, algorithm="bucket", num_iter=small["bucket_iter"], eps=0.2,
        cg_iter=small["cg_iter"],
    )
    return got, dict(data=data, obj=want["obj"], cost=want["cost"], bucket_data=bdata,
                     bucket_obj=bwant["obj"], bucket_cost=bwant["cost"])


def test_lamino_problem_is_the_jax_example_s():
    """At 32^3 and 32 angles the port's problem is the JAX example's
    volume and angles."""
    obj, theta = X.load("examples", "lamino").problem()
    want = np.zeros((32, 32, 32), dtype=np.complex64)
    want[8:24, 8:24, 8:24] = 1.0 + 0.5j
    want[12:20, 12:20, 12:20] = 0.2 - 0.1j
    np.testing.assert_array_equal(obj, want)
    np.testing.assert_array_equal(
        theta, np.linspace(0, 2 * np.pi, 32, endpoint=False).astype(np.float32)
    )


def test_lamino_usfft_matches_jax(lamino_runs):
    got, want = lamino_runs
    assert_close(got["data"], np.asarray(want["data"]), rtol=TOL, atol=TOL, scale=True)
    costs = np.asarray(got["cost"])
    assert np.all(np.isfinite(costs)) and np.all(np.diff(costs) < 0)
    np.testing.assert_allclose(costs, np.asarray(want["cost"]), rtol=COST_TOL)
    assert_close(got["obj"], np.asarray(want["obj"]), rtol=COST_TOL, atol=COST_TOL, scale=True)


def test_lamino_bucket_matches_jax(lamino_runs):
    got, want = lamino_runs
    assert_close(got["bucket_data"], np.asarray(want["bucket_data"]), rtol=TOL, atol=TOL,
                 scale=True)
    costs = np.asarray(got["bucket_cost"])
    assert np.all(np.isfinite(costs)) and costs[-1] < costs[0]
    np.testing.assert_allclose(costs, np.asarray(want["bucket_cost"]), rtol=TOL)
    assert_close(got["bucket_obj"], np.asarray(want["bucket_obj"]), rtol=TOL, atol=TOL,
                 scale=True)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
@pytest.mark.parametrize("name", ["scan", "align", "lamino", "ptycho", "admm"])
def test_examples_raise_without_a_card(name):
    with pytest.raises(RuntimeError, match="cuda"):
        X.load("examples", name).main()


NO_CARD = "checks the refusal without a card"
_VOLUME, _THETA = np.zeros((8, 8, 8), np.complex64), np.zeros(2, np.float32)


@pytest.mark.skipif(torch.cuda.is_available(), reason=NO_CARD)
@pytest.mark.parametrize("call", [
    lambda: X.load("scripts", "admm_quality").run(n=8, T=2, iters=1),
    lambda: X.load("scripts", "striped_demo").run(64, 8, 1),
    lambda: X.load("scripts", "longaxis_demo").run(n_patterns=8, det=16, hw=64),
], ids=["admm_quality", "striped_demo", "longaxis_demo"])
def test_scripts_raise_without_a_card(call):
    with pytest.raises(RuntimeError, match="cuda"):
        call()


@pytest.mark.skipif(torch.cuda.is_available(), reason=NO_CARD)
@pytest.mark.parametrize("name", ["lamino.simulate", "lamino.reconstruct", "bucket.simulate",
                                  "bucket.reconstruct", "adjust_probe_power"])
def test_entry_points_raise_without_a_card(name):
    import tike_tpu_torch.lamino as tl
    import tike_tpu_torch.lamino.bucket as tlb
    import tike_tpu_torch.ptycho as tp

    calls = {
        "lamino.simulate": lambda: tl.simulate(_VOLUME, _THETA, 1.0),
        "lamino.reconstruct": lambda: tl.reconstruct(_VOLUME[:2], _THETA, 1.0, "cgrad"),
        "bucket.simulate": lambda: tlb.simulate(_VOLUME, _THETA, 1.0),
        "bucket.reconstruct": lambda: tlb.reconstruct(_VOLUME[:2], _THETA, 1.0),
        "adjust_probe_power": lambda: tp.adjust_probe_power(np.ones((1, 1, 1, 8, 8),
                                                                    np.complex64)),
    }
    with pytest.raises(RuntimeError, match="device cuda was requested"):
        calls[name]()
