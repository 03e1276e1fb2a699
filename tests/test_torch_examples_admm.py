"""The port's joint-ADMM example and quality script against the JAX
package's, on the CPU.

- ``examples/torch/admm.py`` at a small size (n 16, a probe of 8, 4
  angles, 40 positions, 2 iterations): its problem against the JAX
  example's computation of the same (the projections and the intensities
  at 1e-5), then the same inputs through ``tike_tpu.admm.
  reconstruct_joint_admm`` and the example's run, at the tolerances of
  ``tests/test_torch_admm.py``: each angle's rPIE is seeded in both
  packages (it is unseeded in both, and two compact batches may be drawn
  otherwise), and both volume fits take one CG step (from two on, cgrad's
  line search decides on ties, ROADMAP.md section 3); then psi, the
  volume and the costs of both iterations agree at LOOSE (1e-4).
- ``scripts/torch/admm_quality.py``'s ``setup_problem`` at n 24 against
  ``scripts/admm_quality.py``'s: theta and the phantom bit for bit, the
  true transmissions and the intensities at 1e-5, for both phantoms.
"""

import functools

import numpy as np
import pytest

import tike_tpu.admm as jadmm
import tike_tpu.lamino as jl
import tike_tpu.ptycho as jp
from tike_tpu.constants import wavelength

import tike_tpu_torch.admm as tadmm
import tike_tpu_torch.ptycho as tp
from tike_tpu_torch import convert

from . import _torch_examples_cases as X
from . import _torch_parity as H

TIGHT, LOOSE = 1e-5, 1e-4
SMALL = X.SMALL_ADMM


def _close(got, want, tol):
    H.assert_close(got, want, rtol=tol, atol=tol, scale=True)


@pytest.fixture(scope="module")
def example():
    return X.load("examples", "admm")


@pytest.fixture(scope="module")
def problem(example):
    return example.problem(SMALL["n"], SMALL["P"], SMALL["T"], SMALL["NPOS"], device="cpu")


def test_problem_matches_the_jax_example_s(example, problem):
    obj_true, theta, data, params = problem
    proj = jl.simulate(obj_true, theta, tilt=np.pi / 2)
    psis = np.exp(
        1j * 2 * np.pi / wavelength(example.ENERGY) * np.asarray(proj) * example.VOXELSIZE
    ).astype(np.complex64)
    probe, scan = params[0].probe, params[0].scan
    for t, d in enumerate(data):
        want = np.asarray(jp.simulate(SMALL["P"], probe, scan, psis[t][None]))
        _close(d, want, TIGHT)
    assert len(params) == SMALL["T"] and data[0].shape == (SMALL["NPOS"], SMALL["P"], SMALL["P"])


def _jax_parameters(params):
    return [
        jp.PtychoParameters(
            probe=p.probe.copy(), psi=np.asarray(p.psi).copy(), scan=p.scan.copy(),
            algorithm_options=jp.RpieOptions(num_batch=2, num_iter=2, batch_method="compact"),
            object_options=jp.ObjectOptions(),
            probe_options=jp.ProbeOptions(init_rescale_from_measurements=False),
        )
        for p in params
    ]


def _seeded_jax_reconstruct(data, parameters):
    """``tike_tpu.ptycho.reconstruct`` with its batches drawn from seed 0,
    as the port's ``Reconstruction(random_seed=0)`` draws them."""
    with jp.Reconstruction(data, parameters, random_seed=0) as context:
        context.iterate(parameters.algorithm_options.num_iter)
        return context.get_result()


def test_example_matches_jax_admm(example, problem, monkeypatch):
    obj_true, theta, data, params = problem
    monkeypatch.setattr(jp, "reconstruct", _seeded_jax_reconstruct)
    monkeypatch.setattr(tp, "Reconstruction", functools.partial(tp.Reconstruction, random_seed=0))
    jfit, tfit = jl.reconstruct, tadmm.lamino_reconstruct
    monkeypatch.setattr(jl, "reconstruct", lambda **kw: jfit(**kw, cg_iter=1))
    monkeypatch.setattr(tadmm, "lamino_reconstruct", lambda **kw: tfit(**kw, cg_iter=1))
    want = convert.admm_result_to_numpy(jadmm.reconstruct_joint_admm(
        data, _jax_parameters(params), theta, tilt=np.pi / 2, voxelsize=example.VOXELSIZE,
        energy=example.ENERGY, num_iter=SMALL["num_iter"], ptycho_iter=3, lamino_iter=4,
    ))
    out = example.run(**SMALL, device="cpu")
    got = convert.admm_result_to_numpy(out["result"])
    assert np.all(np.isfinite(got["costs"])) and got["costs"][-1] < got["costs"][0]
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=LOOSE)
    _close(got["psi"], want["psi"], LOOSE)
    _close(got["obj"], want["obj"], LOOSE)
    assert out["corr"] == pytest.approx(example.correlation(want["obj"], obj_true), abs=LOOSE)


@pytest.mark.parametrize("phantom", ["cube", "blobs"])
def test_quality_problem_matches_the_jax_script_s(phantom):
    sizes = dict(n=24, T=4, P=16, NPOS=30)
    want = X.load_reference("scripts", "admm_quality").setup_problem(phantom, **sizes)
    got = X.load("scripts", "admm_quality").setup_problem(phantom, **sizes, device="cpu")
    obj_true, theta, psi_true, data, params, voxelsize, energy = got
    np.testing.assert_array_equal(theta, want[1])
    np.testing.assert_array_equal(obj_true, want[0])
    _close(psi_true, want[2], TIGHT)
    for d, w in zip(data, want[3]):
        _close(d, w, TIGHT)
    assert (voxelsize, energy) == want[5:]
    np.testing.assert_array_equal(params[0].scan, want[4][0].scan)
    np.testing.assert_array_equal(params[0].probe, want[4][0].probe)
