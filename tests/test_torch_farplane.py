"""The Gaussian model's far-field step (``ops/objective.py::
gaussian_farplane``) on the CPU: its plain version against tike_tpu's
objective, the dispatch by device, what the kernel's wrapper refuses before
any launch, and the solvers' use of it (the Gaussian branch of LSQML and
rPIE goes through it; the Poisson branch never does). The kernel itself is
held to the plain version on the card (``test_torch_farplane_cuda.py``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tike_tpu.ops.objective import ELEMENTWISE as J_ELEMENTWISE
from tike_tpu.ops.objective import GRAD as J_GRAD
from tike_tpu.ops.ptycho import intensity_from_farplane as j_intensity
from tike_tpu.ptycho.solvers.rpie import _masked_mean_each_pattern as j_masked_mean

from tike_tpu_torch.ops import objective
from tike_tpu_torch.ops.ptycho import PtychoConfig as TConfig

from . import _torch_farplane_cases as cases
from . import _torch_parity as H

tlstsq = importlib.import_module("tike_tpu_torch.ptycho.solvers.lstsq")
trpie = importlib.import_module("tike_tpu_torch.ptycho.solvers.rpie")


def _jax_step(data, farplane, mask, scaling):
    """tike_tpu's far-field step under the Gaussian model, as its solvers
    write it."""
    d, f, m = (jnp.asarray(H.n(x)) for x in (data, farplane, mask))
    intensity = j_intensity(f)
    costs = j_masked_mean(J_ELEMENTWISE["gaussian"](d, intensity), m)
    chi = jnp.where(m, -J_GRAD["gaussian"](d, f, intensity), f * (scaling - 1.0))
    return costs, chi


@pytest.mark.parametrize("name", list(cases.CASES))
def test_plain_matches_jax(name):
    data, farplane, mask, scaling = cases.case_inputs(name, "cpu", b=4)
    got = objective.gaussian_farplane_plain(data, farplane, mask, scaling)
    want = _jax_step(data, farplane, mask, scaling)
    for g, w in zip(got, want):
        H.assert_close(g, w, rtol=1e-5, atol=1e-6, scale=True)


@pytest.mark.parametrize("name", ["rpie 3 modes, unmeasured, s 0.5", "lsqml 1 mode"])
def test_cpu_takes_the_plain_version(name):
    data, farplane, mask, scaling = cases.case_inputs(name, "cpu", b=3)
    before = dict(objective.LAUNCHES)
    kept = farplane.clone()
    got = objective.gaussian_farplane(data, farplane, mask, scaling)
    want = objective.gaussian_farplane_plain(data, kept, mask, scaling)
    assert objective.LAUNCHES == before
    assert torch.equal(farplane, kept)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_mixed_devices_raise():
    data, farplane, mask, scaling = cases.case_inputs("lsqml 1 mode", "cpu", b=2)
    with pytest.raises(ValueError, match="one device"):
        objective.gaussian_farplane(data.to("meta"), farplane, mask, scaling)


def _bad(name):
    data, farplane, mask, scaling = cases.case_inputs("rpie 3 modes", "cpu", b=2)
    return {
        "farplane complex128": (data, farplane.to(torch.complex128), mask, scaling, "farplane"),
        "farplane float32": (data, farplane.real.contiguous(), mask, scaling, "farplane"),
        "farplane 2-D": (data, farplane[0, 0], mask, scaling, "farplane"),
        "farplane not square": (data, farplane[..., :-1, :], mask, scaling, "farplane"),
        "no modes": (data, farplane[:, :0], mask, scaling, "farplane"),
        "data float64": (data.double(), farplane, mask, scaling, "data"),
        "data of another width": (data[..., :-1], farplane, mask, scaling, "data"),
        "data of another batch": (data[:1], farplane, mask, scaling, "data"),
        "mask uint8": (data, farplane, mask.to(torch.uint8), scaling, "measured_pixels"),
        "mask of another width": (data, farplane, mask[:-1], scaling, "measured_pixels"),
        "scaling a tensor": (data, farplane, mask, torch.tensor(0.5), "unmeasured_pixels_scaling"),
        "scaling a bool": (data, farplane, mask, True, "unmeasured_pixels_scaling"),
        "on the CPU": (data, farplane, mask, scaling, "CUDA tensor"),
    }[name]


@pytest.mark.parametrize(
    "name",
    [
        "farplane complex128", "farplane float32", "farplane 2-D", "farplane not square", "no modes",
        "data float64",
        "data of another width", "data of another batch", "mask uint8", "mask of another width",
        "scaling a tensor", "scaling a bool", "on the CPU",
    ],
)
def test_kernel_wrapper_refuses_before_launching(name):
    *args, match = _bad(name)
    before = dict(objective.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        objective.gaussian_farplane_cuda(*args)
    assert objective.LAUNCHES == before


# One small batch of each solver: 3 modes on a 64^2 object, 16^2 probe,
# 24^2 detector, some pixels unmeasured.
HW, P, DET, NPOS, B = 64, 16, 24, 30, 10


@pytest.fixture(scope="module")
def batch():
    gen = H.rng(31)
    psi = (0.5 + 0.1 * H.crandn(gen, 1, HW, HW)).astype(np.complex64)
    probe = H.crandn(gen, 1, 1, 3, P, P)
    scan = H.positions(gen, NPOS, HW, HW, P)
    idx = gen.permutation(NPOS)[:B]
    bmask = np.ones(B, np.float32)
    bmask[-2:] = 0
    data = gen.uniform(0.0, 2.0, (B, DET, DET)).astype(np.float32)
    mp = gen.random((DET, DET)) > 0.1
    cfg = TConfig(probe_shape=P, detector_shape=DET, nz=HW, n=HW)
    t = [H.t(a) for a in (data, scan, idx, bmask, psi, probe)]
    t[2] = t[2].long()
    return cfg, t, H.t(mp), torch.ones((1, HW, HW), dtype=torch.complex64)


def _run(solver, batch, noise_model, usemodes="all_modes"):
    cfg, (data, scan, idx, bmask, psi, probe), mp, pre = batch
    if solver == "lstsq":
        return tlstsq._lstsq_batch_math(
            cfg, data, scan, idx, bmask, psi, probe, None, None, mp, pre, 0.5, 0.5, 0.8,
            num_batch=3.0, noise_model=noise_model, steplength_usemodes=usemodes,
            recover_psi=True, recover_probe=True, recover_positions=False,
        )
    return trpie._batch_gradients_math(
        cfg, data, scan, idx, bmask, psi, probe[:, :1], None, None, mp, 0.5, 0.5, 0.8,
        noise_model=noise_model, steplength_usemodes=usemodes, recover_probe=True,
    )


def _results(out):
    return list(out.values()) if isinstance(out, dict) else list(out)


@pytest.mark.parametrize("solver, module", [("lstsq", tlstsq), ("rpie", trpie)])
def test_gaussian_branch_takes_the_step_once_a_batch(batch, monkeypatch, solver, module):
    want = _results(_run(solver, batch, "gaussian"))
    calls = []

    def step(*args, **kwargs):
        calls.append(kwargs)
        return objective.gaussian_farplane(*args, **kwargs)

    monkeypatch.setattr(module, "gaussian_farplane", step)
    got = _results(_run(solver, batch, "gaussian"))
    assert calls == [{}]
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.parametrize("usemodes", ["all_modes", "dominant_mode"])
@pytest.mark.parametrize("solver, module", [("lstsq", tlstsq), ("rpie", trpie)])
def test_poisson_branch_bypasses_the_step(batch, monkeypatch, solver, module, usemodes):
    def refuse(*args, **kwargs):
        raise AssertionError("the Poisson branch took the Gaussian step")

    monkeypatch.setattr(module, "gaussian_farplane", refuse)
    out = _results(_run(solver, batch, "poisson", usemodes))
    assert all(x is None or torch.isfinite(x).all() for x in out)


@pytest.mark.parametrize("solver", ["lstsq", "rpie"])
def test_unknown_noise_model_raises(batch, solver):
    with pytest.raises(KeyError, match="gauss"):
        _run(solver, batch, "gauss")
