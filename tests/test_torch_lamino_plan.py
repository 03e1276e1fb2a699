"""Laminography with a ``LaminoPlan`` on the CPU: every operator and solver
handed the geometry's plan gives what it gives without one, bit for bit,
and what ``tike_tpu`` gives at the tolerances of ``test_torch_lamino.py``
and ``test_torch_lamino_solvers.py`` (1e-5 relative to the largest value
for the operators; 1e-4 for two outer iterations of a solver, which carry
the FFT libraries' rounding forward)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tike_tpu.lamino as jl
from tike_tpu.ops import lamino as jo
import tike_tpu_torch.lamino as tl
from tike_tpu_torch import convert
from tike_tpu_torch.lamino import solvers
from tike_tpu_torch.ops import lamino as to
from tike_tpu_torch.ops import usfft as tu

from ._torch_parity import assert_close, crandn, rng, t

TOL = 1e-5

N, NTHETA, TILT = 16, 8, np.pi / 3
OPERATOR_CASES = [(2, "kb", 1e-3), (1, "kb", 1e-3), (2, "gaussian", 1e-3)]


def _theta():
    return np.linspace(0, 2 * np.pi, NTHETA, endpoint=False).astype(np.float32)


@pytest.mark.parametrize("upsample, kernel, eps", OPERATOR_CASES)
def test_lamino_operators_with_a_plan(upsample, kernel, eps):
    """Every operator with a ``LaminoPlan`` equals the call without one bit
    for bit, and ``tike_tpu``'s at the operators' tolerance."""
    cfg = jo.LaminoConfig(n=N, tilt=TILT, eps=eps, upsample=upsample, kernel=kernel)
    cfg_t = convert.lamino_config_from_jax(cfg)
    gen = rng(5)
    u, d, theta = crandn(gen, N, N, N), crandn(gen, NTHETA, N, N), _theta()
    ju_, jd, jth = jnp.asarray(u), jnp.asarray(d), jnp.asarray(theta)
    tu_, td, tth = t(u), t(d), t(theta)
    plan = to.LaminoPlan(cfg_t, tth)
    for got, bare, want in (
        (to.lamino_fwd(cfg_t, tu_, tth, plan), to.lamino_fwd(cfg_t, tu_, tth),
         jo.lamino_fwd(cfg, ju_, jth)),
        (to.lamino_adj(cfg_t, td, tth, plan), to.lamino_adj(cfg_t, td, tth),
         jo.lamino_adj(cfg, jd, jth)),
        (to.lamino_adj_exact(cfg_t, td, tth, plan), to.lamino_adj_exact(cfg_t, td, tth),
         jo.lamino_adj_exact(cfg, jd, jth)),
        (to.lamino_grad(cfg_t, td, tth, tu_, plan), to.lamino_grad(cfg_t, td, tth, tu_),
         jo.lamino_grad(cfg, jd, jth, ju_)),
        (to.lamino_cost(cfg_t, td, tth, tu_, plan), to.lamino_cost(cfg_t, td, tth, tu_),
         jo.lamino_cost(cfg, jd, jth, ju_)),
        (to.lamino_step_scale(cfg_t, tu_, tth, plan), to.lamino_step_scale(cfg_t, tu_, tth),
         jo.lamino_step_scale(cfg, ju_, jth)),
    ):
        assert torch.equal(torch.view_as_real(got + 0j), torch.view_as_real(bare + 0j))
        assert_close(got, want, rtol=TOL, atol=TOL, scale=True)


def test_lamino_plan_holds_the_geometry():
    cfg = to.LaminoConfig(n=N, tilt=TILT, eps=1e-3, upsample=2)
    theta = t(_theta())
    plan = to.LaminoPlan(cfg, theta)
    assert plan.rows.shape == (NTHETA * N, N, 3)
    assert torch.equal(plan.rows.reshape(-1, 3), to.make_grids(theta, N, TILT))
    assert torch.equal(plan.rows_negated, -plan.rows)
    assert plan.rows is plan.rows  # built once
    assert torch.equal(plan.deapod, tu.deapodization(N, 1e-3, 2, "kb", torch.float32))
    # The KB plans are the kernels' and are built for CUDA tensors alone.
    assert plan.gather is None and plan.scatter is None and plan.scatter_negated is None
    with pytest.raises(ValueError, match="the plan is for"):
        to.lamino_fwd(
            dataclasses.replace(cfg, upsample=1), torch.zeros(N, N, N, dtype=torch.complex64),
            theta, plan,
        )
    with pytest.raises(ValueError, match="the plan is for"):
        to.lamino_adj(cfg, torch.zeros(4, N, N, dtype=torch.complex64), theta[:4], plan)


@pytest.mark.parametrize("algorithm, cg_iter", [("cgrad", 1), ("cgls", 4)])
def test_solvers_with_a_plan(algorithm, cg_iter):
    """A solver handed the geometry's plan gives what it gives without one,
    bit for bit, and ``reconstruct`` (which builds one) still agrees with
    ``tike_tpu``."""
    cfg = to.LaminoConfig(n=N, tilt=TILT, eps=1e-3, upsample=2)
    theta = _theta()
    gen = rng(9)
    envelope = np.exp(-((np.mgrid[0:N, 0:N, 0:N] - N / 2) ** 2).sum(0) / (N / 3) ** 2)
    volume = (crandn(gen, N, N, N) * envelope).astype(np.complex64)
    data = jl.simulate(volume, theta, TILT, eps=1e-3, upsample=2)
    solver = getattr(solvers, algorithm)
    start = torch.zeros((N, N, N), dtype=torch.complex64)
    bare = solver(cfg, t(data), t(theta), obj=start, cg_iter=cg_iter)
    planned = solver(cfg, t(data), t(theta), obj=start, cg_iter=cg_iter,
                     plan=to.LaminoPlan(cfg, t(theta)))
    assert planned["cost"] == bare["cost"]
    assert torch.equal(torch.view_as_real(planned["obj"]), torch.view_as_real(bare["obj"]))
    kwargs = dict(algorithm=algorithm, num_iter=2, eps=1e-3, upsample=2, cg_iter=cg_iter)
    want = jl.reconstruct(data, theta, TILT, **kwargs)
    got = tl.reconstruct(data, theta, TILT, device="cpu", **kwargs)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-4)
    assert_close(got["obj"], want["obj"], rtol=1e-4, atol=1e-4, scale=True)
