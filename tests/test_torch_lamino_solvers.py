"""tike_tpu_torch's laminography solvers against tike_tpu's on the CPU.

The same numpy inputs (``tests/test_torch_lamino.py``'s 16^3 volume at 8
angles) go through ``tike_tpu.lamino.reconstruct`` and the port's, which
runs its plain PyTorch versions, and through the CG pieces of both
``opt`` modules.

Tolerances: 1e-5 relative (the operators' own, with no floor flips), in
settings whose line-search decisions are not ties. cgrad's backtracking
doubles the step after a first-try success, and on this quadratic cost a
doubled optimal step lands where the new cost equals the old, so a trial's
accept-or-halve decision there follows the last bits of two FFT libraries
(``test_cgrad_line_search_margins`` measures each trial's margin). The
costs at ``upsample=1`` take ``COST_TOL_1``.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tike_tpu.lamino as jl
import tike_tpu.opt as jopt
from tike_tpu.ops import lamino as jo
from tike_tpu_torch import opt as topt
from tike_tpu_torch.ops import lamino as to
import tike_tpu_torch.lamino as tl

from ._torch_parity import assert_close, crandn, rng, t
from .test_torch_lamino import N, NTHETA, TILT, TOL, _configs, _smooth_object, _theta

# (algorithm, cg_iter): cgrad takes one CG step per outer iteration (see the
# module's docstring); CGLS the bench's 4.
SOLVER_CASES = [("cgrad", 1), ("cgls", 4)]
# Costs at upsample 1, relative: no floor flips (test_make_grids_floor_flips),
# but CGLS drives the cost to 0.4% of |data|^2 through a residual it updates
# incrementally, so the cost loses digits to cancellation (measured 5.7e-5
# after 3 outer iterations; the volume still agrees to 4e-6, and at
# upsample 2 the costs to 4e-6).
COST_TOL_1 = 1e-4


@pytest.mark.parametrize("upsample", [2, 1])
@pytest.mark.parametrize("algorithm, cg_iter", SOLVER_CASES)
def test_reconstruct_matches(algorithm, cg_iter, upsample):
    theta = _theta(NTHETA, np.pi)
    data = jl.simulate(_smooth_object(), theta, TILT, eps=1e-3, upsample=upsample)
    kwargs = dict(algorithm=algorithm, num_iter=3, eps=1e-3, upsample=upsample, cg_iter=cg_iter)
    want = jl.reconstruct(data, theta, TILT, **kwargs)
    got = tl.reconstruct(data, theta, TILT, device="cpu", **kwargs)
    assert len(got["cost"]) == 3 and np.all(np.diff(got["cost"]) < 0)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=TOL if upsample == 2 else COST_TOL_1)
    assert_close(got["obj"], want["obj"], rtol=TOL, atol=TOL, scale=True)
    assert got["obj"].dtype == np.complex64
    if algorithm == "cgrad":
        assert got["step_length"] == pytest.approx(want["step_length"], rel=TOL)


def test_cgrad_line_search_margins(monkeypatch):
    """Every trial of the cgrad parity case is decided by a margin of at
    least 1e-3 of the cost, far above the ~1e-6 the two packages' costs
    differ by; at cg_iter 2 the doubled step lands within ~1e-5 of a tie."""
    original = topt.line_search
    margins = []

    def recording(f, x, d, step_length, cost, linesearch_iterations=4):
        def f_recorded(u):
            c = f(u)
            margins.append(abs(float(c) / float(cost) - 1))
            return c

        return original(f_recorded, x, d, step_length, cost, linesearch_iterations)

    monkeypatch.setattr(topt, "line_search", recording)
    theta = _theta(NTHETA, np.pi)
    data = jl.simulate(_smooth_object(), theta, TILT, eps=1e-3, upsample=2)
    for cg_iter, least in ((1, 1e-3), (2, None)):
        margins.clear()
        tl.reconstruct(data, theta, TILT, algorithm="cgrad", num_iter=3, upsample=2,
                       cg_iter=cg_iter, device="cpu")
        if least is not None:
            assert min(margins) > least
        else:
            assert min(margins) < 1e-4


def test_line_search_and_direction_match():
    cfg, cfg_t = _configs(2)
    theta = _theta()
    gen = rng(7)
    d, x = crandn(gen, NTHETA, N, N), 0.1 * crandn(gen, N, N, N)
    dir_ = -0.5 * crandn(gen, N, N, N)
    g0, g1 = crandn(gen, N, N, N), crandn(gen, N, N, N)
    assert_close(
        topt.direction_dy(t(g0), t(g1), t(dir_)),
        jopt.direction_dy(jnp.asarray(g0), jnp.asarray(g1), jnp.asarray(dir_)),
        rtol=TOL, atol=TOL, scale=True,
    )
    jf = lambda u: jo.lamino_cost(cfg, jnp.asarray(d), jnp.asarray(theta), u)  # noqa: E731
    tf = lambda u: to.lamino_cost(cfg_t, t(d), t(theta), u)  # noqa: E731
    for step in (1e-3, 1e3, 1e6):
        cost = jf(jnp.asarray(x))
        js, jc, jx = jopt.line_search_traced(jf, jnp.asarray(x), jnp.asarray(dir_), step, cost)
        ts, tc, tx = topt.line_search(tf, t(x), t(dir_), step, tf(t(x)))
        assert ts == pytest.approx(float(js), rel=1e-7)
        assert float(tc) == pytest.approx(float(jc), rel=TOL)
        assert_close(tx, jx, rtol=TOL, atol=TOL, scale=True)
    # A step too long for 4 halvings fails: x stays and the next step is 0.
    ts, tc, tx = topt.line_search(tf, t(x), t(dir_), 1e6, tf(t(x)))
    assert ts == 0.0 and torch.equal(tx, t(x))


def test_cgls_matches_on_a_small_linear_problem():
    gen = rng(8)
    A = gen.standard_normal((30, 12)).astype(np.float32)
    b = gen.standard_normal(30).astype(np.float32)
    want = jopt.cgls_traced(lambda x: A @ x, lambda r: A.T @ r, jnp.asarray(b), jnp.zeros(12), 6)
    At = t(A)
    got = topt.cgls(lambda x: At @ x, lambda r: At.T @ r, t(b), torch.zeros(12), 6)
    assert_close(got[0], want[0], rtol=1e-4, atol=1e-5, scale=True)
    assert float(got[1]) == pytest.approx(float(want[1]), rel=1e-4)


def test_reconstruct_refuses_what_is_not_ported():
    data = np.zeros((NTHETA, N, N), np.complex64)
    # A mesh runs (tests/test_torch_mesh_lamino.py); one that is not a
    # tike_tpu_torch.parallel.Mesh raises.
    with pytest.raises(TypeError, match="mesh"):
        tl.reconstruct(data, _theta(), TILT, "cgrad", mesh=object(), device="cpu")
    # Bucket laminography has its own driver: the reference's ValueError,
    # sending the caller to the port's module, not to the other package's.
    with pytest.raises(ValueError, match="Use tike_tpu_torch.lamino.bucket.reconstruct") as e:
        tl.reconstruct(data, _theta(), TILT, "bucket", device="cpu")
    assert "tike_tpu." not in str(e.value)
    with pytest.raises(ValueError, match="Use tike_tpu.lamino.bucket.reconstruct"):
        jl.reconstruct(data, _theta(), TILT, "bucket")
    with pytest.raises(ValueError, match="not an available"):
        tl.reconstruct(data, _theta(), TILT, "sirt", device="cpu")


def test_entry_points_default_to_the_card():
    for fn in (tl.simulate, tl.reconstruct):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_line_search_counts_its_host_reads():
    theta = _theta(NTHETA, np.pi)
    data = jl.simulate(_smooth_object(), theta, TILT, eps=1e-3, upsample=2)
    topt.HOST_READS["line_search"] = 0
    tl.reconstruct(data, theta, TILT, "cgrad", num_iter=2, upsample=2, cg_iter=2, device="cpu")
    # At least one trial per CG step: 2 outer x 2 inner.
    assert topt.HOST_READS["line_search"] >= 4
    topt.HOST_READS["line_search"] = 0
    tl.reconstruct(data, theta, TILT, "cgls", num_iter=2, upsample=2, device="cpu")
    assert topt.HOST_READS["line_search"] == 0


