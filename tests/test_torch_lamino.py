"""tike_tpu_torch's laminography against tike_tpu's on the CPU.

The same numpy inputs (a 16^3 volume, 8 angles, tilt pi/3) go through
``tike_tpu.ops.lamino``/``tike_tpu.lamino`` and their counterparts in the
port, which run their plain PyTorch versions.

Tolerances. ``make_grids`` agrees with JAX bit for bit here (no point's
``floor(n x)`` differs), so the operators take the USFFT's 1e-5 relative to
the largest value, at ``upsample=2`` and at ``upsample=1`` alike; at
``upsample=1`` the 2-tap KB window is discontinuous (a tap at |d| = m still
weighs 1/I0(2) = 0.44), so one flipped floor would move a 0.44 weight, and
the flip count is asserted to be 0. The solvers are in
``tests/test_torch_lamino_solvers.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import tike_tpu.lamino as jl
from tike_tpu.ops import lamino as jo
from tike_tpu_torch import convert
from tike_tpu_torch.ops import lamino as to
import tike_tpu_torch.lamino as tl

from . import _torch_usfft_cases as cases
from ._torch_parity import assert_close, crandn, rng, t

TOL = 1e-5
N, NTHETA, TILT = 16, 8, np.pi / 3


def _theta(ntheta=NTHETA, span=2 * np.pi):
    return np.linspace(0, span, ntheta, endpoint=False).astype(np.float32)


def _configs(upsample, kernel="kb", eps=1e-3):
    cfg = jo.LaminoConfig(n=N, tilt=TILT, eps=eps, upsample=upsample, kernel=kernel)
    return cfg, convert.lamino_config_from_jax(cfg)


def _smooth_object(seed=0):
    """bench_all.py's volume recipe at n = 16: a Gaussian-windowed random
    complex volume."""
    gen = rng(seed)
    envelope = np.exp(-((np.mgrid[0:N, 0:N, 0:N] - N / 2) ** 2).sum(0) / (N / 3) ** 2)
    return (crandn(gen, N, N, N) * envelope).astype(np.complex64)


@pytest.mark.parametrize(
    "n_, ntheta, span",
    [(16, 8, 2 * np.pi), (16, 16, 2 * np.pi), (128, 64, np.pi)],
    ids=["test_lamino", "16-angles", "bench_all"],
)
def test_make_grids_floor_flips(n_, ntheta, span):
    """The port's grids against JAX's: how many points' floor(N x) differ at
    the transforms' grid sizes N = n (upsample 1) and 2n (upsample 2), at
    +x and -x (the reference adjoint's points)."""
    theta = _theta(ntheta, span)
    got = to.make_grids(t(theta), n_, TILT).numpy()
    want = np.asarray(jo.make_grids(jnp.asarray(theta), n_, TILT))
    assert got.shape == want.shape == (ntheta * n_ * n_, 3)
    flips = {
        (grid, sign): int(np.sum(np.floor(sign * grid * got) != np.floor(sign * grid * want)))
        for grid in (n_, 2 * n_)
        for sign in (1, -1)
    }
    assert flips == dict.fromkeys(flips, 0)
    equal = np.mean(got == want)
    if n_ == 16:
        assert equal == 1.0
    else:
        # JAX's float32 sin is one ulp off the nearest float at two of the
        # 64 angles; the port's trig is the nearest float (measured 0.98892).
        assert equal > 0.98
        np.testing.assert_allclose(got, want, rtol=0, atol=6e-8)


def test_make_grids_matches_the_kernel_formula():
    theta = np.array([0.3, 1.2], dtype=np.float32)
    xi = to.make_grids(t(theta), N, TILT).numpy()
    p, y, x = 1, 3, 7
    kv, ku = (y - N // 2) / N, (x - N // 2) / N
    ct, st = np.cos(theta[p]), np.sin(theta[p])
    want = [kv * np.sin(TILT), -ku * st + kv * ct * np.cos(TILT), ku * ct + kv * st * np.cos(TILT)]
    np.testing.assert_allclose(xi[(p * N + y) * N + x], want, rtol=1e-5, atol=1e-6)


OPERATOR_CASES = [(2, "kb", 1e-3), (1, "kb", 1e-3), (2, "kb", 1e-6), (2, "gaussian", 1e-3)]


@pytest.mark.parametrize("upsample, kernel, eps", OPERATOR_CASES)
def test_operators_match(upsample, kernel, eps):
    cfg, cfg_t = _configs(upsample, kernel, eps)
    gen = rng(5)
    u, d = crandn(gen, N, N, N), crandn(gen, NTHETA, N, N)
    theta = _theta()
    ju_, jd, jth = jnp.asarray(u), jnp.asarray(d), jnp.asarray(theta)
    tu_, td, tth = t(u), t(d), t(theta)
    for got, want in (
        (to.lamino_fwd(cfg_t, tu_, tth), jo.lamino_fwd(cfg, ju_, jth)),
        (to.lamino_adj(cfg_t, td, tth), jo.lamino_adj(cfg, jd, jth)),
        (to.lamino_adj_exact(cfg_t, td, tth), jo.lamino_adj_exact(cfg, jd, jth)),
        (to.lamino_grad(cfg_t, td, tth, tu_), jo.lamino_grad(cfg, jd, jth, ju_)),
    ):
        assert_close(got, want, rtol=TOL, atol=TOL, scale=True)
    assert_close(to.lamino_cost(cfg_t, td, tth, tu_), jo.lamino_cost(cfg, jd, jth, ju_), rtol=TOL)
    assert_close(
        to.lamino_step_scale(cfg_t, tu_, tth), jo.lamino_step_scale(cfg, ju_, jth), rtol=TOL
    )


@pytest.mark.parametrize("upsample", [1, 2])
def test_adjoints(upsample):
    """``lamino_adj_exact`` is the adjoint of ``lamino_fwd`` to float
    precision; ``lamino_adj`` is at eps 1e-6, upsample 2 (as in
    tests/test_lamino.py) and about 20% off at upsample 1 by design."""
    _, cfg_t = _configs(upsample, eps=1e-6 if upsample == 2 else 1e-3)
    gen = rng(6)
    u, d, theta = t(crandn(gen, N, N, N)), t(crandn(gen, NTHETA, N, N)), t(_theta())
    lhs = cases.inner64(to.lamino_fwd(cfg_t, u, theta), d)
    exact = cases.inner64(u, to.lamino_adj_exact(cfg_t, d, theta))
    assert abs(lhs - exact) / abs(lhs) < 1e-5
    ratio = lhs / cases.inner64(u, to.lamino_adj(cfg_t, d, theta))
    if upsample == 2:
        assert abs(ratio - 1) < 2e-3
    else:
        assert abs(ratio - 1) > 0.1


@pytest.mark.parametrize("upsample", [1, 2])
def test_simulate_matches(upsample):
    u, theta = _smooth_object(), _theta()
    got = tl.simulate(u, theta, TILT, eps=1e-3, upsample=upsample, device="cpu")
    want = jl.simulate(u, theta, TILT, eps=1e-3, upsample=upsample)
    assert got.dtype == np.complex64
    assert_close(got, want, rtol=TOL, atol=TOL, scale=True)


def test_config_converts():
    cfg = jo.LaminoConfig(n=32, tilt=0.7, eps=1e-4, upsample=2.0, kernel="gaussian")
    assert convert.lamino_config_from_jax(cfg) == to.LaminoConfig(32, 0.7, 1e-4, 2.0, "gaussian")
