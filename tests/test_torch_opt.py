"""The port's step directions against tike_tpu.opt.

``momentum``, ``adam`` and ``momentum_checked_traced`` get the same seeded
complex64 steps, states and cost tails on both sides and agree to 1e-6
relative to the largest value. The checked momentum runs three calls for
a falling cost (the momentum is taken every time), a rising one (never)
and a history too short to judge (not until it holds three costs).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import tike_tpu.opt as jopt

import tike_tpu_torch.opt as topt
from tike_tpu_torch.ptycho.solvers.epoch import seed_err_hist
from tike_tpu.ptycho.solvers.fused import seed_err_hist as jax_seed_err_hist

from . import _torch_parity as H

TOL = 1e-6


def _close(got, want):
    H.assert_close(got, want, rtol=TOL, atol=TOL, scale=True)


@pytest.mark.parametrize("first", [True, False])
def test_momentum_matches_jax(first):
    gen = H.rng(60)
    g = H.crandn(gen, 1, 9, 11)
    m = None if first else H.crandn(gen, 1, 9, 11)
    jd, jv, jm = jopt.momentum(jnp.asarray(g), None, None if first else jnp.asarray(m), mdecay=0.8)
    td, tv, tm = topt.momentum(H.t(g), None, None if first else H.t(m), mdecay=0.8)
    assert tv is None and jv is None
    _close(td, jd)
    _close(tm, jm)


def test_adam_matches_jax():
    gen = H.rng(61)
    g, v, m = H.crandn(gen, 5, 7), gen.uniform(0, 1, (5, 7)).astype(np.float32), H.crandn(gen, 5, 7)
    want = jopt.adam(jnp.asarray(g), jnp.asarray(v), jnp.asarray(m), vdecay=0.99, mdecay=0.8)
    got = topt.adam(H.t(g), H.t(v), H.t(m), vdecay=0.99, mdecay=0.8)
    for a, b in zip(got, want):
        _close(a, b)


# Cost history before the first call, the factor from one epoch's cost to
# the next, and whether each of the three calls takes the momentum.
HISTORIES = {
    "falling": ([3.0, 2.0, 1.5, 1.2, 1.0], 0.9, [True, True, True]),
    "rising": ([1.0, 1.1, 1.3, 1.6, 2.0], 1.2, [False, False, False]),
    "too_short": ([], 0.9, [False, False, True]),
}


@pytest.mark.parametrize("history", sorted(HISTORIES))
@pytest.mark.parametrize("shape", [(16, 16), (1, 12, 10)])
def test_momentum_checked_traced_matches_jax(history, shape):
    prev, factor, expected = HISTORIES[history]
    gen = H.rng(62)
    base = H.crandn(gen, *shape)
    # Earlier normalized steps that point the way of the new ones, so that
    # their correlations are positive from the first call.
    previous = np.stack([base / np.linalg.norm(base)] * 3).astype(np.complex64)
    m = (0.1 * H.crandn(gen, *shape)).astype(np.complex64)
    jstate = (jnp.asarray(previous), jnp.asarray(m))
    tstate = (H.t(previous), H.t(m))
    costs = list(prev)
    current = costs[-1] * factor if costs else 1.0
    took = []
    for step in range(3):
        # Steps that keep pointing the same way, so that their correlations
        # are positive, with a little noise.
        g = (base + 0.1 * H.crandn(gen, *shape)).astype(np.complex64)
        eh = seed_err_hist(costs)
        np.testing.assert_array_equal(eh, jax_seed_err_hist(costs))
        eh = np.roll(eh, -1)
        eh[-1] = current
        n_done = len(costs) + 1
        jd, *jstate = jopt.momentum_checked_traced(
            jnp.asarray(g), *jstate, 0.9, jnp.asarray(eh), n_done, beta=0.5
        )
        td, *tstate = topt.momentum_checked_traced(
            H.t(g), *tstate, 0.9, H.t(eh), n_done, beta=0.5
        )
        _close(td, jd)
        for a, b in zip(tstate, jstate):
            _close(a, b)
        took.append(bool(np.any(H.n(td) != 0)))
        costs.append(current)
        current *= factor
    assert took == expected
