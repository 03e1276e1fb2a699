"""The port's support modules against tike_tpu's: random, scan, trajectory,
and the linalg and opt helpers.

Mirrors ``tests/test_support.py``'s TestLinalg, TestOpt, TestScanTrajectory
and TestRandom, parametrised. The host modules (scan, trajectory,
``random.numpy_complex``, ``opt.batch_indicies``) are numpy in both
packages and give the same bits on the same inputs and generator; the
tensor helpers agree with the JAX functions to 1e-6 relative to the largest
value, the linalg products and sums to 1e-5 and the normal-equation solve
of ``lstsq`` to 1e-4.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tike_tpu.linalg as jla
import tike_tpu.opt as jopt
import tike_tpu.random as jrandom
import tike_tpu.scan as jscan
import tike_tpu.trajectory as jtrajectory

import tike_tpu_torch.linalg as tla
import tike_tpu_torch.opt as topt
import tike_tpu_torch.random as trandom
import tike_tpu_torch.scan as tscan
import tike_tpu_torch.trajectory as ttrajectory

from . import _torch_parity as H
from .test_torch_opt import HISTORIES

TOL = 1e-6


def _close(got, want, tol=TOL):
    H.assert_close(got, want, rtol=tol, atol=tol, scale=True)


T = np.linspace(0, 3, 301)

# Every name of scan.__all__ with its arguments.
SCAN_CALLS = {
    "scantimes": (0, 2, 30),
    "sinusoid": (2.0, 3.0, 0.5, T),
    "triangle": (2.0, 3.0, 0.5, T),
    "triangle_fs": (2.0, 3.0, 0.5, T, 6),
    "sawtooth": (2.0, 3.0, 0.5, T),
    "square": (2.0, 3.0, 0.5, T),
    "staircase": (2.0, 3.0, 0.5, T),
    "lissajous": (2, 3, 5, 3, 0, 0.5, T),
    "raster": (5, 1, 2, 0, 0, T),
    "spiral": (4.0, 3.0, 2.0, T),
    "diagonal": (2, 3, 5, 3, 0, 0.5, T),
    "scan3": (2, 3, 5, 3, 1, 0, 0.5, T, 60),
    "avgspeed": (3.0, np.sin(T), np.cos(T), T),
    "lengths": (np.sin(T), np.cos(T), T),
    "distance": (np.sin(T), np.cos(T)),
    "billiard": (2, 3, 5, 3, 0, 0.5, T, 8),
    "hexagonal": (T, 1.5, 4.0, 3),
}


def test_scan_calls_cover_all():
    assert set(SCAN_CALLS) == set(jscan.__all__) == set(tscan.__all__)


@pytest.mark.parametrize("name", sorted(SCAN_CALLS))
def test_scan_matches_jax_bitwise(name):
    want = getattr(jscan, name)(*SCAN_CALLS[name])
    got = getattr(tscan, name)(*SCAN_CALLS[name])
    np.testing.assert_array_equal(got, want)


def _trajectory(t, a=1.0):
    return t, a * np.sin(3 * t), np.cos(2 * t)


# Coded exposure: the original tike's pinned vectors, and one code window
# per bundle.
CODED = {
    "reference_vectors": (
        np.array([-1.0, 0.8, 1.8, 3.0, 4.1, 4.2, 6.1, 7.5, 8.6, 8.9, 8.9, 8.9, 20, 21]),
        np.array([0.1, 0.2, 0.4, 0.5, 0.1, 0.1, 0.6, 0.2, 0.2, 2, 0, 0.3, 1.0, 1.0]),
        np.arange(11.0),
        np.ones(11) * 0.5,
    ),
    "two_codes": (np.arange(11.0), np.full(11, 0.5), np.array([2.0, 8.0]), np.array([1.5, 2.5])),
}


@pytest.mark.parametrize("case", sorted(CODED))
def test_coded_exposure_matches_jax_bitwise(case):
    time, dwell, c_time, c_dwell = CODED[case]
    theta = v = h = np.arange(time.size) * 0.5
    want = jtrajectory.coded_exposure(theta, v, h, time, dwell, c_time, c_dwell)
    got = ttrajectory.coded_exposure(theta, v, h, time, dwell, c_time, c_dwell)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("xstep", [0.1, 0.03])
def test_discrete_trajectory_matches_jax_bitwise(xstep):
    kw = dict(tmin=0, tmax=1, xstep=xstep, tstep=0.1, tkwargs=dict(a=2.0))
    want = jtrajectory.discrete_trajectory(_trajectory, **kw)
    got = ttrajectory.discrete_trajectory(_trajectory, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    theta, v, h = got[:3]
    assert np.all(ttrajectory.euclidian_dist_approx(theta, v, h) <= xstep + 1e-6)
    for name in ("euclidian_dist", "euclidian_dist_approx"):
        np.testing.assert_array_equal(
            getattr(ttrajectory, name)(theta, v, h), getattr(jtrajectory, name)(theta, v, h)
        )
    assert ttrajectory.monotonic(got[4]) == jtrajectory.monotonic(got[4])
    assert ttrajectory.get_overlap(0, 2, 1, 3) == jtrajectory.get_overlap(0, 2, 1, 3)
    assert ttrajectory.has_overlap(0, 1, 2, 1) == jtrajectory.has_overlap(0, 1, 2, 1)


@pytest.mark.parametrize("shape", [(100,), (7, 3, 2)])
def test_numpy_complex_matches_jax_bitwise(shape):
    want = jrandom.numpy_complex(*shape, rng=H.rng(12))
    got = trandom.numpy_complex(*shape, rng=H.rng(12))
    assert got.dtype == np.complex64 and got.shape == shape
    np.testing.assert_array_equal(got, want)


def test_torch_complex_range_and_repeats():
    draw = lambda: trandom.torch_complex(50, 3, generator=torch.Generator().manual_seed(4))
    x = draw()
    assert x.shape == (50, 3) and x.dtype == torch.complex64 and x.device.type == "cpu"
    assert float(x.real.min()) >= -0.5 and float(x.real.max()) < 0.5
    assert float(x.imag.min()) >= -0.5 and float(x.imag.max()) < 0.5
    assert float(x.real.std()) > 0.1  # not degenerate
    assert torch.equal(draw(), x)
    assert not torch.equal(
        trandom.torch_complex(50, 3, generator=torch.Generator().manual_seed(5)), x
    )


@pytest.mark.parametrize("name", ["cluster_wobbly_center", "cluster_compact"])
def test_deprecated_cluster_aliases(name):
    pop = H.rng(0).random((20, 2))
    with pytest.warns(DeprecationWarning, match=name):
        got = getattr(trandom, name)(pop, 2)
    np.testing.assert_array_equal(np.sort(np.concatenate(got)), np.arange(20))
    if name == "cluster_wobbly_center":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            want = getattr(jrandom, name)(pop, 2)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# linalg: each function with its inputs, made from a seed.
def _linalg_inputs(name):
    gen = H.rng(13)
    if name == "lstsq":
        a = gen.standard_normal((5, 8, 3)).astype(np.float32)
        return a, a @ gen.standard_normal((5, 3, 2)).astype(np.float32)
    if name == "projection":
        return H.crandn(gen, 4, 16), H.crandn(gen, 4, 16)
    if name == "orthogonalize_gs":
        return (H.crandn(gen, 4, 16),)
    return (H.crandn(gen, 6, 4, 5),)


LINALG = {
    "hermitian": ({}, {}),
    "cov": ({}, {}),
    "norm": (dict(axis=(-2, -1)), dict(dim=(-2, -1))),
    "mnorm": (dict(axis=-1, keepdims=True), dict(dim=-1, keepdim=True)),
    "projection": (dict(axis=-1), dict(dim=-1)),
    "lstsq": ({}, {}),
    "orthogonalize_gs": (dict(axis=-1), dict(dim=-1)),
}


@pytest.mark.parametrize("name", sorted(LINALG))
def test_linalg_matches_jax(name):
    jkw, tkw = LINALG[name]
    args = _linalg_inputs(name)
    want = getattr(jla, name)(*(jnp.asarray(a) for a in args), **jkw)
    got = getattr(tla, name)(*(H.t(a) for a in args), **tkw)
    assert tuple(got.shape) == want.shape
    _close(got, want, 1e-4 if name == "lstsq" else 1e-5)
    if name == "hermitian":
        np.testing.assert_array_equal(H.n(got), args[0].conj().swapaxes(-1, -2))


@pytest.mark.parametrize("k", [1, 3])
def test_pca_eig_matches_jax(k):
    """The top k eigenvalues in descending order, and the projector onto
    their eigenvectors: each eigenvector's phase is the eigensolver's
    choice (ROADMAP.md §3)."""
    data = H.crandn(H.rng(14), 40, 3, 4)
    jvals, jvecs = jla.pca_eig(jnp.asarray(data), k)
    tvals, tvecs = tla.pca_eig(H.t(data), k)
    assert tuple(tvecs.shape) == (k, 3, 4) and tuple(tvals.shape) == (k,)
    assert np.all(np.diff(H.n(tvals)) <= 0)
    _close(tvals, jvals, 1e-5)
    projector = lambda u: H.n(u).reshape(k, -1).T @ H.n(u).reshape(k, -1).conj()
    _close(projector(tvecs), projector(jvecs), 1e-5)


@pytest.mark.parametrize("use_random", [True, False])
def test_batch_indicies_matches_jax_bitwise(use_random):
    want = jopt.batch_indicies(23, 4, use_random=use_random, rng=H.rng(15))
    got = topt.batch_indicies(23, 4, use_random=use_random, rng=H.rng(15))
    assert len(got) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_get_put_batch(kind):
    """numpy is set in place, as in the original tike; a tensor comes back
    updated and is left as it was."""
    b = [np.array([1, 3]), np.array([0, 2])]
    x = np.arange(10.0)
    if kind == "tensor":
        x = torch.arange(10.0)
    np.testing.assert_array_equal(H.n(topt.get_batch(x, b, 1)), [0, 2])
    y = topt.put_batch(np.array([9.0, 8.0]), x, b, 0)
    np.testing.assert_array_equal(H.n(y)[[1, 3]], [9.0, 8.0])
    assert (y is x) == (kind == "numpy")
    assert float(x[1]) == (9.0 if kind == "numpy" else 1.0)
    assert topt.update_single(1.0, 0.5, 4.0) == jopt.update_single(1.0, 0.5, 4.0) == 3.0
    assert topt.dir_single("z") == "z"


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("name", ["adagrad", "adadelta"])
def test_adaptive_directions_match_jax(name, first):
    gen = H.rng(16)
    g, d0 = H.crandn(gen, 5, 7), H.crandn(gen, 5, 7)
    v = None if first else gen.uniform(0, 1, (5, 7)).astype(np.float32)
    m = None if first else gen.uniform(0, 1, (5, 7)).astype(np.float32)
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else H.t(a)
    if name == "adagrad":
        want = jopt.adagrad(j(g), j(v), j(m))
        got = topt.adagrad(t(g), t(v), t(m))
    else:
        want = jopt.adadelta(j(g), j(d0), j(v), j(m), decay=0.8)
        got = topt.adadelta(t(g), t(d0), t(v), t(m), decay=0.8)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            _close(a, b)


@pytest.mark.parametrize("points", [([0.0, 1.0, 2.0], [1.0, 3.0, 5.0]), ([0, 1, 2, 3], [0.0, -0.7, -1.1, -1.9])])
def test_fit_line_matches_jax(points):
    x, y = points
    assert topt.fit_line_least_squares(y=y, x=x) == jopt.fit_line_least_squares(y=y, x=x)


@pytest.mark.parametrize("history", sorted(HISTORIES))
def test_momentum_checked_matches_jax(history):
    """The host-decided checked momentum, three calls, as
    ``test_torch_opt.py`` holds the traced one."""
    prev, factor, expected = HISTORIES[history]
    gen = H.rng(62)
    base = H.crandn(gen, 16, 16)
    jstate, tstate = (None, None), (None, None)
    costs = list(prev)
    took = []
    for _ in range(3):
        costs.append(costs[-1] * factor if costs else 1.0)
        g = (base + 0.1 * H.crandn(gen, 16, 16)).astype(np.complex64)
        jd, *jstate = jopt.momentum_checked(jnp.asarray(g), *jstate, 0.9, costs[-3:], beta=0.5)
        td, *tstate = topt.momentum_checked(H.t(g), *tstate, 0.9, costs[-3:], beta=0.5)
        _close(td, jd)
        for a, b in zip(tstate, jstate):
            _close(a, b)
        took.append(bool(np.any(H.n(td) != 0)))
    # Started from no state, the first two calls hold a zero step among
    # the last three, whose correlation is not positive.
    assert took == [False, False, expected[2]]


def test_is_converged_matches_jax():
    class Opts:
        convergence_window = 4

    for costs, want in (([[4.0], [4.1], [4.2], [4.3]], True), ([[5.0], [4.0], [3.0], [2.0]], False)):
        Opts.costs = costs
        assert topt.is_converged(Opts()) == jopt.is_converged(Opts()) == want
