"""The Gaussian window's geometry plan (``tike_tpu_torch.ops.usfft.
geometry_plan(..., window="gaussian")``) and the Gaussian laminography solvers on the CPU.

The CUDA kernels of ``csrc/usfft_gaussian.cu`` cannot run here; what they
read can be held. The Gaussian plan's shifted bins and its table of axis
factors, contracted in the kernels' own order by
``tests/_torch_usfft_cases.py``'s ``gather_gaussian_kernel_order`` and
``scatter_gaussian_kernel_order``, must equal ``tike_tpu.ops.usfft.gather``/
``scatter`` and the plain versions at the USFFT's 1e-5 of the largest
value: the same taps, each weight the product of three float32 axis factors
where ``tike_tpu`` takes one exp of their summed exponents (about 1e-6
apart), summed in another order. The solvers at n = 16 are held to
``tike_tpu``'s at ``cg_iter=1``, where cgrad's line search does not tie
(``tests/test_torch_lamino_solvers.py``).
"""

import numpy as np
import pytest
import torch

import tike_tpu.lamino as jl
import tike_tpu.ops.usfft as ju
import tike_tpu_torch.lamino as tl
import tike_tpu_torch.parallel as tpar
from tike_tpu_torch.ops import lamino as to
from tike_tpu_torch.ops import usfft as tu

from . import _torch_usfft_cases as cases
from ._torch_parity import assert_close, crandn, rng, t
from .test_torch_lamino import NTHETA, TILT, _smooth_object, _theta

TOL = 1e-5
# (volume n, eps, upsample) -> grid 8, 16, 16 and m = 2, 4, 6: upsample 1
# and 2 at eps 1e-3, and eps 1e-5 at upsample 2, the Gaussian's usual
# half-supports.
WINDOWS = [(8, 1e-3, 1), (8, 1e-3, 2), (8, 1e-5, 2)]


def _window(n_volume, eps, upsample):
    return cases.gaussian_window_for(n_volume, eps, upsample)


def _cells(x, n):
    """Each point's base cell in the Gaussian plan: one below the KB one."""
    return torch.remainder(n // 2 - 1 + torch.floor(n * x).long(), n)


def test_windows_are_the_usual_half_supports():
    assert [_window(*w)[:2] for w in WINDOWS] == [(8, 2), (16, 4), (16, 6)]


@pytest.mark.parametrize("npoints", [1, 60])
@pytest.mark.parametrize("span", [0.49, 0.7], ids=["inside", "wrapped"])
@pytest.mark.parametrize("n_volume, eps, upsample", WINDOWS)
def test_plan_contracted_in_kernel_order_matches_jax(n_volume, eps, upsample, span, npoints):
    n, m, mu = _window(n_volume, eps, upsample)
    x = cases.flat_points(rng(npoints), npoints, span=span)
    Fe, f = crandn(rng(1), n, n, n), crandn(rng(2), npoints)
    plan = tu.geometry_plan(t(x), n, m, mu, window="gaussian")
    assert (plan.window, plan.n, plan.m, plan.param) == ("gaussian", n, m, mu)
    gathered = cases.gather_gaussian_kernel_order(t(Fe), plan)
    spread = cases.scatter_gaussian_kernel_order(t(f), plan)
    for got, jax_version, plain in (
        (gathered, ju.gather(Fe, x.numpy(), n, m, mu), tu.gather_gaussian_plain(t(Fe), x, n, m, mu)),
        (spread, ju.scatter(f, x.numpy(), n, m, mu), tu.scatter_gaussian_plain(t(f), x, n, m, mu)),
    ):
        assert_close(got, jax_version, rtol=TOL, atol=TOL, scale=True)
        assert_close(got, plain, rtol=TOL, atol=TOL, scale=True)


@pytest.mark.parametrize("n_volume, eps, upsample", WINDOWS)
def test_plan_sorts_points_into_shifted_bins(n_volume, eps, upsample):
    n, m, mu = _window(n_volume, eps, upsample)
    x = cases.flat_points(rng(3), 400, span=0.7)
    plan = tu.geometry_plan(x, n, m, mu, window="gaussian")
    order, bins, start = plan.order.long(), plan.bins, plan.row_start.long()
    assert torch.equal(torch.sort(order)[0], torch.arange(400))
    cell = _cells(x, n)
    assert torch.equal(bins, ((cell[:, 0] * n + cell[:, 1]) * n + cell[:, 2])[order])
    assert bool(torch.all(bins[1:] >= bins[:-1]))
    tied = bins[1:] == bins[:-1]
    assert bool(torch.all(order[1:][tied] > order[:-1][tied]))
    # row_start counts each row of bins' points, and row r's points are the
    # sorted points row_start[r] ... row_start[r + 1] - 1.
    rows = bins // n
    assert start[0] == 0 and start[-1] == 400 and start.shape == (n**2 + 1,)
    assert torch.equal(start[1:] - start[:-1], torch.bincount(rows, minlength=n**2))
    for r in torch.unique(rows).tolist():
        assert bool(torch.all(rows[start[r]:start[r + 1]] == r))


@pytest.mark.parametrize("n_volume, eps, upsample", WINDOWS)
def test_table_holds_the_separable_gaussian(n_volume, eps, upsample):
    """The product of a sorted point's three axis factors is tike_tpu's
    weight of that 3-D tap, cons0 exp(cons1 |d|^2), evaluated in float64."""
    n, m, mu = _window(n_volume, eps, upsample)
    x = cases.flat_points(rng(4), 30, span=0.7)
    plan = tu.geometry_plan(x, n, m, mu, window="gaussian")
    w = plan.weights.double()  # (3, 2m, N)
    assert plan.weights.shape == (3, 2 * m, 30) and plan.weights.dtype == torch.float32
    xs = x[plan.order.long()].double()
    ell = torch.floor(n * x[plan.order.long()]).double()
    d = (ell[:, :, None] + torch.arange(-m, m)) / n - xs[:, :, None]  # (N, 3, 2m)
    cons0, cons1 = np.sqrt(np.pi / mu) ** 3, -np.pi**2 / mu
    want = cons0 * torch.exp(cons1 * (d[:, 0, :, None, None] ** 2 + d[:, 1, None, :, None] ** 2
                                      + d[:, 2, None, None, :] ** 2))
    got = w[0].T[:, :, None, None] * w[1].T[:, None, :, None] * w[2].T[:, None, None, :]
    assert float(torch.max(torch.abs(got - want)) / torch.max(want)) < 1e-6


def test_tiled_plan_serves_the_gather():
    n, m, mu = _window(8, 1e-3, 1)
    x = cases.flat_points(rng(5), 200, span=0.7)
    Fe = crandn(rng(6), n, n, n)
    plan = tu.geometry_plan(x, n, m, mu, tile=(4, 2), window="gaussian")
    assert plan.row_start is None and plan.tile == (4, 2)
    assert_close(cases.gather_gaussian_kernel_order(t(Fe), plan),
                 ju.gather(Fe, x.numpy(), n, m, mu), rtol=TOL, atol=TOL, scale=True)


def test_dispatch_takes_the_plain_version_on_the_cpu():
    """gather/scatter (and their oracle names) with or without a plan give
    the plain version on CPU tensors, launch nothing, and refuse a plan of
    the other window or of other points."""
    n, m, mu = _window(8, 1e-3, 2)
    x = cases.flat_points(rng(7), 50, span=0.7)
    Fe, f = t(crandn(rng(8), n, n, n)), t(crandn(rng(9), 50))
    plan = tu.geometry_plan(x, n, m, mu, window="gaussian")
    want_g, want_s = tu.gather_gaussian_plain(Fe, x, n, m, mu), tu.scatter_gaussian_plain(f, x, n, m, mu)
    for g, s in ((tu.gather, tu.scatter), (tu.vector_gather, tu.vector_scatter)):
        for p in (None, plan):
            assert torch.equal(g(Fe, x, n, m, mu, p), want_g)
            assert torch.equal(s(f, x, n, m, mu, p), want_s)
    with pytest.raises(ValueError, match="kb window"):
        tu.gather(Fe, x, n, m, mu, tu.geometry_plan(x, n, m, mu))
    with pytest.raises(ValueError, match="gaussian window"):
        tu.scatter_kb(f, x, n, m, mu, plan)
    with pytest.raises(ValueError, match="49 points"):
        tu.scatter(f[:49], x[:49], n, m, mu, plan)
    assert set(tu.LAUNCHES.values()) == {0}


def test_cuda_wrappers_refuse_cpu_tensors():
    n, m, mu = _window(8, 1e-3, 1)
    x = cases.flat_points(rng(10), 20)
    Fe, f = t(crandn(rng(11), n, n, n)), t(crandn(rng(12), 20))
    with pytest.raises(ValueError, match="CUDA"):
        tu.gather_gaussian_cuda(Fe, x, n, m, mu)
    with pytest.raises(ValueError, match="CUDA"):
        tu.scatter_gaussian_cuda(f, x, n, m, mu)
    with pytest.raises(ValueError, match="m = 5"):
        tu.geometry_plan(x, n, 5, mu, window="gaussian")
    assert tu.LAUNCHES["usfft_gather_gaussian"] == tu.LAUNCHES["usfft_scatter_gaussian"] == 0


def test_touched_cells_and_bounds_take_the_gaussian_taps():
    """A point at 0.01 on a 16-grid: KB taps floor(n x) + [0, 1] at m = 1,
    the Gaussian's + [-1, 0]; the counts agree with the cells tike_tpu's
    offsets reach."""
    x = torch.tensor([[0.01, 0.01, 0.01], [-0.3, 0.2, 0.7]])
    n, m = 16, 2
    ell = np.floor(n * x.numpy()).astype(int)
    offs = ju._tap_offsets(m)
    want = {tuple((n // 2 + e + o) % n) for e in ell for o in offs}
    assert tu.touched_cells(x, n, m, "gaussian") == len(want) == 2 * 64
    assert tu.touched_cells(x[:1], n, 1, "gaussian") == 8
    assert tu.roofline_bytes("usfft_gather_gaussian", 2, 16, 128) == 128 * 8 + 2 * 20
    assert tu.roofline_bytes("usfft_scatter_gaussian", 2, 16) == 16**3 * 8 + 2 * 20
    assert tu.fp32_instructions(1, 2) == 2 * (64 + 16 + 4)


def test_lamino_plan_on_the_cpu_holds_no_kernel_plan():
    cfg = to.LaminoConfig(n=8, tilt=TILT, upsample=2, kernel="gaussian")
    plan = to.LaminoPlan(cfg, torch.as_tensor(_theta(4)))
    assert plan.scatter is None and plan.gather is None and plan.scatter_negated is None


@pytest.mark.parametrize("upsample", [2, 1])
@pytest.mark.parametrize("algorithm, cg_iter", [("cgrad", 1), ("cgls", 1)])
def test_gaussian_reconstruct_matches_jax(algorithm, cg_iter, upsample):
    """``reconstruct(kernel="gaussian")`` at n = 16, 8 angles, 3 outer
    iterations, against tike_tpu's: costs and volume at 1e-5 relative (the
    costs at upsample 1 at ``test_torch_lamino_solvers.COST_TOL_1``, as the
    KB window's)."""
    theta = _theta(NTHETA, np.pi)
    kwargs = dict(eps=1e-3, upsample=upsample, kernel="gaussian")
    data = jl.simulate(_smooth_object(), theta, TILT, **kwargs)
    assert_close(tl.simulate(_smooth_object(), theta, TILT, device="cpu", **kwargs), data,
                 rtol=TOL, atol=TOL, scale=True)
    kwargs.update(algorithm=algorithm, num_iter=3, cg_iter=cg_iter)
    want = jl.reconstruct(data, theta, TILT, **kwargs)
    got = tl.reconstruct(data, theta, TILT, device="cpu", **kwargs)
    assert len(got["cost"]) == 3 and np.all(np.diff(got["cost"]) < 0)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=TOL if upsample == 2 else 1e-4)
    assert_close(got["obj"], want["obj"], rtol=TOL, atol=TOL, scale=True)


def test_gaussian_theta_mesh_matches_one_device():
    """The theta split (a LaminoPlan a shard) with the Gaussian window on
    two CPU shards against one device at cg_iter 1: costs at 1e-5, as
    ``tests/test_torch_mesh_lamino.py`` holds the KB window."""
    theta = _theta(NTHETA, np.pi)
    kwargs = dict(eps=1e-3, upsample=2, kernel="gaussian")
    data = tl.simulate(_smooth_object(), theta, TILT, device="cpu", **kwargs)
    kwargs.update(algorithm="cgrad", num_iter=2, cg_iter=1, device="cpu")
    single = tl.reconstruct(data, theta, TILT, **kwargs)
    split = tl.reconstruct(data, theta, TILT, mesh=tpar.make_mesh(devices=["cpu"] * 2), **kwargs)
    np.testing.assert_allclose(split["cost"], single["cost"], rtol=TOL)
    assert_close(split["obj"], single["obj"], rtol=TOL, atol=TOL, scale=True)
