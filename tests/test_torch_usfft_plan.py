"""The KB kernels' geometry plan (``tike_tpu_torch.ops.usfft.geometry_plan``) on
the CPU (laminography's ``LaminoPlan`` is in ``test_torch_lamino_plan.py``).

The CUDA kernels of ``csrc/usfft.cu`` cannot run here; what they read can
be held: the plan's sort, bins, offsets and weights, and the two
formulations the kernels compute from it, written out in plain numpy and
PyTorch in ``tests/_torch_usfft_cases.py`` (a cell-owned scatter that adds
each cell's points in the plan's order, a gather in the plan's order
written through ``order``). They must equal the plain versions to 1e-6 of
the largest value (the same weights bit for bit, sums in another order) and
themselves bit for bit. The half-support m = 7 (``upsample=2, eps=1e-12``)
is held against ``tike_tpu`` at the USFFT's 1e-5.
"""

import numpy as np
import pytest
import torch

import tike_tpu.ops.usfft as ju
from tike_tpu_torch.ops import usfft as tu

from . import _torch_usfft_cases as cases
from ._torch_parity import assert_close, crandn, rng, t

TOL = 1e-5
OWNED_TOL = 1e-6
# (grid n, m, beta): every compiled path (m = 1, 2) and the generic one,
# m = 7 on the smallest grid that holds its 14 taps.
WINDOWS = [(8, 1, 2.0), (8, 2, 5.0), (10, 4, 9.0), (14, 7, 20.0)]


def _points(npoints, span, seed=0):
    """Points uniform in [-span, span): with span 0.7 a third of each axis
    wraps, and half are negative either way."""
    return cases.flat_points(rng(seed), npoints, span=span)


def _cells(x, n):
    return torch.remainder(n // 2 + torch.floor(n * x).long(), n)


@pytest.mark.parametrize("npoints", [0, 1, 300])
@pytest.mark.parametrize("span", [0.49, 0.7], ids=["inside", "wrapped"])
@pytest.mark.parametrize("n, m, beta", WINDOWS)
def test_kb_plan_sorts_points_into_bins(n, m, beta, span, npoints):
    x = _points(npoints, span)
    plan = tu.geometry_plan(x, n, m, beta)
    assert (plan.n, plan.m, plan.param, plan.npoints, plan.tile) == (n, m, beta, npoints, None)
    order, bins, start = plan.order.long(), plan.bins, plan.row_start.long()
    assert plan.order.dtype == plan.rows.dtype == plan.row_start.dtype == torch.int32
    assert plan.cols.dtype == torch.int16 and bins.dtype == torch.int64
    # order is a permutation, and every sorted point lies in its bin.
    assert torch.equal(torch.sort(order)[0], torch.arange(npoints))
    cell = _cells(x, n)
    want_bins = (cell[:, 0] * n + cell[:, 1]) * n + cell[:, 2]
    assert torch.equal(bins, want_bins[order])
    assert torch.equal(plan.rows.long(), want_bins[order] // n)
    assert torch.equal(plan.cols.long(), cell[order][:, 2])
    # Sorted by bin, ties in ascending point index: a stable sort.
    assert bool(torch.all(bins[1:] >= bins[:-1]))
    tied = bins[1:] == bins[:-1]
    assert bool(torch.all(order[1:][tied] > order[:-1][tied]))
    # row_start: n^2 + 1 monotone offsets from 0 to N; row r's points are
    # exactly those between its two offsets.
    assert start.shape == (n**2 + 1,)
    assert start[0] == 0 and start[-1] == npoints
    assert bool(torch.all(start[1:] >= start[:-1]))
    assert torch.equal(start[1:] - start[:-1], torch.bincount(want_bins // n, minlength=n**2))
    if npoints:
        p, rows = torch.arange(npoints), plan.rows.long()
        assert bool(torch.all((start[rows] <= p) & (p < start[rows + 1])))
    # The weights are the plain version's, to the bit, point index last.
    assert plan.weights.shape == (3, 2 * m, npoints) and plan.weights.is_contiguous()
    taps = tu._kb_axis_taps(x[order], n, m, beta)
    for a, (w, g) in enumerate(taps):
        assert torch.equal(plan.weights[a], w.T)
        # The taps start m - 1 cells below the base cell.
        assert torch.equal(g[:, m - 1], cell[order][:, a])
    assert plan.nbytes == 4 * (2 * npoints + 6 * m * npoints + n**2 + 1) + 2 * npoints


@pytest.mark.parametrize("n, m, beta", WINDOWS[:2])
def test_kb_plan_by_tiles_serves_the_gather(n, m, beta):
    x = _points(300, 0.7)
    plan = tu.geometry_plan(x, n, m, beta, tile=(4, 2))
    assert plan.row_start is None and plan.tile == (4, 2)
    order = plan.order.long()
    assert torch.equal(torch.sort(order)[0], torch.arange(300))
    cell = _cells(x, n)[order]
    key = (cell[:, 0] * n + cell[:, 1] // 4) * n + cell[:, 2] // 2
    assert bool(torch.all(key[1:] >= key[:-1]))
    tied = key[1:] == key[:-1]
    assert bool(torch.all(order[1:][tied] > order[:-1][tied]))
    assert torch.equal(plan.bins, (cell[:, 0] * n + cell[:, 1]) * n + cell[:, 2])
    Fe = t(crandn(rng(1), n, n, n))
    want = tu.gather_kb_plain(Fe, x, n, m, beta)
    assert cases.max_rel(cases.gather_sorted_plain(Fe, plan), want) < OWNED_TOL
    assert tu.gather_tile(1) == tu.GATHER_TILE and tu.gather_tile(2) is None


@pytest.mark.parametrize("span", [0.49, 0.7], ids=["inside", "wrapped"])
@pytest.mark.parametrize("n, m, beta", WINDOWS)
def test_cell_owned_scatter_and_sorted_gather_match_plain(n, m, beta, span):
    """What the kernels compute from a plan, in plain code: equal to the
    plain versions, and two runs equal bit for bit."""
    npoints = 60 if m > 2 else 200
    x = _points(npoints, span, seed=2)
    gen = rng(3)
    f, Fe = t(crandn(gen, npoints)), t(crandn(gen, n, n, n))
    plan = tu.geometry_plan(x, n, m, beta)
    got = cases.scatter_owned_plain(f, plan)
    assert cases.max_rel(got, tu.scatter_kb_plain(f, x, n, m, beta)) < OWNED_TOL
    assert torch.equal(torch.view_as_real(got), torch.view_as_real(cases.scatter_owned_plain(f, plan)))
    gathered = cases.gather_sorted_plain(Fe, plan)
    assert cases.max_rel(gathered, tu.gather_kb_plain(Fe, x, n, m, beta)) < OWNED_TOL
    lhs, rhs = cases.inner64(gathered, f), cases.inner64(Fe, got)
    assert abs(lhs - rhs) / abs(lhs) < cases.ADJOINT_TOL


def test_cell_owned_scatter_of_piled_points():
    """Many points in one cell and none elsewhere: long lists beside empty
    cells, as near laminography's rotation axis."""
    n, m, beta = 8, 1, 2.0
    gen = rng(4)
    x = torch.as_tensor((0.01 + 0.1 * gen.uniform(0, 1, (150, 3)) / n).astype(np.float32))
    f = t(crandn(gen, 150))
    plan = tu.geometry_plan(x, n, m, beta)
    assert int(torch.count_nonzero(plan.row_start[1:] - plan.row_start[:-1])) == 1
    got = cases.scatter_owned_plain(f, plan)
    assert cases.max_rel(got, tu.scatter_kb_plain(f, x, n, m, beta)) < OWNED_TOL
    assert int(torch.count_nonzero(got)) == 8


@pytest.mark.parametrize("layout", ["flat", "rows"])
def test_wrappers_take_a_plan(layout):
    """``gather_kb``/``scatter_kb`` and the row forms give the same result
    with a plan as without; a plan of other points or another window is
    refused on any device."""
    n, m, beta = 16, 2, 5.0
    gen = rng(5)
    x = _points(96, 0.7, seed=6)
    Fe, f = t(crandn(gen, n, n, n)), t(crandn(gen, 96))
    plan = tu.geometry_plan(x, n, m, beta)
    if layout == "flat":
        gather, scatter = tu.gather_kb, tu.scatter_kb
    else:
        gather, scatter = tu.gather_kb_rows, tu.scatter_kb_rows
        x, f = x.reshape(8, 12, 3), f.reshape(8, 12)
    assert torch.equal(gather(Fe, x, n, m, beta, plan=plan), gather(Fe, x, n, m, beta))
    assert torch.equal(scatter(f, x, n, m, beta, plan=plan), scatter(f, x, n, m, beta))
    with pytest.raises(ValueError, match="the plan is for"):
        gather(Fe, x, n, 1, 2.0, plan=plan)
    with pytest.raises(ValueError, match="the plan is for"):
        scatter(f[:4], x[:4], n, m, beta, plan=plan)


def test_kb_plan_refuses_bad_inputs():
    x = _points(5, 0.4)
    with pytest.raises(ValueError, match="float32"):
        tu.geometry_plan(x.double(), 8, 1, 2.0)
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        tu.geometry_plan(x[:, :2], 8, 1, 2.0)
    with pytest.raises(ValueError, match="2 m <= n"):
        tu.geometry_plan(x, 8, 5, 2.0)


@pytest.mark.parametrize("span", [0.49, 0.7], ids=["inside", "wrapped"])
def test_half_support_7_matches_jax(span):
    """upsample 2 at eps 1e-12 gives m = 7, which the kernels once
    refused: the plain versions, and what the kernels compute from a plan,
    against ``tike_tpu`` on a 16^3 grid."""
    _, m, beta = cases.window_for(32, 1e-12, 2)
    assert m == 7
    n = 16
    gen = rng(7)
    Fe, f = crandn(gen, n, n, n), crandn(gen, 77)
    x = gen.uniform(-span, span, (77, 3)).astype(np.float32)
    close = dict(rtol=TOL, atol=TOL, scale=True)
    want_gather = ju.gather_kb(Fe, x, n, m, beta)
    want_scatter = ju.scatter_kb(f, x, n, m, beta)
    assert_close(tu.gather_kb(t(Fe), t(x), n, m, beta), want_gather, **close)
    assert_close(tu.scatter_kb(t(f), t(x), n, m, beta), want_scatter, **close)
    plan = tu.geometry_plan(t(x), n, m, beta)
    assert_close(cases.gather_sorted_plain(t(Fe), plan), want_gather, **close)
    assert_close(cases.scatter_owned_plain(t(f), plan), want_scatter, **close)


def test_transforms_at_half_support_7_match_jax():
    gen = rng(8)
    vol, x = crandn(gen, 8, 8, 8), gen.uniform(-0.49, 0.49, (50, 3)).astype(np.float32)
    vals = crandn(gen, 50)
    assert tu.kb_parameters(8, 1e-12, 2)[2] == 7
    close = dict(rtol=TOL, atol=TOL, scale=True)
    assert_close(tu.eq2us(t(vol), t(x), 8, 1e-12, 2), ju.eq2us(vol, x, 8, 1e-12, 2), **close)
    assert_close(tu.us2eq(t(vals), t(x), 8, 1e-12, 2), ju.us2eq(vals, x, 8, 1e-12, 2), **close)
