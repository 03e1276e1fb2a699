"""The Gaussian window through the CUDA kernels of ``csrc/usfft_gaussian.cu``
against its plain PyTorch version, its written-out summation order and its
first form (the KB kernels of ``csrc/usfft.cu`` on a Gaussian plan), on the
card.

Every test here needs a CUDA card and ``nvcc``, is marked ``cuda``, and
skips without a card; whether there is one is decided inside each test, so
every worker collects the same tests. On a machine with a card, from the
root of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_usfft_gaussian_cuda.py -q

The checks are those of ``chip_smoke.py`` phase 25, from
``tests/_torch_usfft_cases.py``, at smaller sizes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tike_tpu_torch.ops import lamino, usfft

from . import _torch_usfft_cases as cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build csrc/usfft.cu)")
    return torch.device("cuda", 0)


# (volume n, eps, upsample): m = 2, 4 (upsample 1 and 2 at eps 1e-3), 6
# (eps 1e-5, upsample 2) and 3 (the generic instantiation).
WINDOWS = [(32, 1e-3, 1), (16, 1e-3, 2), (16, 1e-5, 2), (16, 1e-3, 1.5)]


@pytest.mark.parametrize("layout", ["rows", "flat"])
@pytest.mark.parametrize("n_volume, eps, upsample", WINDOWS)
def test_gaussian_kernels_match_plain(card, n_volume, eps, upsample, layout):
    """Both kernels against the plain Gaussian versions and adjointness;
    three launches of each (two on one plan, one building its own) bitwise
    equal, or ``check_kernels`` raises."""
    n, m, mu = cases.gaussian_window_for(n_volume, eps, upsample)
    gen = np.random.default_rng(0)
    if layout == "rows":
        x = cases.lamino_rows(n_volume, 16, card).reshape(-1, 3)
    else:
        x = cases.flat_points(gen, 20_000, card)
    grid = cases.crandn(gen, n, n, n, device=card)
    f = cases.crandn(gen, x.shape[0], device=card)
    cases.check_kernels(grid, x, f, n, m, mu, f"{layout}, m = {m}", "gaussian")


def test_gaussian_scatter_repeats_bit_for_bit_on_piled_points(card):
    """Half of the points in a few cells: ten launches, one result."""
    n, m, mu = cases.gaussian_window_for(16, 1e-3, 2)
    gen = np.random.default_rng(4)
    x = cases.flat_points(gen, 40_000, card)
    x[:20_000] = 0.01 + 0.02 * x[:20_000]
    f = cases.crandn(gen, x.shape[0], device=card)
    plan = usfft.geometry_plan(x, n, m, mu, window="gaussian")
    first = usfft.scatter_gaussian_cuda(f, x, n, m, mu, plan)
    for _ in range(9):
        again = usfft.scatter_gaussian_cuda(f, x, n, m, mu, plan)
        assert torch.equal(torch.view_as_real(again), torch.view_as_real(first))
    want = usfft.scatter_gaussian_plain(f, x, n, m, mu)
    assert cases.max_rel(first, want) < cases.KB_TOL


@pytest.mark.parametrize("upsample", [1, 2])
def test_gaussian_kernels_match_the_first_form(card, upsample):
    """On laminography's rows both kernels lie within ``KB_TOL`` of the
    first form on the same plan (another summation order, the same
    weights)."""
    n, m, mu = cases.gaussian_window_for(32, 1e-3, upsample)
    x = cases.lamino_rows(32, 16, card).reshape(-1, 3)
    gen = np.random.default_rng(8)
    grid, f = cases.crandn(gen, n, n, n, device=card), cases.crandn(gen, x.shape[0], device=card)
    plan = usfft.geometry_plan(x, n, m, mu, window="gaussian")
    assert cases.max_rel(usfft.gather_gaussian_cuda(grid, x, n, m, mu, plan),
                         cases.first_form_gather(grid, plan)) < cases.KB_TOL
    assert cases.max_rel(usfft.scatter_gaussian_cuda(f, x, n, m, mu, plan),
                         cases.first_form_scatter(f, plan)) < cases.KB_TOL


@pytest.mark.parametrize("n_volume, eps, upsample", [(8, 1e-3, 1), (8, 1e-3, 2), (8, 1e-5, 2)])
def test_gaussian_kernels_sum_in_their_written_order(card, n_volume, eps, upsample):
    """Each kernel against its summation order written out in plain code
    (``gather_gaussian_kernel_order``, ``scatter_gaussian_kernel_order``):
    the same terms in the same order, apart from the fused multiply-adds,
    so within 1e-6 of the largest value, much closer than to the plain
    version's order."""
    n, m, mu = cases.gaussian_window_for(n_volume, eps, upsample)
    gen = np.random.default_rng(9)
    x = cases.flat_points(gen, 300)
    grid, f = cases.crandn(gen, n, n, n), cases.crandn(gen, 300)
    plan = usfft.geometry_plan(x, n, m, mu, window="gaussian")
    on_card = usfft.geometry_plan(x.to(card), n, m, mu, window="gaussian")
    got = usfft.gather_gaussian_cuda(grid.to(card), x.to(card), n, m, mu, on_card).cpu()
    assert cases.max_rel(got, cases.gather_gaussian_kernel_order(grid, plan)) < 1e-6
    got = usfft.scatter_gaussian_cuda(f.to(card), x.to(card), n, m, mu, on_card).cpu()
    assert cases.max_rel(got, cases.scatter_gaussian_kernel_order(f, plan)) < 1e-6


@pytest.mark.parametrize("n_volume, eps, upsample", [(16, 1e-3, 1), (8, 1e-3, 2), (12, 1e-3, 1.5)])
def test_gaussian_scatter_in_either_block_order(card, n_volume, eps, upsample):
    """The scatter with the plan's blocks (the busiest first) and with the
    same bands in the grid's order: the same bits, repeatable, within ``KB_TOL`` of the plain version, on points half
    of them piled in a few cells (long runs), and summed in the order
    ``scatter_gaussian_kernel_order`` writes out."""
    n, m, mu = cases.gaussian_window_for(n_volume, eps, upsample)
    gen = np.random.default_rng(10)
    x = cases.flat_points(gen, 1_500, card)
    x[:750] = 0.01 + 0.02 * x[:750]
    f = cases.crandn(gen, x.shape[0], device=card)
    plan = usfft.geometry_plan(x, n, m, mu, window="gaussian")
    first = usfft.scatter_gaussian_cuda(f, x, n, m, mu, plan)
    for blocks in (plan.blocks, usfft._scatter_blocks(plan.row_start, n, m, busiest_first=False)):
        again = usfft.scatter_gaussian_cuda(f, x, n, m, mu,
                                            dataclasses.replace(plan, blocks=blocks))
        assert torch.equal(torch.view_as_real(first), torch.view_as_real(again))
    assert cases.max_rel(first, usfft.scatter_gaussian_plain(f, x, n, m, mu)) < cases.KB_TOL
    on_cpu = usfft.geometry_plan(x.cpu(), n, m, mu, window="gaussian")
    written = cases.scatter_gaussian_kernel_order(f.cpu(), on_cpu)
    got = usfft.scatter_gaussian_cuda(f, x, n, m, mu, plan).cpu()
    assert cases.max_rel(got, written) < 1e-6


def test_gaussian_kernels_take_no_points_one_and_a_cuda_graph(card):
    """No points: a zero grid (the scatter still writes every value); one
    point: the plain version's value; both kernels captured in a CUDA graph
    on a prebuilt plan replay to the same bits."""
    n, m, mu = cases.gaussian_window_for(16, 1e-3, 2)
    gen = np.random.default_rng(11)
    grid = cases.crandn(gen, n, n, n, device=card)
    none = torch.zeros((0, 3), dtype=torch.float32, device=card)
    assert usfft.gather_gaussian_cuda(grid, none, n, m, mu).shape == (0,)
    empty = usfft.scatter_gaussian_cuda(torch.zeros(0, dtype=torch.complex64, device=card),
                                        none, n, m, mu)
    assert torch.count_nonzero(empty) == 0
    one = cases.flat_points(gen, 1, card)
    value = cases.crandn(gen, 1, device=card)
    assert cases.max_rel(usfft.gather_gaussian_cuda(grid, one, n, m, mu),
                         usfft.gather_gaussian_plain(grid, one, n, m, mu)) < cases.KB_TOL
    assert cases.max_rel(usfft.scatter_gaussian_cuda(value, one, n, m, mu),
                         usfft.scatter_gaussian_plain(value, one, n, m, mu)) < cases.KB_TOL
    x = cases.flat_points(gen, 3_000, card)
    f = cases.crandn(gen, 3_000, device=card)
    plan = usfft.geometry_plan(x, n, m, mu, window="gaussian")
    want = (usfft.gather_gaussian_cuda(grid, x, n, m, mu, plan),
            usfft.scatter_gaussian_cuda(f, x, n, m, mu, plan))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = (usfft.gather_gaussian_cuda(grid, x, n, m, mu, plan),
               usfft.scatter_gaussian_cuda(f, x, n, m, mu, plan))
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(torch.view_as_real(a), torch.view_as_real(b))


# (volume n, eps, upsample): m = 17 and 18 (the Gaussian at upsample 3, eps
# 1e-10 and upsample 4, eps 1e-8), 2m above a warp's lanes: the wide
# gather's three slots a lane, held at once.
WIDE_WINDOWS = [(14, 1e-10, 3), (11, 1e-8, 4)]


@pytest.mark.parametrize("n_volume, eps, upsample", WIDE_WINDOWS)
def test_gaussian_kernels_above_32_taps_match_plain(card, n_volume, eps, upsample):
    """Both kernels at m = 17 and 18 against the plain versions, adjoint,
    and three launches of each bitwise equal; the gather within 1e-6 of its
    written-out order."""
    n, m, mu = cases.gaussian_window_for(n_volume, eps, upsample)
    assert 2 * m > cases.GROUP_MAX_TAPS
    gen = np.random.default_rng(12)
    x = cases.flat_points(gen, 4_000, card)
    grid, f = cases.crandn(gen, n, n, n, device=card), cases.crandn(gen, 4_000, device=card)
    cases.check_kernels(grid, x, f, n, m, mu, f"m = {m}", "gaussian")
    plan = usfft.geometry_plan(x, n, m, mu, window="gaussian")
    assert cases.max_rel(usfft.gather_gaussian_cuda(grid, x, n, m, mu, plan),
                         cases.gather_gaussian_kernel_order(grid, plan)) < 1e-6


def test_gaussian_kernels_above_64_taps(card):
    """m = 33 (upsample 6, eps 1e-10; five slots a lane, more than a lane
    holds at once, so one after another): both kernels against the first
    form on one plan, the gather against its written-out order, adjoint, two
    launches of each bitwise equal."""
    n, m, mu = cases.gaussian_window_for(12, 1e-10, 6)
    assert m == 33 and 2 * m > cases.WIDE_INNER_SLOTS * cases.WIDE_LANES
    gen = np.random.default_rng(13)
    x = cases.flat_points(gen, 2_000, card)
    grid, f = cases.crandn(gen, n, n, n, device=card), cases.crandn(gen, 2_000, device=card)
    plan = usfft.geometry_plan(x, n, m, mu, window="gaussian")
    got = usfft.gather_gaussian_cuda(grid, x, n, m, mu, plan)
    spread = usfft.scatter_gaussian_cuda(f, x, n, m, mu, plan)
    assert cases.max_rel(got, cases.first_form_gather(grid, plan)) < cases.KB_TOL
    assert cases.max_rel(got, cases.gather_gaussian_kernel_order(grid, plan)) < 1e-6
    assert cases.max_rel(spread, cases.first_form_scatter(f, plan)) < cases.KB_TOL
    for a, b in ((got, usfft.gather_gaussian_cuda(grid, x, n, m, mu, plan)),
                 (spread, usfft.scatter_gaussian_cuda(f, x, n, m, mu, plan))):
        assert torch.equal(torch.view_as_real(a), torch.view_as_real(b))
    lhs, rhs = cases.inner64(got, f), cases.inner64(grid, spread)
    assert abs(lhs - rhs) / abs(lhs) < cases.ADJOINT_TOL


def test_gaussian_kernels_past_2_31_cells(card):
    """At n = 1292 (646^3 at upsample 2, m = 4: 2,156,689,088 cells) both
    kernels against the plain versions on points spread over the grid and
    points in cells past the 2^31-th, the scatter's grid compared plane by
    plane; adjoint; two launches of each bitwise equal."""
    n, m, mu = cases.gaussian_window_for(646, 1e-3, 2)
    assert n**3 > 2**31 and m == 4
    gen = np.random.default_rng(14)
    x = torch.cat([cases.flat_points(gen, 16_384, card),
                   cases.high_cell_points(gen, 4_096, n, 1, card)])
    grid = torch.randn((n, n, n), dtype=torch.complex64, device=card)
    f = cases.crandn(gen, x.shape[0], device=card)
    cases.check_kernels(grid, x, f, n, m, mu, f"n = {n}", "gaussian")


def test_dispatch_refuses_a_kb_plan(card):
    n, m, mu = cases.gaussian_window_for(16, 1e-3, 1)
    x = cases.flat_points(np.random.default_rng(6), 10, card)
    f = torch.zeros(10, dtype=torch.complex64, device=card)
    with pytest.raises(ValueError, match="kb window"):
        usfft.scatter(f, x, n, m, mu, usfft.geometry_plan(x, n, m, mu))
    # m = 17, once refused, takes the wide gather.
    grid = cases.crandn(np.random.default_rng(6), 40, 40, 40, device=card)
    assert cases.max_rel(usfft.gather(grid, x, 40, 17, mu),
                         usfft.gather_gaussian_plain(grid, x, 40, 17, mu)) < cases.KB_TOL


@pytest.mark.parametrize("upsample", [1, 2])
def test_lamino_runs_the_gaussian_kernels(card, upsample):
    """The forward and both adjoints on the card launch the Gaussian
    kernels once each, never the KB ones, and match the CPU's plain path;
    with the geometry's plan the same bits again."""
    cfg = lamino.LaminoConfig(n=16, tilt=np.pi / 3, eps=1e-3, upsample=upsample,
                              kernel="gaussian")
    theta = cases.lamino_theta(8, card)
    u = cases.crandn(np.random.default_rng(2), 16, 16, 16, device=card)
    before = dict(usfft.LAUNCHES)
    d = lamino.lamino_fwd(cfg, u, theta)
    back = lamino.lamino_adj_exact(cfg, d, theta)
    grad_like = lamino.lamino_adj(cfg, d, theta)
    torch.cuda.synchronize()
    assert {k: usfft.LAUNCHES[k] - before[k] for k in before} == {
        "usfft_gather_kb": 0, "usfft_scatter_kb": 0,
        "usfft_gather_gaussian": 1, "usfft_scatter_gaussian": 2,
    }
    cpu = theta.cpu()
    assert cases.max_rel(d.cpu(), lamino.lamino_fwd(cfg, u.cpu(), cpu)) < cases.KB_TOL
    assert cases.max_rel(back.cpu(), lamino.lamino_adj_exact(cfg, d.cpu(), cpu)) < cases.KB_TOL
    assert cases.max_rel(grad_like.cpu(), lamino.lamino_adj(cfg, d.cpu(), cpu)) < cases.KB_TOL
    plan = lamino.LaminoPlan(cfg, theta)
    assert plan.scatter.window == "gaussian" and plan.gather is plan.scatter
    assert torch.equal(torch.view_as_real(lamino.lamino_fwd(cfg, u, theta, plan)),
                       torch.view_as_real(d))


def test_eq2us_us2eq_and_spread_take_the_kernels(card):
    gen = np.random.default_rng(7)
    vol = cases.crandn(gen, 16, 16, 16)
    x = cases.flat_points(gen, 500, span=0.7)
    vals = cases.crandn(gen, 500)
    before = dict(usfft.LAUNCHES)
    for upsample in (1, 2):
        got = usfft.eq2us(vol.to(card), x.to(card), 16, 1e-3, upsample, "gaussian")
        want = usfft.eq2us(vol, x, 16, 1e-3, upsample, "gaussian")
        assert cases.max_rel(got.cpu(), want) < cases.KB_TOL
        got = usfft.us2eq(vals.to(card), x.to(card), 16, 1e-3, upsample, "gaussian")
        want = usfft.us2eq(vals, x, 16, 1e-3, upsample, "gaussian")
        assert cases.max_rel(got.cpu(), want) < cases.KB_TOL
        got = usfft.spread(vals.to(card), x.to(card), 16, 1e-3, upsample, "gaussian")
        want = usfft.spread(vals, x, 16, 1e-3, upsample, "gaussian")
        assert cases.max_rel(got.cpu(), want) < cases.KB_TOL
    torch.cuda.synchronize()
    assert usfft.LAUNCHES["usfft_gather_gaussian"] - before["usfft_gather_gaussian"] == 2
    assert usfft.LAUNCHES["usfft_scatter_gaussian"] - before["usfft_scatter_gaussian"] == 4
