"""The CUDA KB kernels (``csrc/usfft.cu``) and the probe kernels
(``csrc/probe.cu``) against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and ``nvcc``, is marked ``cuda``, and
skips without a card; whether there is one is decided inside each test, so
every worker collects the same tests. On a machine with a card, from the
root of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_usfft_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` configures JAX, which this file
does not import.) The checks are those of ``chip_smoke.py``'s USFFT and
probe phases, from ``tests/_torch_usfft_cases.py``, at smaller sizes.
"""

import numpy as np
import pytest
import torch

from tike_tpu_torch import toolchain_probe
from tike_tpu_torch.ops import lamino, usfft

from . import _torch_usfft_cases as cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build csrc/usfft.cu and csrc/probe.cu)")
    return torch.device("cuda", 0)


# (volume n, eps, upsample): m = 1, 2 (the compiled paths), 4 and 7 (the
# generic one).
WINDOWS = [(32, 1e-3, 1), (16, 1e-3, 2), (16, 1e-6, 2), (16, 1e-12, 2)]


@pytest.mark.parametrize("layout", ["rows", "flat"])
@pytest.mark.parametrize("n_volume, eps, upsample", WINDOWS)
def test_kb_kernels_match_plain(card, n_volume, eps, upsample, layout):
    """Both kernels against their plain versions and adjointness; three
    launches of each (two on one plan, one building its own) must be
    bitwise equal, or ``check_kernels`` raises."""
    n, m, beta = cases.window_for(n_volume, eps, upsample)
    gen = np.random.default_rng(0)
    if layout == "rows":
        x = cases.lamino_rows(n_volume, 16, card).reshape(-1, 3)
    else:
        x = cases.flat_points(gen, 20_000, card)
    grid = cases.crandn(gen, n, n, n, device=card)
    f = cases.crandn(gen, x.shape[0], device=card)
    cases.check_kernels(grid, x, f, n, m, beta, f"{layout}, m = {m}")


def test_kb_kernels_past_2_31_cells(card):
    """At n = 1292 (646^3 at upsample 2, m = 2: 2,156,689,088 cells) both
    kernels against the plain versions on points spread over the grid and
    points in cells past the 2^31-th, the scatter's grid (its 4 copies of a
    row of 1292 cells in 41 KB of shared memory) compared plane by plane;
    adjoint; two launches of each bitwise equal."""
    n, m, beta = cases.window_for(646, 1e-3, 2)
    assert n**3 > 2**31 and m == 2
    gen = np.random.default_rng(15)
    x = torch.cat([cases.flat_points(gen, 16_384, card),
                   cases.high_cell_points(gen, 4_096, n, 0, card)])
    grid = torch.randn((n, n, n), dtype=torch.complex64, device=card)
    f = cases.crandn(gen, x.shape[0], device=card)
    cases.check_kernels(grid, x, f, n, m, beta, f"n = {n}")


def test_kb_scatter_asks_for_shared_memory_above_n_1536(card):
    """n = 1540: four copies of a row, 49,280 bytes, pass the 48 KB a block
    gets unasked; the scatter asks for more and matches the plain version."""
    n, m, beta = 1540, 2, 5.0
    gen = np.random.default_rng(16)
    x = cases.flat_points(gen, 8_000, card)
    f = cases.crandn(gen, 8_000, device=card)
    plan = usfft.geometry_plan(x, n, m, beta)
    spread = usfft.scatter_kb_cuda(f, x, n, m, beta, plan)
    plain = usfft.scatter_kb_plain(f, x, n, m, beta)
    worst = max(float(torch.max(torch.abs(a - b))) for a, b in cases._planes(spread, plain))
    scale = max(float(torch.max(torch.abs(b))) for _, b in cases._planes(spread, plain))
    assert worst / scale < cases.KB_TOL


@pytest.mark.parametrize("m, beta", [(1, 2.0), (2, 5.0), (4, 9.0)])
def test_kb_kernels_take_no_points_and_one(card, m, beta):
    grid = torch.ones((8, 8, 8), dtype=torch.complex64, device=card)
    x = torch.zeros((0, 3), device=card)
    assert usfft.gather_kb_cuda(grid, x, 8, m, beta).shape == (0,)
    spread = usfft.scatter_kb_cuda(torch.zeros(0, dtype=torch.complex64, device=card), x, 8, m, beta)
    assert spread.shape == (8, 8, 8) and torch.count_nonzero(spread) == 0
    gen = np.random.default_rng(3)
    x = cases.flat_points(gen, 1, card)
    cases.check_kernels(
        cases.crandn(gen, 8, 8, 8, device=card), x, cases.crandn(gen, 1, device=card),
        8, m, beta, f"one point, m = {m}",
    )


def test_scatter_is_bitwise_repeatable_on_piled_points(card):
    """Half of the points in a few cells, the others spread: long runs
    beside empty rows. Ten launches, one result."""
    n, m, beta = cases.window_for(32, 1e-3, 1)
    gen = np.random.default_rng(4)
    x = cases.flat_points(gen, 40_000, card)
    x[:20_000] = 0.01 + 0.02 * x[:20_000]
    f = cases.crandn(gen, x.shape[0], device=card)
    plan = usfft.geometry_plan(x, n, m, beta)
    first = usfft.scatter_kb_cuda(f, x, n, m, beta, plan)
    for _ in range(9):
        again = usfft.scatter_kb_cuda(f, x, n, m, beta, plan)
        assert torch.equal(torch.view_as_real(again), torch.view_as_real(first))
    assert cases.max_rel(first, usfft.scatter_kb_plain(f, x, n, m, beta)) < cases.KB_TOL


def test_kernels_run_in_a_cuda_graph_on_a_prebuilt_plan(card):
    """With the plan built beforehand a call reads nothing back and
    allocates only its output: a CUDA graph captures it."""
    n, m, beta = cases.window_for(16, 1e-3, 2)
    gen = np.random.default_rng(5)
    x = cases.lamino_rows(16, 8, card).reshape(-1, 3)
    grid = cases.crandn(gen, n, n, n, device=card)
    f = cases.crandn(gen, x.shape[0], device=card)
    plan = usfft.geometry_plan(x, n, m, beta)
    want = usfft.gather_kb_cuda(grid, x, n, m, beta, plan), usfft.scatter_kb_cuda(f, x, n, m, beta, plan)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = usfft.gather_kb_cuda(grid, x, n, m, beta, plan), usfft.scatter_kb_cuda(f, x, n, m, beta, plan)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(torch.view_as_real(a), torch.view_as_real(b))


def test_scatter_refuses_a_plan_sorted_by_tiles(card):
    x = cases.flat_points(np.random.default_rng(6), 10, card)
    f = torch.zeros(10, dtype=torch.complex64, device=card)
    with pytest.raises(ValueError, match="bin order"):
        usfft.scatter_kb_cuda(f, x, 8, 1, 2.0, usfft.geometry_plan(x, 8, 1, 2.0, (2, 2)))


def test_einsum_yardstick_matches_the_kernels(card):
    n, m, beta = cases.window_for(32, 1e-3, 1)
    rows = cases.lamino_rows(32, 16, card)
    gen = np.random.default_rng(1)
    grid = cases.crandn(gen, n, n, n, device=card)
    f = cases.crandn(gen, *rows.shape[:2], device=card)
    got = usfft.gather_kb_cuda(grid, rows.reshape(-1, 3), n, m, beta)
    einsum = cases.gather_rows_einsum(grid, rows, n, m, beta).reshape(-1)
    assert cases.max_rel(einsum, got) < cases.EINSUM_TOL
    got = usfft.scatter_kb_cuda(f.reshape(-1), rows.reshape(-1, 3), n, m, beta)
    assert cases.max_rel(cases.scatter_rows_einsum(f, rows, n, m, beta), got) < cases.EINSUM_TOL


def test_wrappers_count_launches_and_lamino_runs_through_them(card):
    before = dict(usfft.LAUNCHES)
    cfg = lamino.LaminoConfig(n=16, tilt=np.pi / 3, eps=1e-3, upsample=2)
    theta = cases.lamino_theta(8, card)
    u = cases.crandn(np.random.default_rng(2), 16, 16, 16, device=card)
    d = lamino.lamino_fwd(cfg, u, theta)
    back = lamino.lamino_adj_exact(cfg, d, theta)
    torch.cuda.synchronize()
    assert usfft.LAUNCHES["usfft_gather_kb"] == before["usfft_gather_kb"] + 1
    assert usfft.LAUNCHES["usfft_scatter_kb"] == before["usfft_scatter_kb"] + 1
    want = lamino.lamino_fwd(cfg, u.cpu(), theta.cpu())
    assert cases.max_rel(d.cpu(), want) < cases.KB_TOL
    # With the geometry's plan: the same bits, and the plans built once.
    plan = lamino.LaminoPlan(cfg, theta)
    for _ in range(2):
        assert torch.equal(torch.view_as_real(lamino.lamino_fwd(cfg, u, theta, plan)),
                           torch.view_as_real(d))
        assert torch.equal(torch.view_as_real(lamino.lamino_adj_exact(cfg, d, theta, plan)),
                           torch.view_as_real(back))
    assert plan.scatter.row_start is not None and plan.gather is plan.scatter  # m = 2


def test_transforms_at_half_support_7(card):
    """upsample 2 at eps 1e-12 (m = 7) on the card against the plain
    versions on the CPU."""
    gen = np.random.default_rng(7)
    vol = cases.crandn(gen, 16, 16, 16)
    x = cases.flat_points(gen, 500, span=0.49)
    vals = cases.crandn(gen, 500)
    assert usfft.kb_parameters(16, 1e-12, 2)[2] == 7
    got = usfft.eq2us(vol.to(card), x.to(card), 16, 1e-12, 2)
    assert cases.max_rel(got.cpu(), usfft.eq2us(vol, x, 16, 1e-12, 2)) < cases.KB_TOL
    got = usfft.us2eq(vals.to(card), x.to(card), 16, 1e-12, 2)
    assert cases.max_rel(got.cpu(), usfft.us2eq(vals, x, 16, 1e-12, 2)) < cases.KB_TOL


def test_probes_equal_their_plain_versions(card):
    inp = toolchain_probe.inputs(card)
    before = dict(toolchain_probe.LAUNCHES)
    outputs = toolchain_probe.run(inp)
    torch.cuda.synchronize()
    toolchain_probe.check(outputs, inp)
    assert all(toolchain_probe.LAUNCHES[k] == before[k] + 1 for k in before)


def test_dynamic_dma_refuses_unaligned_corners(card):
    inp = toolchain_probe.inputs(card)
    with pytest.raises(ValueError, match="multiples of 4"):
        toolchain_probe.dynamic_dma(inp["element_corners"], inp["big"])
