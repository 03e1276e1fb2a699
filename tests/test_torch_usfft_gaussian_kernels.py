"""The Gaussian kernels' entry points, limits and written-out summation
orders (``csrc/usfft_gaussian.cu``), on the CPU.

What the CUDA kernels read and in what order they add can be held here:
the scatter's blocks in the plan, the source's limits against the
package's, ``tests/_torch_usfft_cases.py``'s ``gather_gaussian_kernel_order``
and ``scatter_gaussian_kernel_order`` against ``tike_tpu.ops.usfft.scatter``
and each other (adjointness), and the refusals that come before a launch.
"""

import re

import pytest
import torch

import tike_tpu.ops.usfft as ju
from tike_tpu_torch.ops import usfft as tu

from . import _torch_usfft_cases as cases
from ._torch_parity import assert_close, crandn, rng, t
from .test_torch_usfft_gaussian import TOL, WINDOWS, _cells, _window


def test_gaussian_entry_points_refuse_other_plans_and_large_m():
    """The Gaussian kernels' entry points refuse a KB plan before anything
    runs, and the KB dispatch a Gaussian plan; m = 17 (2m above a warp's
    lanes) is refused only for its CPU tensors, as any m is."""
    n, m, mu = _window(8, 1e-3, 2)
    x = cases.flat_points(rng(13), 40, span=0.7)
    Fe, f = t(crandn(rng(14), n, n, n)), t(crandn(rng(15), 40))
    gaussian = tu.geometry_plan(x, n, m, mu, window="gaussian")
    for entry, data in ((tu.gather_gaussian_cuda, Fe), (tu.scatter_gaussian_cuda, f)):
        with pytest.raises(ValueError, match="kb window"):
            entry(data, x, n, m, mu, tu.geometry_plan(x, n, m, mu))
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            entry(data, x, 40, 17, mu)
    with pytest.raises(ValueError, match="gaussian window"):
        tu.gather_kb(Fe, x, n, m, mu, gaussian)
    with pytest.raises(ValueError, match="window must be"):
        tu.geometry_plan(x, n, m, mu, window="sinc")
    assert set(tu.LAUNCHES.values()) == {0}


def test_source_limits_and_orders_are_the_package_s():
    """csrc/usfft_gaussian.cu's limits, its scatter's bands and warps and its
    gathers' split are the package's and the written-out orders', and
    csrc/usfft.cu's limits the package's. Every block's copies of its band
    lie within the shared memory a block may ask for at every n where each
    band height is used, and each height is the most that fits."""
    def constants(name):
        with open(tu.__file__.replace("ops/usfft.py", f"csrc/{name}.cu")) as file:
            source = file.read()
        return lambda key: int(re.search(rf"constexpr int {key} = (\d+);", source).group(1))

    constant, kb = constants("usfft_gaussian"), constants("usfft")
    assert constant("kMaxN") == kb("kMaxN") == tu.MAX_N
    assert constant("kMaxShared") == kb("kMaxShared") == tu.MAX_SHARED
    assert constant("kGroupMaxTaps") == cases.GROUP_MAX_TAPS
    assert constant("kWideLanes") == cases.WIDE_LANES
    assert constant("kBandRowsSmallM") == tu.band_rows(1, 64) == tu.band_rows(2, 64)
    assert constant("kBandRowsLargeM") == tu.band_rows(3, 64) == tu.band_rows(22, 64)
    assert constant("kWideInnerSlots") == cases.WIDE_INNER_SLOTS
    assert constant("kScatterWarps") == cases.SCATTER_WARPS == tu._SCATTER_WARPS
    assert constant("kThreadGatherMaxM") == cases.THREAD_GATHER_MAX_M
    copies = lambda rows, n: cases.SCATTER_WARPS * rows * n * 8
    for m in (1, 2, 3, 4, 17, 22, 40):
        for n in range(2 * m, 7265):
            rows = tu.band_rows(m, n)
            assert copies(rows, n) <= tu.MAX_SHARED
            assert rows == tu.band_rows(m, 64) or copies(rows + 1, n) > tu.MAX_SHARED
    # Where each height starts: 4 rows up to n = 1816 at m <= 2, 2 up to 3632.
    assert [tu.band_rows(2, n) for n in (1816, 1817, 2421, 2422, 3632, 3633)] == [4, 3, 3, 2, 2, 1]
    assert [tu.band_rows(4, n) for n in (1292, 3632, 3633, 7264)] == [2, 2, 1, 1]
    # The KB scatter's copies of a row: within 48 KB up to n = 1536.
    assert 4 * 1536 * 8 <= 48 * 1024 < 4 * 1537 * 8


@pytest.mark.parametrize("n_volume", [8, 7])
def test_plan_orders_the_scatter_bands(n_volume):
    """A Gaussian plan in bin order covers every row of the grid once with
    the scatter's blocks, bands of band_rows(m, n) rows of a plane (fewer in its
    last), those whose rows of bins hold the most points first (or, asked
    for, in the grid's order); a plan sorted by tiles of the gather and a KB
    plan hold none."""
    n, m, mu = _window(n_volume, 1e-3, 2)  # a 16^3 (14^3) grid, m = 4
    x = cases.flat_points(rng(19), 500, span=0.3)
    plan = tu.geometry_plan(x, n, m, mu, window="gaussian")
    cell = _cells(x, n)
    band = tu.band_rows(m, n)
    assert plan.blocks.dtype == torch.int32 and plan.blocks.shape == (n * -(-n // band), 2)
    covered = torch.zeros(n * n, dtype=torch.int64)
    held = []
    for first, rows in plan.blocks.tolist():
        c0, c1 = divmod(first, n)
        assert c1 % band == 0 and rows == min(band, n - c1)
        covered[first:first + rows] += 1
        near0 = (cell[:, 0] - (c0 - m)) % n < 2 * m
        # The rows of bins c1 - m ... c1 + rows + m - 2, a row twice where
        # they pass the grid's end.
        place1 = (cell[:, 1] - (c1 - m)) % n
        near1 = (place1 < rows + 2 * m - 1).long() + (place1 + n < rows + 2 * m - 1).long()
        held.append(int((near0 * near1).sum()))
    assert bool(torch.all(covered == 1))
    assert held == sorted(held, reverse=True) and held[0] > held[-1]
    in_order = tu._scatter_blocks(plan.row_start, n, m, busiest_first=False)
    assert in_order[:, 0].tolist() == sorted(plan.blocks[:, 0].tolist())
    assert tu.geometry_plan(x, n, m, mu, tile=(8, 8), window="gaussian").blocks is None
    assert tu.geometry_plan(x, n, m, mu).blocks is None


@pytest.mark.parametrize("n_volume, eps, upsample", WINDOWS)
def test_scatter_kernel_order_takes_spread_and_piled_points(n_volume, eps, upsample):
    """The scatter's contraction, on points spread out (chunks of distinct
    base cells) and piled in a few cells (long runs summed by the scan),
    equals tike_tpu's scatter, and the gather's contraction is its
    adjoint."""
    n, m, mu = _window(n_volume, eps, upsample)
    gen = rng(16)
    spread_out = cases.flat_points(gen, 40, span=0.49)
    piled = torch.cat([0.002 * spread_out[:20], spread_out[20:]])
    for x in (spread_out, piled):
        Fe, f = crandn(gen, n, n, n), crandn(gen, 40)
        plan = tu.geometry_plan(x, n, m, mu, window="gaussian")
        spread = cases.scatter_gaussian_kernel_order(t(f), plan)
        assert_close(spread, ju.scatter(f, x.numpy(), n, m, mu), rtol=TOL, atol=TOL, scale=True)
        lhs = cases.inner64(cases.gather_gaussian_kernel_order(t(Fe), plan), t(f))
        rhs = cases.inner64(t(Fe), spread)
        assert abs(lhs - rhs) / abs(lhs) < cases.ADJOINT_TOL


def test_gaussian_sweep_variants_apply_to_the_source():
    """Every default variant of ``kernel_sweep --source gaussian`` finds the
    text it replaces in ``csrc/usfft_gaussian.cu`` and changes it."""
    from tike_tpu_torch import kernel_sweep

    with open(kernel_sweep.GAUSSIAN_SOURCE) as file:
        source = file.read()
    variants = kernel_sweep.gaussian_variants(source)
    assert len(variants) >= 10
    for name, substitutions in variants.items():
        changed = kernel_sweep.variant_source(source, substitutions)
        assert (changed != source) == bool(substitutions), name
