"""The USFFT kernels' plans past 2^31 cells and the Gaussian window above
2m = 32 taps, on the CPU.

A grid above n = 1290 has more than 2^31 cells: the plan indexes a point's
cell as a row of bins ``c0 n + c1`` (int32) and a column ``c2`` (int16),
and holds n^2 + 1 row starts, so it builds at n = 1292 here on a few
hundred points. The Gaussian gather above 32 taps (m >= 17: upsample 3 at
eps 1e-10, upsample 4) gives a point 16 lanes with a slot of taps a lane; its
summation order, and the scatter's at such m, are written out in
``tests/_torch_usfft_cases.py`` and held to ``tike_tpu``. The transforms
shift and FFT grids of ``LEAN_CELLS`` cells or more in place; below, they
are the composition they were, bit for bit.
``tike_tpu`` itself indexes the grid in int32 and wraps past 2^31 cells.
"""

import numpy as np
import pytest
import torch

import tike_tpu.ops.usfft as ju
from tike_tpu_torch.ops import usfft as tu

from . import _torch_usfft_cases as cases
from ._torch_parity import assert_close, crandn, rng, t

TOL = 1e-5
LARGE_N = 1292  # 646^3 at upsample 2: 2,156,689,088 cells


def _points_in_cells(cells, n: int, shift: int) -> np.ndarray:
    """float32 points whose base cells (shift 0 for KB, 1 for the Gaussian)
    are ``cells`` (K, 3), a point at the middle of each, some of them
    wrapped outside [-0.5, 0.5)."""
    ell = (np.asarray(cells) - n // 2 + shift) % n
    x = (ell + 0.5) / n
    x = np.where(x >= 0.5, x - 1.0, x)
    x[::3] += 1.0  # a third of the points one period away
    return x.astype(np.float32)


@pytest.mark.parametrize("window", ["kb", "gaussian"])
def test_plan_at_n_1292_indexes_cells_past_2_31(window):
    """A plan at n = 1292 on 300 points, 40 of them in cells past the
    2^31-th: its bins decode to the points' cells, its row starts equal a
    numpy count, and the Gaussian scatter's bands cover every row once."""
    n = LARGE_N
    m, param = (2, 5.0) if window == "kb" else (4, 8.3e-6)
    shift = {"kb": 0, "gaussian": 1}[window]
    gen = rng(31)
    high = np.stack([gen.integers(1287, n, 40), gen.integers(0, n, 40), gen.integers(0, n, 40)], 1)
    x = np.concatenate([gen.uniform(-0.7, 0.7, (260, 3)).astype(np.float32),
                        _points_in_cells(high, n, shift)])
    plan = tu.geometry_plan(t(x), n, m, param, window=window)
    cell = (n // 2 - shift + np.floor(np.float32(n) * x).astype(np.int64)) % n
    flat = (cell[:, 0] * n + cell[:, 1]) * n + cell[:, 2]
    assert int((flat >= 2**31).sum()) >= 40
    order = plan.order.numpy().astype(np.int64)
    assert np.array_equal(np.sort(order), np.arange(300))
    bins = plan.bins.numpy()
    assert np.array_equal(bins, flat[order]) and np.all(np.diff(bins) >= 0)
    assert np.array_equal(np.stack([bins // (n * n), bins // n % n, bins % n], 1), cell[order])
    start = plan.row_start.numpy().astype(np.int64)
    count = np.bincount(cell[:, 0] * n + cell[:, 1], minlength=n * n)
    assert start.shape == (n * n + 1,) and np.array_equal(start[1:], np.cumsum(count))
    assert plan.nbytes == 300 * (4 + 4 + 2 + 3 * 2 * m * 4) + 4 * (n * n + 1) + (
        0 if plan.blocks is None else plan.blocks.numel() * 4)
    blocks = tu._scatter_blocks(plan.row_start, n, m) if plan.blocks is None else plan.blocks
    covered = np.zeros(n * n, np.int64)
    for first, rows in blocks.tolist():
        covered[first:first + rows] += 1
    assert np.all(covered == 1)


# (volume n, eps, upsample): m = 17, 18 and 22 on 42^3 and 44^3 grids.
WIDE_WINDOWS = [(14, 1e-10, 3), (11, 1e-8, 4), (11, 1e-10, 4)]


@pytest.mark.parametrize("n_volume, eps, upsample", WIDE_WINDOWS)
def test_wide_orders_match_jax(n_volume, eps, upsample):
    """Above 32 taps: the gather's written-out order (16 lanes a point, a slot
    of taps a lane) and the scatter's, the plain versions the CPU dispatch
    takes, and tike_tpu's gather and scatter agree at 1e-5, and the orders
    are adjoint."""
    n, m, mu = cases.gaussian_window_for(n_volume, eps, upsample)
    assert 2 * m > cases.GROUP_MAX_TAPS and 40 <= n <= 48
    gen = rng(32 + m)
    x = cases.flat_points(gen, 40, span=0.7)
    Fe, f = crandn(gen, n, n, n), crandn(gen, 40)
    plan = tu.geometry_plan(x, n, m, mu, window="gaussian")
    gathered = cases.gather_gaussian_kernel_order(t(Fe), plan)
    spread = cases.scatter_gaussian_kernel_order(t(f), plan)
    close = dict(rtol=TOL, atol=TOL, scale=True)
    want_gather, want_scatter = ju.gather(Fe, x.numpy(), n, m, mu), ju.scatter(f, x.numpy(), n, m, mu)
    for got, want in ((gathered, want_gather), (tu.gather(t(Fe), x, n, m, mu), want_gather),
                      (spread, want_scatter), (tu.scatter(t(f), x, n, m, mu), want_scatter)):
        assert_close(got, want, **close)
    lhs, rhs = cases.inner64(gathered, t(f)), cases.inner64(t(Fe), spread)
    assert abs(lhs - rhs) / abs(lhs) < cases.ADJOINT_TOL


@pytest.mark.parametrize("n, m", [(LARGE_N, 2), (LARGE_N, 17), (2048, 22), (88, 44)])
def test_entry_points_take_any_grid_and_half_support(n, m):
    """No size or half-support limit is left before a launch: given CPU
    tensors, each CUDA entry point refuses them for being on the CPU, and
    nothing else; m < 1 and 2m > n are refused as tike_tpu refuses them."""
    x = cases.flat_points(rng(33), 8, span=0.7)
    grid, f = torch.zeros((2, 2, 2), dtype=torch.complex64), torch.zeros(8, dtype=torch.complex64)
    for entry, data in ((tu.gather_kb_cuda, grid), (tu.scatter_kb_cuda, f),
                        (tu.gather_gaussian_cuda, grid), (tu.scatter_gaussian_cuda, f)):
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            entry(data, x, n, m, 1.0)
        for bad in (0, n // 2 + 1):
            with pytest.raises(ValueError, match="2 m <= n"):
                entry(data, x, n, bad, 1.0)
    assert set(tu.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("n, upsample, kernel", [(8, 2, "kb"), (7, 2, "gaussian"), (9, 1.5, "kb")])
def test_transforms_are_the_shifted_composition_bit_for_bit(n, upsample, kernel):
    """eq2us and us2eq, below ``LEAN_CELLS``, equal the composition
    fftshift(fftn(ifftshift(.))) of the padded grid bit for bit."""
    gen = rng(34)
    f, values = crandn(gen, n, n, n), crandn(gen, 50)
    x = gen.uniform(-0.6, 0.6, (50, 3)).astype(np.float32)
    upsampled, pad, m, param = tu._parameters(n, 1e-3, upsample, kernel)
    deapod = tu.deapodization(n, 1e-3, upsample, kernel, torch.float32)
    fe = torch.zeros((upsampled,) * 3, dtype=torch.complex64)
    end = pad + n
    fe[pad:end, pad:end, pad:end] = t(f) / deapod
    gather = tu.gather_kb if kernel == "kb" else tu.gather
    centred = lambda grid: torch.fft.fftshift(torch.fft.fftn(torch.fft.ifftshift(grid)))
    want = gather(centred(fe), t(x), upsampled, m, param)
    got = tu.eq2us(t(f), t(x), n, 1e-3, upsample, kernel)
    assert torch.equal(torch.view_as_real(got), torch.view_as_real(want))
    spread = tu.spread(t(values), t(x), n, 1e-3, upsample, kernel)
    want = centred(spread)[pad:end, pad:end, pad:end] / deapod
    got = tu.us2eq(t(values), t(x), n, 1e-3, upsample, kernel)
    assert torch.equal(torch.view_as_real(got), torch.view_as_real(want))


@pytest.mark.parametrize("n, upsample, kernel", [(8, 2, "kb"), (7, 2, "gaussian")])
def test_transforms_in_place_on_large_grids(n, upsample, kernel, monkeypatch):
    """Past ``LEAN_CELLS`` (here every grid, in slabs of 40 cells) the
    shift is ``fftshift`` bit for bit and the FFT ``fftn`` / ``ifftn`` within
    float32 rounding, both in place; eq2us, us2eq and the exact adjoint
    agree with the composition they replace within 1e-6 of the largest
    value."""
    gen = rng(35)
    f, values = crandn(gen, n, n, n), crandn(gen, 50)
    x = t(gen.uniform(-0.6, 0.6, (50, 3)).astype(np.float32))
    want = (tu.eq2us(t(f), x, n, 1e-3, upsample, kernel),
            tu.us2eq(t(values), x, n, 1e-3, upsample, kernel))
    grid = t(crandn(gen, 2 * n, 2 * n, 2 * n))
    monkeypatch.setattr(tu, "LEAN_CELLS", 0)
    monkeypatch.setattr(tu, "_SLAB_CELLS", 40)
    shifted = tu._shift(grid.clone())
    assert torch.equal(shifted, torch.fft.fftshift(grid))
    for inverse, full in ((False, torch.fft.fftn), (True, torch.fft.ifftn)):
        copy = grid.clone()
        got = tu._fftn(copy, inverse)
        assert got.data_ptr() == copy.data_ptr()
        assert cases.max_rel(got, full(grid)) < 1e-6
    got = (tu.eq2us(t(f), x, n, 1e-3, upsample, kernel),
           tu.us2eq(t(values), x, n, 1e-3, upsample, kernel))
    for a, b in zip(got, want):
        assert cases.max_rel(a, b) < 1e-6


def test_plain_taps_index_past_2_31_where_tike_tpu_wraps():
    """At n = 1292 the port's plain Gaussian taps index the last cell
    (2,156,689,087, past 2^31) in int64, where tike_tpu's int32 flat index,
    formed as its gather and scatter form it, wraps to -2,138,278,209 (a
    reference behaviour, ROADMAP §3)."""
    import jax.numpy as jnp

    n, m, mu = LARGE_N, 4, 8.3e-6
    x = torch.full((1, 3), 0.4997, dtype=torch.float32)  # floor(n x) = 645
    flats = torch.cat([flat.reshape(-1) for _, flat in tu._gaussian_rows(x, n, m, mu)])
    assert flats.dtype == torch.int64 and int(flats.max()) == n**3 - 1 > 2**31
    g = (n // 2 + jnp.floor(n * jnp.asarray(x.numpy())).astype(jnp.int32)) % n  # the tap at offset 0
    flat = (g[:, 0] * n + g[:, 1]) * n + g[:, 2]
    assert flat.dtype == jnp.int32 and int(flat[0]) == -2_138_278_209
