"""tike_tpu_torch.ops.usfft against tike_tpu.ops.usfft on the CPU.

Both packages get the same numpy inputs (77 flat points on a 16^3 grid, as
``tests/operators/test_usfft.py``, or laminography's rows of a 16^3 volume
at 8 angles, JAX's grid as numpy) and the port runs its plain versions.
Tolerance 1e-5 relative to the largest value everywhere: the same taps and
weights in float32, with i0e from two libraries and sums in other orders
(measured 1e-7 to 2e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tike_tpu.ops.usfft as ju
from tike_tpu.ops.lamino import make_grids as jax_make_grids
from tike_tpu_torch.ops import usfft as tu

from . import _torch_usfft_cases as cases
from ._torch_parity import assert_close, crandn, rng, t

TOL = 1e-5
N_GRID, N_PTS = 16, 77
# (volume n, eps, upsample) -> KB half-support m: 1 (upsample 1), 2, 4.
WINDOWS = [(16, 1e-3, 1), (8, 1e-3, 2), (8, 1e-6, 2)]


def _flat(seed=0, span=0.49):
    gen = rng(seed)
    return crandn(gen, N_GRID, N_GRID, N_GRID), gen.uniform(
        -span, span, (N_PTS, 3)
    ).astype(np.float32), crandn(gen, N_PTS)


def _rows(n_vol=16, ntheta=8):
    theta = np.linspace(0, 2 * np.pi, ntheta, endpoint=False).astype(np.float32)
    return np.asarray(jax_make_grids(jnp.asarray(theta), n_vol, np.pi / 3)).reshape(
        ntheta * n_vol, n_vol, 3
    )


@pytest.mark.parametrize(
    "n_, eps, upsample",
    [(16, 1e-3, 1), (16, 1e-6, 2), (128, 1e-3, 1), (128, 1e-3, 2), (33, 1e-2, 1.5)],
)
def test_parameters_match(n_, eps, upsample):
    assert tu.usfft_parameters(n_, eps, upsample) == ju.usfft_parameters(n_, eps, upsample)
    assert tu.kb_parameters(n_, eps, upsample) == ju.kb_parameters(n_, eps, upsample)


@pytest.mark.parametrize("n_, eps, upsample", WINDOWS)
def test_deapodization_matches(n_, eps, upsample):
    up, _, m, beta = tu.kb_parameters(n_, eps, upsample)
    np.testing.assert_array_equal(
        tu._kb_deapod_axis(n_, up, m, beta), ju._kb_deapod_axis(n_, up, m, beta)
    )
    np.testing.assert_array_equal(tu._i0e_host([0.5, beta, 40.0]), ju._i0e_host([0.5, beta, 40.0]))
    assert_close(
        tu._kb_get_kernel(n_, up, m, beta, torch.float32),
        ju._kb_get_kernel(n_, up, m, beta, jnp.float32),
        rtol=TOL,
    )
    _, _, mu, _ = tu.usfft_parameters(n_, eps, upsample)
    assert_close(tu._get_kernel(n_, mu), ju._get_kernel(n_, mu), rtol=TOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_checkerboard_matches(inverse):
    a = crandn(rng(3), 6, 4, 10)
    assert_close(
        tu.checkerboard(t(a), inverse=inverse), ju.checkerboard(a, inverse=inverse), rtol=0
    )
    with pytest.raises(ValueError):
        tu.checkerboard(t(crandn(rng(3), 3, 4)))


@pytest.mark.parametrize("n_, eps, upsample", WINDOWS)
def test_axis_weights_match(n_, eps, upsample):
    up, _, m, beta = tu.kb_parameters(n_, eps, upsample)
    x = rng(1).uniform(-0.7, 0.7, 200).astype(np.float32)
    ell = np.floor(up * x).astype(np.float32)
    assert_close(
        tu._kb_axis_weights(t(x), t(ell), m, beta, up),
        ju._kb_axis_weights(jnp.asarray(x), jnp.asarray(ell), m, beta, up),
        rtol=TOL,
        atol=TOL,
    )


@pytest.mark.parametrize("span", [0.49, 0.7], ids=["inside", "wrapped"])
@pytest.mark.parametrize("n_, eps, upsample", WINDOWS)
def test_flat_gather_and_scatter_kb_match(n_, eps, upsample, span):
    _, m, beta = cases.window_for(n_, eps, upsample)
    Fe, x, f = _flat(span=span)
    assert_close(
        tu.gather_kb(t(Fe), t(x), N_GRID, m, beta),
        ju.gather_kb(Fe, x, N_GRID, m, beta),
        rtol=TOL, atol=TOL, scale=True,
    )
    assert_close(
        tu.scatter_kb(t(f), t(x), N_GRID, m, beta),
        ju.scatter_kb(f, x, N_GRID, m, beta),
        rtol=TOL, atol=TOL, scale=True,
    )


@pytest.mark.parametrize("upsample, eps", [(1, 1e-3), (2, 1e-3)])
def test_rows_gather_and_scatter_kb_match(upsample, eps):
    grid, m, beta = cases.window_for(16, eps, upsample)
    x = _rows()
    gen = rng(2)
    Fe = crandn(gen, grid, grid, grid)
    f = crandn(gen, *x.shape[:2])
    close = dict(rtol=TOL, atol=TOL, scale=True)
    want = ju.gather_kb_rows(Fe, x, grid, m, beta)
    assert_close(tu.gather_kb_rows(t(Fe), t(x), grid, m, beta), want, **close)
    # The einsum yardstick of chip_smoke.py is the same formulation.
    assert_close(cases.gather_rows_einsum(t(Fe), t(x), grid, m, beta), want, **close)
    want = ju.scatter_kb_rows(f, x, grid, m, beta)
    assert_close(tu.scatter_kb_rows(t(f), t(x), grid, m, beta), want, **close)
    assert_close(cases.scatter_rows_einsum(t(f), t(x), grid, m, beta), want, **close)


def test_gaussian_gather_and_scatter_match():
    _, _, mu, m = tu.usfft_parameters(8, 1e-3, 2)
    Fe, x, f = _flat(span=0.7)
    close = dict(rtol=TOL, atol=TOL, scale=True)
    assert_close(tu.gather(t(Fe), t(x), N_GRID, m, mu), ju.gather(Fe, x, N_GRID, m, mu), **close)
    assert_close(tu.scatter(t(f), t(x), N_GRID, m, mu), ju.scatter(f, x, N_GRID, m, mu), **close)


@pytest.mark.parametrize("kernel", ["kb", "gaussian"])
@pytest.mark.parametrize("upsample", [1, 2])
@pytest.mark.parametrize("layout", ["flat", "rows"])
def test_eq2us_and_us2eq_match(kernel, upsample, layout):
    gen = rng(4)
    if layout == "flat":
        f = crandn(gen, N_GRID, N_GRID, N_GRID)
        x = gen.uniform(-0.49, 0.49, (N_PTS, 3)).astype(np.float32)
    else:
        f = crandn(gen, 16, 16, 16)
        x = _rows()
    vals = crandn(gen, *x.shape[:-1])
    assert_close(
        tu.eq2us(t(f), t(x), 16, 1e-3, upsample, kernel),
        ju.eq2us(f, x, 16, 1e-3, upsample, kernel),
        rtol=TOL, atol=TOL, scale=True,
    )
    assert_close(
        tu.us2eq(t(vals), t(x), 16, 1e-3, upsample, kernel),
        ju.us2eq(vals, x, 16, 1e-3, upsample, kernel),
        rtol=TOL, atol=TOL, scale=True,
    )


@pytest.mark.parametrize("n_, eps, upsample", WINDOWS)
def test_plain_kb_pair_is_adjoint(n_, eps, upsample):
    _, m, beta = cases.window_for(n_, eps, upsample)
    Fe, x, f = (t(a) for a in _flat(span=0.7))
    lhs = cases.inner64(tu.gather_kb_plain(Fe, x, N_GRID, m, beta), f)
    rhs = cases.inner64(Fe, tu.scatter_kb_plain(f, x, N_GRID, m, beta))
    assert abs(lhs - rhs) / abs(lhs) < cases.ADJOINT_TOL


def test_cuda_wrappers_refuse_cpu_tensors_and_bad_m():
    Fe, x, f = (t(a) for a in _flat())
    with pytest.raises(ValueError, match="CUDA"):
        tu.gather_kb_cuda(Fe, x, N_GRID, 1, 2.0)
    with pytest.raises(ValueError, match="CUDA"):
        tu.scatter_kb_cuda(f, x, N_GRID, 1, 2.0)
    # Any half-support runs that fits the grid (2 m <= n); m = 7 did not once.
    with pytest.raises(ValueError, match="CUDA"):
        tu.gather_kb_cuda(Fe, x, N_GRID, 7, 2.0)
    for m in (0, 9):
        with pytest.raises(ValueError, match=f"m = {m}"):
            tu.gather_kb_cuda(Fe, x, N_GRID, m, 2.0)
        with pytest.raises(ValueError, match=f"m = {m}"):
            tu.kb_plan(x, N_GRID, m, 2.0)
    assert tu.LAUNCHES == {"usfft_gather_kb": 0, "usfft_scatter_kb": 0}


def test_touched_cells_and_bounds():
    # Every tap of 2 points apart: 2 x 8 cells at m = 1.
    x = torch.tensor([[0.01, 0.01, 0.01], [-0.3, 0.2, 0.4]])
    assert tu.touched_cells(x, 16, 1) == 16
    assert tu.touched_cells(x[:1], 16, 2) == 64
    # A point whose taps wrap still touches 8 distinct cells.
    assert tu.touched_cells(torch.tensor([[0.499, -0.5, 0.7]]), 16, 1) == 8
    assert tu.roofline_bytes("usfft_gather_kb", 2, 16, 16) == 16 * 8 + 2 * 20
    assert tu.roofline_bytes("usfft_scatter_kb", 2, 16) == 16**3 * 8 + 2 * 20


def test_bench_bounds():
    """At bench_all.py's 128^3 / 64 angles (upsample 1, m = 1): the tilted
    planes' taps touch 1,258,980 of the 2,097,152 grid values (axis 0 spans
    only |kv sin(tilt)| <= 0.433), so the gather's bound is 31.0 MB; the
    scatter writes the whole grid, 37.7 MB."""
    x = cases.lamino_rows(cases.LAMINO_N, cases.LAMINO_NTHETA).reshape(-1, 3)
    assert x.shape[0] == 1_048_576
    gather = cases.roofline("usfft_gather_kb", x, 128, 1)
    assert gather["touched_cells"] == 1_258_980
    assert gather["bound_bytes"] == 1_258_980 * 8 + 1_048_576 * 20 == 31_043_360
    scatter = cases.roofline("usfft_scatter_kb", x, 128, 1)
    assert scatter["bound_bytes"] == 128**3 * 8 + 1_048_576 * 20 == 37_748_736
    for bound in (gather, scatter):
        assert bound["bound_by"] == "bytes"
        assert bound["bound_ms"] == 1e3 * bound["bound_bytes"] / cases.HBM_BYTES_PER_S


def test_kernel_sweep_variants_apply_to_the_source():
    """Every variant of the development sweep still finds the text it
    replaces in ``csrc/usfft.cu``, and a substitution that finds nothing
    raises instead of timing the unchanged source."""
    from tike_tpu_torch import kernel_sweep

    with open(kernel_sweep.SOURCE) as f:
        source = f.read()
    for name, substitutions in kernel_sweep.VARIANTS.items():
        changed = kernel_sweep.variant_source(source, substitutions)
        assert (changed != source) == bool(substitutions), name
    with pytest.raises(ValueError, match="not in the source"):
        kernel_sweep.variant_source(source, [("no such text", "")])
