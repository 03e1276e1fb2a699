"""The port's Bucket laminography operator and solver against tike_tpu's, on
the CPU.

The same numpy inputs go through ``tike_tpu.ops.bucket`` /
``tike_tpu.lamino.bucket`` and the port's plain PyTorch versions.

Cells: the port computes each point's cell in tike_tpu's order of float32
operations, each rounded on its own, from a table of float64 trigonometry
rounded to float32; at the test sizes every point lands in the cell of
tike_tpu's ``_plane_flat_indices`` (counted, zero). tike_tpu's jitted
operator differs from that function at exact ties: XLA on the CPU contracts
``p0 nx + p1 ny + p2 nz`` into FMAs inside the program, so at angles such
as pi/4, where points lie exactly on a cell edge, some land one cell over
(256 of 32,768 points at n = 16, 8 angles; ROADMAP.md section 3). The
operator and solver tests therefore use angles moved off the ties by
0.1 rad, where the two agree to the bit, and hold them at 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tike_tpu.lamino.bucket as jlb
import tike_tpu.ops.bucket as jb

import tike_tpu_torch.lamino as tl
import tike_tpu_torch.lamino.bucket as tlb
from tike_tpu_torch import convert
from tike_tpu_torch.ops import bucket as tb

from . import _torch_bucket_cases as cases
from ._torch_parity import assert_close, crandn, rng

TOL = 1e-5
TILT = np.pi / 3
# (n, angles, precision): n = 12-16 at precisions 1, 2 and 4, whose
# sub-voxel offsets are exact in float32.
OPERATOR_CASES = [(16, 8, 1), (16, 8, 2), (12, 5, 4)]


def _theta(ntheta, shift=0.1):
    return cases.theta(ntheta, shift).numpy()


def _configs(n, precision, tilt=TILT):
    return jb.BucketConfig(n=n, tilt=tilt, precision=precision), tb.BucketConfig(
        n=n, tilt=tilt, precision=precision
    )


@pytest.mark.parametrize("n, ntheta, precision, shift", [
    (16, 8, 1, 0.0), (16, 8, 2, 0.0), (16, 8, 3, 0.0), (13, 5, 4, 0.0), (16, 8, 4, 0.1),
])
def test_cells_match_jax(n, ntheta, precision, shift):
    """Every point's cell equals that of tike_tpu's ``_plane_flat_indices``
    (counted: zero), ties at pi/4 included; where tike_tpu's jitted program
    picks another cell, the point lies on a cell edge to float32 rounding."""
    jcfg, tcfg = _configs(n, precision)
    th = _theta(ntheta, shift)
    grid = jb.make_grid(n)
    trig = tb.bucket_trig(tcfg, th)
    jitted = jax.jit(jb._plane_flat_indices, static_argnums=0)
    differ, off_edge = 0, 0
    for t in range(ntheta):
        for off in jb._subsample_offsets(precision):
            args = (jcfg, jnp.asarray(grid), jnp.asarray(off), jnp.float32(th[t]))
            want = np.asarray(jb._plane_flat_indices(*args))
            got = tb.plane_flat_indices(tcfg, torch.as_tensor(grid), torch.as_tensor(off), trig[t])
            differ += int(np.sum(got.numpy() != want))
            moved = got.numpy() != np.asarray(jitted(*args))
            if moved.any():
                # The in-plane coordinates of the moved points, in float64.
                p = grid[moved].astype(np.float64) + off
                r = trig[t].double().numpy()
                d = p @ r[:3]
                q = p - d[:, None] * r[:3]
                y = r[3] * q[:, 0] + r[4] * q[:, 1] + r[5] * q[:, 2]
                z = r[6] * q[:, 1] + r[7] * q[:, 2]
                edge = np.minimum(np.abs(y - np.round(y)), np.abs(z - np.round(z)))
                off_edge += int(np.sum(edge > 1e-5))
    assert differ == 0
    assert off_edge == 0


@pytest.mark.parametrize("n, size, precision", [(16, 2, 3), (16, 4, 2), (13, 3, 4), (64, 3, 3)])
def test_slab_cells_match_jax(n, size, precision):
    """``test_cells_match_jax`` on the x-slabs of a mesh's shards
    (``slab_of``, ``make_grid(n, size, rank)``): the plain version on a slab
    takes exactly the slab's voxels, every point's cell is tike_tpu's, and
    with the tiles counted from the slab's first row every point stays in
    its tile's window and box (the kernels' placement, mirrored on the CPU;
    at 64^3 the windows alone, on slabs of 22, 21 and 21 rows whose tiles
    lie off the lattice's)."""
    jcfg, tcfg = _configs(n, precision)
    ntheta = 5
    th = _theta(ntheta, 0.0)
    trig = tb.bucket_trig(tcfg, th)
    for rank in range(size):
        x0, rows = tb.slab_of(n, size, rank)
        grid = jb.make_grid(n, size, rank)
        np.testing.assert_array_equal(
            tb._grid_tensor(tcfg, None, "cpu", (x0, rows)).numpy(), grid
        )
        if n < 64:
            for t in range(ntheta):
                for off in jb._subsample_offsets(precision):
                    want = np.asarray(jb._plane_flat_indices(
                        jcfg, jnp.asarray(grid), jnp.asarray(off), jnp.float32(th[t])))
                    got = tb.plane_flat_indices(
                        tcfg, torch.as_tensor(grid), torch.as_tensor(off), trig[t])
                    np.testing.assert_array_equal(got.numpy(), want)
        th_t = torch.as_tensor(th)
        assert cases.points_outside_windows(tcfg, th_t, (x0, rows))[0] == 0
        if 3 <= precision <= 5:
            assert cases.points_outside_boxes(tcfg, th_t, (x0, rows)) == 0


def test_trig_table_is_rounded_float64():
    tcfg = tb.BucketConfig(n=8, tilt=TILT)
    th = _theta(7)
    table = tb.bucket_trig(tcfg, torch.as_tensor(th)).numpy()
    assert table.shape == (7, tb.TABLE_WIDTH) and table.dtype == np.float32
    tilt = np.float64(np.float32(TILT))
    ct, st = np.float32(np.cos(tilt)), np.float32(np.sin(tilt))
    cq, sq = np.cos(th.astype(np.float64)).astype(np.float32), np.sin(th.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(table[:, 0], ct)
    np.testing.assert_array_equal(table[:, 1], -(cq * st))
    np.testing.assert_array_equal(table[:, 4], cq * ct)
    np.testing.assert_array_equal(table[:, 6], -sq)
    np.testing.assert_array_equal(table[:, 7], cq)


def test_config_grid_and_offsets_match_jax():
    for eps in (1.0, 0.2, 1e-1, 1e-2):
        j, t = jb.BucketConfig.from_eps(16, TILT, eps), tb.BucketConfig.from_eps(16, TILT, eps)
        assert (t.n, t.tilt, t.precision) == (j.n, j.tilt, j.precision)
        assert convert.bucket_config_from_jax(j) == t
    for n in (5, 8):
        np.testing.assert_array_equal(tb.make_grid(n), jb.make_grid(n))
        np.testing.assert_array_equal(tb.make_grid(n, 3, 1), jb.make_grid(n, 3, 1))
        np.testing.assert_array_equal(tb.make_grid_full(n), jb.make_grid_full(n))
    for p in (1, 3, 4):
        np.testing.assert_array_equal(tb._subsample_offsets(p), jb._subsample_offsets(p))


@pytest.mark.parametrize("n, ntheta, precision", OPERATOR_CASES)
def test_fwd_and_adj_match_jax(n, ntheta, precision):
    jcfg, tcfg = _configs(n, precision)
    gen = rng(n + precision)
    u, d = crandn(gen, n, n, n), crandn(gen, ntheta, n, n)
    th, grid = _theta(ntheta), jb.make_grid(n)
    want_f = jb.bucket_fwd(jcfg, jnp.asarray(u), jnp.asarray(th), jnp.asarray(grid))
    want_a = jb.bucket_adj(jcfg, jnp.asarray(d), jnp.asarray(th), jnp.asarray(grid))
    got_f = tb.bucket_fwd(tcfg, torch.as_tensor(u), torch.as_tensor(th))
    got_a = tb.bucket_adj(tcfg, torch.as_tensor(d), torch.as_tensor(th))
    assert got_f.shape == (ntheta, n, n) and got_a.shape == (n**3,)
    assert_close(got_f, want_f, rtol=TOL, atol=TOL, scale=True)
    assert_close(got_a, want_a, rtol=TOL, atol=TOL, scale=True)
    # The same with the grid given, and on a chunk of x-slabs.
    assert torch.equal(tb.bucket_fwd(tcfg, torch.as_tensor(u), torch.as_tensor(th), grid), got_f)
    chunk = jb.make_grid(n, 2, 1)
    uc = u.reshape(-1)[-chunk.shape[0]:]
    assert_close(
        tb.bucket_fwd(tcfg, torch.as_tensor(uc), torch.as_tensor(th), chunk),
        jb.bucket_fwd(jcfg, jnp.asarray(uc), jnp.asarray(th), jnp.asarray(chunk)),
        rtol=TOL, atol=TOL, scale=True,
    )
    assert_close(
        tb.bucket_adj(tcfg, torch.as_tensor(d), torch.as_tensor(th), torch.as_tensor(chunk)),
        jb.bucket_adj(jcfg, jnp.asarray(d), jnp.asarray(th), jnp.asarray(chunk)),
        rtol=TOL, atol=TOL, scale=True,
    )


@pytest.mark.parametrize("precision", [1, 3])
def test_adjointness(precision):
    _, tcfg = _configs(15, precision)
    th = cases.theta(6, 0.0)
    u, d = cases.volume(15), cases.planes(6, 15)
    lhs = cases.inner64(tb.bucket_fwd(tcfg, u, th), d)
    rhs = cases.inner64(u.reshape(-1), tb.bucket_adj(tcfg, d, th))
    assert abs(lhs - rhs) / abs(lhs) < cases.ADJOINT_TOL


def test_cost_grad_and_step_scale_match_jax():
    n, ntheta = 16, 8
    jcfg, tcfg = _configs(n, 2)
    gen = rng(3)
    u, d = crandn(gen, n, n, n), crandn(gen, ntheta, n, n)
    th, grid = _theta(ntheta), jb.make_grid(n)
    fd = jb.bucket_fwd(jcfg, jnp.asarray(u), jnp.asarray(th), jnp.asarray(grid))
    tfd = tb.bucket_fwd(tcfg, torch.as_tensor(u), torch.as_tensor(th))
    assert float(tb.bucket_cost(torch.as_tensor(d), tfd)) == pytest.approx(
        float(jb.bucket_cost(jnp.asarray(d), fd)), rel=TOL
    )
    assert_close(
        tb.bucket_grad(tcfg, torch.as_tensor(d), torch.as_tensor(th), tfd),
        jb.bucket_grad(jcfg, jnp.asarray(d), jnp.asarray(th), fd, jnp.asarray(grid)),
        rtol=TOL, atol=TOL, scale=True,
    )
    want = float(jb.bucket_step_scale(jcfg, u, th, grid))
    got = float(tb.bucket_step_scale(tcfg, torch.as_tensor(u), torch.as_tensor(th)))
    assert got == pytest.approx(want, rel=TOL)
    # A zero volume scales to 0 (the solver then takes a step of 1).
    zero = torch.zeros((n, n, n), dtype=torch.complex64)
    assert float(tb.bucket_step_scale(tcfg, zero, torch.as_tensor(th))) == 0.0


def _smooth_volume(n):
    x = np.mgrid[0:n, 0:n, 0:n] - n / 2
    return (np.exp(-(x**2).sum(0) / (n / 3) ** 2) * (1 + 0.3j * np.sin(x[0]))).astype(
        np.complex64
    )


@pytest.mark.parametrize("eps", [1.0, 1 / 8])
def test_simulate_matches_jax(eps):
    th = _theta(8)
    vol = _smooth_volume(16)
    want = jlb.simulate(vol, th, TILT, eps=eps)
    got = tlb.simulate(vol, th, TILT, eps=eps, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.complex64
    assert_close(got, want, rtol=TOL, atol=TOL, scale=True)
    as_tensor = tlb.simulate(torch.as_tensor(vol), th, TILT, eps=eps, device="cpu")
    assert isinstance(as_tensor, torch.Tensor)
    np.testing.assert_array_equal(as_tensor.numpy(), got)


@pytest.mark.parametrize("eps", [1.0, 1 / 8])
def test_reconstruct_matches_jax(eps):
    """3 outer iterations at cg_iter 1, whose line-search trials are not
    ties: costs, volume and step at 1e-5."""
    th = _theta(8)
    data = jlb.simulate(_smooth_volume(16), th, TILT, eps=eps)
    kwargs = dict(num_iter=3, eps=eps, cg_iter=1)
    want = jlb.reconstruct(data, th, TILT, **kwargs)
    got = tlb.reconstruct(data, th, TILT, device="cpu", **kwargs)
    assert len(got["cost"]) == 3 and np.all(np.diff(got["cost"]) < 0)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=TOL)
    assert got["obj"].dtype == np.complex64
    assert_close(got["obj"], want["obj"], rtol=TOL, atol=TOL, scale=True)
    assert got["step_length"] == pytest.approx(want["step_length"], rel=TOL)


def test_reconstruct_at_cg_iter_4_decreases():
    """At cg_iter 4 the line search decides trials on cost ties that the
    last bits break (ROADMAP.md section 3), so only the port's own costs
    are held: finite and decreasing. Tensors in give tensors out."""
    th = _theta(8)
    data = tlb.simulate(_smooth_volume(16), th, TILT, eps=1.0, device="cpu")
    got = tlb.reconstruct(torch.as_tensor(data), th, TILT, num_iter=3, eps=1.0,
                          cg_iter=4, device="cpu")
    assert isinstance(got["obj"], torch.Tensor) and got["obj"].shape == (16, 16, 16)
    assert np.all(np.isfinite(got["cost"])) and np.all(np.diff(got["cost"]) < 0)


def test_reconstruct_refuses_what_is_not_ported():
    data = np.zeros((4, 8, 8), np.complex64)
    th = _theta(4)
    # Volume parallelism runs (tests/test_torch_mesh_lamino.py); what it
    # cannot split raises, as in tike_tpu.
    with pytest.raises(ValueError, match="whole x-slab"):
        tlb.reconstruct(data, th, TILT, obj_split=3, device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        tlb.reconstruct(data, th, TILT, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="not an available"):
        tlb.reconstruct(data, th, TILT, algorithm="sirt", device="cpu")
    with pytest.raises(ValueError, match="tike_tpu_torch.lamino.bucket.reconstruct"):
        tl.reconstruct(data, th, TILT, "bucket", device="cpu")


def test_kernels_take_only_cuda_tensors():
    tcfg = tb.BucketConfig(n=4, tilt=TILT)
    th = torch.as_tensor(_theta(2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tb.bucket_fwd_cuda(tcfg, torch.zeros(64, dtype=torch.complex64), th)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tb.bucket_adj_cuda(tcfg, torch.zeros((2, 4, 4), dtype=torch.complex64), th)


def test_roofline_at_full_width():
    """bench_all.py's geometry at the solver's default eps: 3.6e9 points a
    projection, bound by the operations rather than the 25 MB of volume and
    planes, counted pipe by pipe: 15 rounded float32 operations a point in
    the forward, 19 in the adjoint, on the FP32 pipe (33.5e12 a second, an
    FMA never counted twice), and two floors a point on the conversion pipe
    (16 a clock an SM) or as FP32 adds; the first count (24 a point at 67
    TFLOP/s) beside it."""
    c = cases.FULL
    cfg = tb.BucketConfig.from_eps(c["n"], c["tilt"], c["eps"])
    assert cfg.precision == 3
    fwd = tb.roofline(cfg, c["n"] ** 3, c["ntheta"], "bucket_fwd")
    adj = tb.roofline(cfg, c["n"] ** 3, c["ntheta"], "bucket_adj")
    points = 128**3 * 64 * 27
    for r in (fwd, adj):
        assert r["points"] == points == 3_623_878_656
        assert r["bound_bytes"] == 8 * 128**3 + 8 * 64 * 128**2 + 4 * tb.TABLE_WIDTH * 64
        assert r["bound_by"] == "operations"
        assert r["bound_floors_ms"] == pytest.approx(1e3 * 2 * points / (132 * 16 * 1.98e9))
        assert r["bound_ms_first_count"] == pytest.approx(1e3 * 24 * points / 67e12)
    assert fwd["bound_fp32_ms"] == pytest.approx(1e3 * 15 * points / (132 * 128 * 1.98e9))
    assert adj["bound_fp32_ms"] == pytest.approx(1e3 * 19 * points / (132 * 128 * 1.98e9))
    # The forward's floors do not all fit beside its FP32 work on the
    # conversion pipe; the adjoint's do.
    assert fwd["bound_ms"] == pytest.approx(1e3 * 17 * points / (132 * 144 * 1.98e9))
    assert adj["bound_ms"] == adj["bound_fp32_ms"]
    assert 1.6 < fwd["bound_ms"] < 1.7 and 2.0 < adj["bound_ms"] < 2.1


@pytest.mark.parametrize("precision", [1, 2, 3, 4, 5, 10])
def test_offset_table_matches_jax(precision):
    """The kernels' offsets are tike_tpu's _subsample_offsets along one axis,
    bit for bit."""
    want = jb._subsample_offsets(precision)
    got = tb.bucket_offsets(precision)
    assert got.dtype == np.float32 and got.shape == (precision,)
    np.testing.assert_array_equal(want[:precision, 2], got)
    np.testing.assert_array_equal(want[:: precision**2, 0], got)


@pytest.mark.parametrize("n, precision", [(16, 1), (16, 2), (16, 4), (32, 1), (32, 2), (32, 4)])
def test_every_point_lies_in_its_window(n, precision):
    """Every point of every tile of the lattice lies in the window that the
    host's per-angle extents give, placed from the tile's corner as the
    kernels place it (16 angles over [0, pi), the ties at pi/4 included); at
    n = 16 and 32, tilt pi/3, some points' cells wrap."""
    cfg = tb.BucketConfig(n=n, tilt=TILT, precision=precision)
    outside, wrapped = cases.points_outside_windows(cfg, cases.theta(16, 0.0))
    assert outside == 0
    assert wrapped > 0
    table = tb.bucket_trig(cfg, cases.theta(16, 0.0))
    rows, cols = tb.window_limits(cfg)
    assert int(table[:, 10].max()) <= rows and int(table[:, 11].max()) <= cols


@pytest.mark.parametrize("n, precision", [(16, 3), (16, 5), (32, 4)])
def test_every_point_lies_in_its_voxels_box(n, precision):
    """At precisions 3-5 the forward counts each voxel's points in a 3 x 3
    box of cells from the floor of the voxel's lowest y and z: every point
    lies in its box, and every box in its window and the 2 rows and columns
    past it that the window buffers hold."""
    cfg = tb.BucketConfig(n=n, tilt=TILT, precision=precision)
    assert cases.points_outside_boxes(cfg, cases.theta(16, 0.0)) == 0


def test_every_point_lies_in_its_window_at_the_golden_geometry():
    """The same at two angles of the reference's golden geometry (64^3,
    precision 1, lamino_setup's tilt and angles)."""
    _, _, theta, tilt = cases.load_golden("lamino_setup.pickle.lzma")
    cfg = tb.BucketConfig.from_eps(64, float(tilt), 1.0)
    th = torch.as_tensor(np.asarray(theta, np.float32)[[7, 40]])
    assert cases.points_outside_windows(cfg, th)[0] == 0


@pytest.mark.parametrize("n, precision, ntheta, shift", [(9, 3, 5, 0.2), (10, 5, 4, 0.0)])
def test_window_cells_wrap_by_floor_mod(n, precision, ntheta, shift):
    """The windows of the lattice's cut edge tiles (n not a multiple of the
    tile) reach rows or columns outside [-n, 2n) before the wrap, so one
    compare-and-add would leave the planes: the kernels wrap each window
    cell, and each point of a caller's grid, by a floor-mod."""
    from tike_tpu_torch import kernels

    cfg = tb.BucketConfig(n=n, tilt=TILT, precision=precision)
    table = tb.bucket_trig(cfg, cases.theta(ntheta, shift))
    tiles = -(-n // tb.TILE)
    a = torch.arange(tiles)
    corner = torch.stack(torch.meshgrid(a, a, a, indexing="ij"), -1).reshape(-1, 3)
    corner = (corner * tb.TILE - (n + 1) // 2).to(torch.float32)
    low, high = [], []
    for row in table:
        y0, z0 = cases.window_origins(corner, row)
        for first, extent in ((y0, row[10]), (z0, row[11])):
            low.append(int(first.min()) + n // 2)
            high.append(int(first.max()) + n // 2 + int(extent) + 1)  # the forward's + 2
    assert min(low) < -n or max(high) >= 2 * n
    source = (kernels.CSRC / "bucket.cu").read_text()
    for fn in ("long long plane_cell(", "long long cell("):
        body = source[source.index(f"__device__ __forceinline__ {fn}"):]
        body = body[: body.index("\n}\n")]
        assert body.count("floor_mod(") == 2


@pytest.mark.parametrize("n, precision", [(4, 3), (5, 2)])
def test_sequential_reference_matches_plain(n, precision):
    """The numpy reference that the card's test of the largest precisions
    holds the kernels to: its adjoint equals the plain version bit for bit,
    and the plain forward lies within its rounding bound."""
    cfg = tb.BucketConfig(n=n, tilt=TILT, precision=precision)
    th = cases.theta(3, 0.1)
    trig = tb.bucket_trig(cfg, th)
    u, d = cases.volume(n), cases.planes(3, n)
    adj, exact, bound = cases.sequential_reference(cfg, u, d, trig)
    np.testing.assert_array_equal(tb.bucket_adj_plain(cfg, d, th, trig=trig).numpy(), adj)
    fwd = tb.bucket_fwd_plain(cfg, u, th, trig=trig).numpy().reshape(3, -1)
    for part, b in zip((np.real, np.imag), bound):
        assert np.all(np.abs(part(fwd) - part(exact)) <= b)
    assert np.any(bound > 0)


def test_bucket_sweep_variants_apply_to_the_source():
    """Every default variant of ``kernel_sweep --source bucket`` finds the
    constant it sets in ``csrc/bucket.cu`` and changes the source, and the
    first form, which chip_smoke.py times beside the kernels, keeps its own
    entry points."""
    from tike_tpu_torch import kernel_sweep, kernels

    with open(kernel_sweep.BUCKET_SOURCE) as f:
        source = f.read()
    variants = kernel_sweep.bucket_variants(source)
    sources = [kernel_sweep.variant_source(source, subs) for subs in variants.values()]
    assert sources[0] == source and len(set(sources)) == len(variants) == 14
    first = (kernels.CSRC / "bucket_first_form.cu").read_text()
    for name in kernels.SIGNATURES["bucket_first_form"]:
        assert f'extern "C" int {name}(' in first


def test_kernel_source_matches_the_wrappers_constants():
    """The tile, the table's width and the count of offsets in the
    kernels' parameters that the wrappers use are the kernel's own."""
    from tike_tpu_torch import kernels

    source = (kernels.CSRC / "bucket.cu").read_text()
    assert f"constexpr int kTile = {tb.TILE};" in source
    assert f"constexpr int kTableWidth = {tb.TABLE_WIDTH};" in source
    assert f"constexpr int kParamOffsets = {tb.PARAM_OFFSETS};" in source


def test_outside_count_reads_cuda_as_the_current_card(monkeypatch):
    """The count is filed under the card with its index, so ``cuda`` reads
    (and resets) the current card's count and not an empty entry. A CPU
    tensor stands in for the card's slot."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    slot = torch.tensor([3], dtype=torch.int64)
    monkeypatch.setitem(tb.OUTSIDE._tensors, torch.device("cuda", 0), slot)
    assert tb.OUTSIDE.tensor("cuda") is slot
    assert tb.outside_windows("cuda") == tb.outside_windows("cuda:0") == 3
    tb.reset_outside_windows("cuda")
    assert tb.outside_windows("cuda:0") == 0


def test_kernel_source_rounds_each_operation():
    """The kernels round each multiply and add on its own (nvcc would fuse
    them into FMAs, which moves points across cell edges) and the entry
    points are the ones kernels.SIGNATURES binds."""
    from tike_tpu_torch import kernels

    source = (kernels.CSRC / "bucket.cu").read_text()
    for name in kernels.SIGNATURES["bucket"]:
        assert f'extern "C" int {name}(' in source
    body = source[source.index("__device__ __forceinline__ long long cell("):]
    body = body[: body.index("\n}\n")]
    assert "__fmul_rn" in body and "__fadd_rn" in body and "fmaf" not in body
    assert " * " not in body.split("const int half")[0]
