"""The Bucket kernels' checks, inputs and golden protocol.

``chip_smoke.py`` holds the CUDA kernels of ``tike_tpu_torch/csrc/bucket.cu``
to their plain PyTorch versions with these, and
``tests/test_torch_bucket_cuda.py`` does the same on the card;
``tests/test_torch_bucket.py`` holds the plain versions to ``tike_tpu`` on the
CPU. Nothing here imports JAX.
"""

from __future__ import annotations

import lzma
import os
import pickle

import numpy as np
import torch

import tike_tpu_torch.lamino.bucket as tlb
from tike_tpu_torch.ops import bucket

# The forward kernel against its plain version: the same cells (checked
# exactly by cell_mismatches), each cell's k weighted points added by float2
# atomics in an order that varies from launch to launch, the plain version's
# index_add_ in its own. Each order's float32 sum lies within (k - 1) u S of
# the exact one (u = 2^-24, S the cell's sum of |terms|, each part on its
# own), so the two within FWD_ROUNDING k u S of each other. A relative
# tolerance does not hold at full width: a cell there sums thousands of
# terms that largely cancel (1.29e-5 of the largest value at 128^3, 64
# angles, precision 3, NVIDIA H100 80GB HBM3).
FWD_ROUNDING = 2.0
UNIT_ROUNDOFF = 2.0**-24
# The adjoint kernel against its plain version: the same cells and the same
# float32 operations in the same order (angles outer, offsets inner, each
# product and sum rounded on its own), so bit for bit; relative, like the
# forward's.
ADJ_TOL = 0.0
# <fwd(u), d> against <u, adj(d)>, relative, summed in float64.
ADJOINT_TOL = 1e-5
# The reference's golden protocol (tests/test_parity_golden.py): 1 + 30 outer
# iterations at eps=1 on lamino_setup, against lamino_bucket at this atol.
GOLDEN_ATOL = 1e-3
GOLDEN_ITERS = (1, 30)

# bench_all.py's laminography geometry (lamino_cgrad, lamino_cgls): a 128^3
# volume, 64 angles over [0, pi), tilt pi/3; the Bucket solver's default eps
# of 1e-1 (precision 3) and cg_iter 4.
FULL = dict(n=128, ntheta=64, tilt=np.pi / 3, eps=1e-1, cg_iter=4)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def theta(ntheta: int, shift: float = 0.0, device=None) -> torch.Tensor:
    """``ntheta`` float32 angles over [0, pi), moved by ``shift`` rad."""
    t = np.linspace(0, np.pi, ntheta, endpoint=False) + shift
    return torch.as_tensor(t.astype(np.float32), device=device)


def volume(n: int, seed: int = 0, device=None) -> torch.Tensor:
    """A Gaussian-windowed random complex64 n^3 volume (as bench_all.py's
    laminography volume)."""
    gen = np.random.default_rng(seed)
    x = (gen.standard_normal((n, n, n)) + 1j * gen.standard_normal((n, n, n))) * np.exp(
        -((np.mgrid[0:n, 0:n, 0:n] - n / 2) ** 2).sum(0) / (n / 3) ** 2
    )
    return torch.as_tensor(x.astype(np.complex64), device=device)


def planes(ntheta: int, n: int, seed: int = 1, device=None) -> torch.Tensor:
    gen = np.random.default_rng(seed)
    x = gen.standard_normal((ntheta, n, n)) + 1j * gen.standard_normal((ntheta, n, n))
    return torch.as_tensor(x.astype(np.complex64), device=device)


def max_rel(a, b) -> float:
    scale = float(torch.max(torch.abs(b))) if b.numel() else 0.0
    return float(torch.max(torch.abs(a - b))) / scale if scale else 0.0


def inner64(a, b) -> complex:
    """<a, b> = sum(conj(a) b), in complex128."""
    return complex(torch.sum(torch.conj(a.to(torch.complex128)) * b.to(torch.complex128)))


def fwd_rounding_ratio(cfg: bucket.BucketConfig, got, want, u, th, grid=None, trig=None,
                       slab=None) -> float:
    """The largest |got - want| of the forward (each of the real and the
    imaginary part) over its rounding bound FWD_ROUNDING k u S, cell by
    cell: k the cell's points and S its sum of |terms|, both from the plain
    version (on a volume of ones, and of |Re u| + i |Im u|). At most 1 when
    the two differ only by the order of their float32 sums. ``u`` holds the
    voxels of ``grid``, or of the lattice's ``slab``."""
    counts = bucket.bucket_fwd_plain(cfg, torch.ones_like(u), th, grid, trig, slab).real
    k = torch.round(counts / bucket._weight(cfg))
    v = u.reshape(-1)
    s = bucket.bucket_fwd_plain(cfg, torch.complex(v.real.abs(), v.imag.abs()), th, grid, trig,
                                slab)
    ratio = 0.0
    for part in (torch.real, torch.imag):
        bound = FWD_ROUNDING * k * UNIT_ROUNDOFF * part(s)
        diff = torch.abs(part(got) - part(want))
        if bool(torch.any((diff > 0) & (bound == 0))):
            return float("inf")
        ratio = max(ratio, float(torch.max(torch.where(diff > 0, diff / bound, 0.0))))
    return ratio


def sequential_reference(cfg: bucket.BucketConfig, u, d, trig) -> tuple:
    """Both operators on the lattice in numpy from the plain version's cells
    (all points of an angle at once, on the CPU), for any precision: the
    adjoint ((G,) complex64) in the plain version's order of float32 sums
    (angles outer, offsets inner, by the sequential np.add.accumulate); the
    forward's exact sum of each cell ((T, n^2) complex128) and the rounding
    bound FWD_ROUNDING k u S of its real and imaginary parts."""
    n, ntheta = cfg.n, trig.shape[0]
    grid = torch.as_tensor(bucket.make_grid(n))
    offsets = torch.as_tensor(bucket._subsample_offsets(cfg.precision))
    cells = np.stack([
        bucket.plane_flat_indices(cfg, grid[:, None, :], offsets[None], trig[t].cpu()).numpy()
        for t in range(ntheta)
    ])  # (angle, voxel, point)
    w = np.float32(bucket._weight(cfg))
    values = d.cpu().numpy().reshape(ntheta, -1)[np.arange(ntheta)[:, None, None], cells]
    adj = [
        np.add.accumulate((part(values) * w).transpose(1, 0, 2).reshape(n**3, -1), axis=1,
                          dtype=np.float32)[:, -1]
        for part in (np.real, np.imag)
    ]
    terms = u.cpu().numpy().reshape(-1) * w
    exact = np.zeros((ntheta, n * n), np.complex128)
    count = np.zeros((ntheta, n * n))
    size = np.zeros((2, ntheta, n * n))
    for t in range(ntheta):
        np.add.at(exact[t], cells[t], terms[:, None].astype(np.complex128))
        np.add.at(count[t], cells[t], 1.0)
        for s, part in zip(size, (np.real, np.imag)):
            np.add.at(s[t], cells[t], np.abs(part(terms)).astype(np.float64)[:, None])
    bound = FWD_ROUNDING * count * UNIT_ROUNDOFF * size
    return (adj[0] + 1j * adj[1]).astype(np.complex64), exact, bound


def cell_mismatches(cfg: bucket.BucketConfig, th, grid=None) -> int:
    """Voxels whose cells differ between the adjoint kernel and the plain
    version, angle by angle: each angle's plane holds its own flat cell
    index, so the adjoint of one angle gives each voxel the sum of its
    points' indices (times the weight), in the same order on both sides.
    Any difference is a point in another cell."""
    n = cfg.n
    index = torch.arange(n * n, dtype=torch.float32, device=th.device)
    plane = torch.complex(index, torch.zeros_like(index)).reshape(1, n, n)
    trig = bucket.bucket_trig(cfg, th)
    bad = 0
    for t in range(th.shape[0]):
        got = bucket.bucket_adj_cuda(cfg, plane, th[t : t + 1], grid, trig[t : t + 1])
        want = bucket.bucket_adj_plain(cfg, plane, th[t : t + 1], grid, trig[t : t + 1])
        bad += int(torch.sum(got != want))
    return bad


def tile_corners(cfg: bucket.BucketConfig, grid: torch.Tensor, x0: int = 0) -> torch.Tensor:
    """The lowest corner (float32) of the lattice tile of bucket.TILE^3 voxels
    that holds each voxel of ``grid`` ((G, 3) int32 coordinates), the tiles
    of axis 0 counted from row ``x0`` (a slab's first row, as the kernels
    count them)."""
    lo = -(cfg.n // 2) - cfg.n % 2
    lo = torch.tensor([lo + x0, lo, lo])
    return (lo + torch.div(grid - lo, bucket.TILE, rounding_mode="floor") * bucket.TILE).to(
        torch.float32
    )


def _slab_grid(cfg: bucket.BucketConfig, slab) -> tuple:
    """The voxels of ``slab`` ((x0, rows), None: the lattice) and x0."""
    x0, rows = (0, cfg.n) if slab is None else slab
    return torch.as_tensor(bucket.make_grid_full(cfg.n)[x0 : x0 + rows].reshape(-1, 3)), x0


def window_origins(corner: torch.Tensor, row: torch.Tensor):
    """The first row and column (y0, z0) of the window of tiles with lowest
    corners ``corner`` ((G, 3) float32) for the angle of ``row`` (one row of
    bucket_trig): csrc/bucket.cu's window_of, in its float32 operations."""
    c0, c1, c2 = corner.unbind(-1)
    by = ((row[3] * c0 + row[4] * c1) + row[5] * c2) + row[8]
    bz = (row[6] * c1 + row[7] * c2) + row[9]
    return torch.floor(by).to(torch.int64), torch.floor(bz).to(torch.int64)


def points_outside_windows(cfg: bucket.BucketConfig, th, slab=None) -> tuple:
    """(points outside their tile's window, points whose cell wraps) over
    the whole lattice, or its ``slab`` (x0, rows), at the angles ``th`` (on
    the CPU): each point's floor(y) and floor(z) from the plain version's
    float32 operations, less its window's origin, against the window's rows
    and columns; what the lattice kernels' counter counts on the card."""
    grid, x0 = _slab_grid(cfg, slab)
    corner = tile_corners(cfg, grid, x0)
    table = bucket.bucket_trig(cfg, th.cpu())
    outside = wrapped = 0
    for row in table:
        y0, z0 = window_origins(corner, row)
        for off in torch.as_tensor(bucket._subsample_offsets(cfg.precision)):
            y, z = bucket.plane_coordinates(grid, off, row)
            fy, fz = torch.floor(y).to(torch.int64), torch.floor(z).to(torch.int64)
            wy, wz = fy - y0, fz - z0
            outside += int(torch.sum((wy < 0) | (wy >= row[10]) | (wz < 0) | (wz >= row[11])))
            iy, iz = fy + cfg.n // 2, fz + cfg.n // 2
            wrapped += int(torch.sum((iy < 0) | (iy >= cfg.n) | (iz < 0) | (iz >= cfg.n)))
    return outside, wrapped


def points_outside_boxes(cfg: bucket.BucketConfig, th, slab=None) -> int:
    """Points that leave their voxel's 3 x 3 box of cells, or whose box
    leaves its window and the 2 rows and columns past it, in the forward
    kernel's counting of precisions 3-5 (``csrc/bucket.cu``: the box from
    the floor of the voxel's lowest y and z less 1/32, here in float32
    without its FMAs, which the margin covers). Such a point still reaches
    its cell, one shared atomic for it alone. ``slab`` (x0, rows) takes a
    slab's tiles instead of the lattice's."""
    grid, x0 = _slab_grid(cfg, slab)
    g = grid.to(torch.float32)
    corner = tile_corners(cfg, grid, x0)
    table = bucket.bucket_trig(cfg, th.cpu())
    c = torch.as_tensor(bucket.bucket_offsets(cfg.precision))
    c0, cl = c[0], c[-1]

    def low(e):
        return sum(torch.minimum(x * c0, x * cl) for x in e) - 0.03125

    missed = 0
    for row in table:
        y0, z0 = window_origins(corner, row)
        st, cqct, sqct, nsq, cq = row[3:8]
        by = torch.floor(st * g[:, 0] + cqct * g[:, 1] + sqct * g[:, 2] + low((st, cqct, sqct)))
        bz = torch.floor(nsq * g[:, 1] + cq * g[:, 2] + low((nsq, cq)))
        by, bz = by.to(torch.int64), bz.to(torch.int64)
        missed += int(torch.sum((by < y0) | (by + 3 > y0 + row[10] + 2)
                                | (bz < z0) | (bz + 3 > z0 + row[11] + 2))) * cfg.precision**3
        for off in torch.as_tensor(bucket._subsample_offsets(cfg.precision)):
            y, z = bucket.plane_coordinates(grid, off, row)
            dy = torch.floor(y).to(torch.int64) - by
            dz = torch.floor(z).to(torch.int64) - bz
            missed += int(torch.sum((dy < 0) | (dy > 2) | (dz < 0) | (dz > 2)))
    return missed


def check_bucket_kernels(cfg: bucket.BucketConfig, u, d, th, grid=None, slab=None) -> dict:
    """Both kernels against their plain versions on the same inputs (u the
    volume, d the planes, th the angles, all on the card), and against
    adjointness; two adjoint launches bitwise equal; the forward of a
    volume of ones (each cell's count of points times the weight) equal to
    the plain version's where the weight is a power of two, so that every
    sum is exact; no point of the lattice kernels outside its window (the
    card's counter, set to 0 first, still 0). ``slab`` (x0, rows) checks the
    kernels on that slab of the lattice, ``u`` holding its voxels. Raises
    AssertionError; returns the errors."""
    bucket.reset_outside_windows(th.device)
    trig = bucket.bucket_trig(cfg, th)
    fwd = bucket.bucket_fwd_cuda(cfg, u, th, grid, trig, slab)
    adj = bucket.bucket_adj_cuda(cfg, d, th, grid, trig, slab)
    adj2 = bucket.bucket_adj_cuda(cfg, d, th, grid, trig, slab)
    fwd_plain = bucket.bucket_fwd_plain(cfg, u, th, grid, trig, slab)
    adj_plain = bucket.bucket_adj_plain(cfg, d, th, grid, trig, slab)
    torch.cuda.synchronize()
    out = {
        "fwd": max_rel(fwd, fwd_plain),
        "fwd_rounding": fwd_rounding_ratio(cfg, fwd, fwd_plain, u, th, grid, trig, slab),
        "fwd_abs": float(torch.max(torch.abs(fwd - fwd_plain))),
        "adj": max_rel(adj, adj_plain),
        "adj_abs": float(torch.max(torch.abs(adj - adj_plain))),
        "adj_bitwise": bool(torch.equal(adj, adj_plain)),
    }
    lhs, rhs = inner64(fwd, d), inner64(u.reshape(-1), adj)
    out["adjoint"] = abs(lhs - rhs) / max(abs(lhs), abs(rhs), 1e-30)
    what = f"bucket n={cfg.n} precision={cfg.precision} angles={th.shape[0]}" + (
        "" if slab is None else f" slab {tuple(slab)}"
    )
    if not out["fwd_rounding"] <= 1.0:
        raise AssertionError(
            f"{what}: bucket_fwd differs from plain by {out['fwd_rounding']:.3g} times the "
            f"rounding bound of its sums ({out['fwd']:.3e} of max|value|)"
        )
    if not out["adj"] <= ADJ_TOL:
        raise AssertionError(f"{what}: bucket_adj differs from plain by {out['adj']:.3e}")
    if not out["adjoint"] <= ADJOINT_TOL:
        raise AssertionError(f"{what}: adjointness {out['adjoint']:.3e}")
    if not torch.equal(adj, adj2):
        raise AssertionError(f"{what}: two bucket_adj launches differ")
    if cfg.precision in (1, 2, 4):
        ones = torch.ones_like(u)
        counts = bucket.bucket_fwd_cuda(cfg, ones, th, grid, trig, slab)
        if not torch.equal(counts, bucket.bucket_fwd_plain(cfg, ones, th, grid, trig, slab)):
            raise AssertionError(f"{what}: bucket_fwd's points per cell differ from plain")
    out["outside"] = bucket.outside_windows(th.device)
    if out["outside"]:
        raise AssertionError(f"{what}: {out['outside']} points fell outside their tile's window")
    return out


def load_golden(name: str):
    with lzma.open(os.path.join(DATA, name), "rb") as f:
        return pickle.load(f)


def golden_reconstruct(device, mesh=None):
    """The reference's golden protocol on ``device`` (and ``mesh``, if
    given): 1 outer iteration from zeros, then 30 more, at eps=1 (precision
    1) on lamino_setup. Returns (volume, the standard lamino_bucket,
    costs)."""
    data, original, th, tilt = load_golden("lamino_setup.pickle.lzma")
    standard = load_golden("lamino_bucket.pickle.lzma")
    first, more = GOLDEN_ITERS
    r = tlb.reconstruct(data, th, tilt, obj=np.zeros_like(original), num_iter=first,
                        eps=1, device=device, mesh=mesh)
    costs = list(r["cost"])
    r = tlb.reconstruct(data, th, tilt, obj=r["obj"], num_iter=more, eps=1,
                        device=device, mesh=mesh)
    return r["obj"], standard, np.asarray(costs + list(r["cost"]))
