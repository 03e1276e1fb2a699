"""Bucket laminography operator: direct voxel-to-plane projection.

Counterpart of :mod:`tike_tpu.ops.bucket` for one device. Each voxel is
sub-sampled into precision^3 points; each point is projected onto the
tilted and rotated detector plane of every angle and adds its value times
1/precision^3 to the plane cell it lands in (:func:`bucket_fwd`). The
adjoint gathers the plane values back to each voxel (:func:`bucket_adj`).

The voxel ``grid`` is an (G, 3) int32 array of origin-centred voxel
coordinates (:func:`make_grid`), with ``u.reshape(-1)[g]`` the value of
voxel ``grid[g]``; ``grid=None`` stands for the full n^3 lattice in
:func:`make_grid`'s order, which the kernels then compute from the voxel's
index instead of reading it.

Each operator has two implementations:

- a plain PyTorch version (``bucket_fwd_plain``, ``bucket_adj_plain``):
  for each (angle, offset) the cell of every voxel, then an ``index_add_``
  on a float-pair view of the plane or a gather from it;
- a hand-written CUDA kernel (``csrc/bucket.cu``: ``bucket_fwd_cuda``,
  ``bucket_adj_cuda``), which replaces the JAX package's XLA scatter and
  gather code.

``bucket_fwd`` and ``bucket_adj`` dispatch on the device of the tensors they
are given: CPU tensors take the plain version, CUDA tensors launch the
kernel or raise. Both read the same per-angle table (:func:`bucket_trig`)
and compute each point's cell in the JAX package's order of float32
operations, so the kernels, the plain versions and the JAX package pick the
same cells.

On the full lattice (``grid=None``) the kernels work tile by tile: a block
owns a :data:`TILE`^3 tile of voxels, and for each angle the tile's points
land in a window of the plane whose extent the host computes
(:func:`bucket_trig`'s last four columns). The adjoint stages the window in
shared memory and gathers from it; the forward accumulates into it and adds
each nonzero cell to the plane once. A point outside its window (none, when
the extents are right) adds 1 to a counter on the card
(:func:`outside_windows`) and takes the global path. ``slab=(x0, rows)``
stands for the x-slab of the lattice that holds rows x0 .. x0 + rows - 1 of
axis 0 (:func:`slab_of`: the part of a shard of a mesh, :func:`make_grid`'s
``rank`` of ``size``), which the kernels tile from row x0 as they tile the
lattice. A caller's grid takes one thread per voxel.

:func:`sharded_bucket_ops` and :func:`sharded_bucket_ops_2d` run the
operator over a mesh (``tike_tpu_torch.parallel``), each shard on its own
slab, as the JAX package's ``obj_split`` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import kernels
from .. import linalg
from ..parallel import all_gather, all_reduce
from ..parallel._mesh import _is_local

LAUNCHES = {"bucket_fwd": 0, "bucket_adj": 0}
"""How many times each CUDA kernel has been launched in this process.
Incremented only by a successful launch; callers may reset them to 0."""

TRIG_WIDTH = 8
"""Leading columns of :func:`bucket_trig`'s table, each angle's
trigonometry: nx, ny, nz, st, cq ct, sq ct, -sq, cq."""
TABLE_WIDTH = 12
"""Columns of :func:`bucket_trig`'s table: the trigonometry, then the tiled
kernels' window of the angle: the lowest y and z of a tile's points
relative to its lowest corner (less a margin), and the window's rows and
columns."""

TILE = 8
"""Voxels along each axis of a tile of the lattice kernels (``csrc/
bucket.cu``'s ``kTile``)."""
PARAM_OFFSETS = 64
"""Offsets the kernels take in their parameters (``kParamOffsets``); a
larger precision's further offsets are computed in the kernel."""

HBM_BYTES_PER_S = 3.35e12
"""The H100's published HBM rate (SXM, 700 W)."""
FP32_PER_S = 132 * 128 * 1.98e9
"""float32 instructions a second on the H100's FP32 pipe (132 SMs, 128 a
clock, 1.98 GHz): each operation rounded on its own is one instruction, so
no FMA counts twice."""
CONVERSIONS_PER_S = 132 * 16 * 1.98e9
"""Conversions (such as a float's floor to an integer) a second: 16 a clock
on each SM, on a pipe of their own."""
POINT_FP32 = {"bucket_fwd": 15, "bucket_adj": 19}
"""Rounded float32 operations a point needs, everything that does not change
within a voxel's row of points hoisted: 1 for d, 6 for (px, py, pz), 5 for
y and 3 for z; the adjoint's 2 products and 2 sums on top (the forward's
run of points into one cell needs one product)."""
POINT_FLOORS = 2
"""Floors a point needs (y and z): on the conversion pipe, or as one
round-down add on the FP32 pipe."""
FP32_FLOPS_PER_S = 67e12
POINT_FLOPS = 24
"""The first count of the bound: 24 float32 operations a point at the
H100's 67 TFLOP/s outside the tensor cores, which counts an FMA as two."""


@dataclasses.dataclass(frozen=True)
class BucketConfig:
    """Static configuration of the Bucket laminography operator."""

    n: int
    tilt: float
    precision: int = 1

    @classmethod
    def from_eps(cls, n: int, tilt: float, eps: float = 1.0):
        """Pick the sub-sampling precision so 1/precision^3 <= eps."""
        precision = 1
        while (1 / precision**3) > eps:
            precision += 1
        return cls(n=n, tilt=tilt, precision=precision)


def make_grid(n: int, size: int = 1, rank: int = 0) -> np.ndarray:
    """Origin-centred integer voxel coordinates (G, 3) int32, the part of
    ``rank`` of ``size`` x-slabs."""
    lo, hi = -n // 2, n // 2
    grid = np.stack(np.mgrid[lo:hi, lo:hi, lo:hi], axis=-1)
    return np.array_split(grid, size)[rank].reshape(-1, 3).astype(np.int32)


def make_grid_full(n: int) -> np.ndarray:
    """The (n, n, n, 3) origin-centred voxel coordinate lattice. Its rows
    of axis 0 split as :func:`slab_of` splits them are :func:`make_grid`'s
    x-slabs."""
    lo, hi = -n // 2, n // 2
    return np.stack(np.mgrid[lo:hi, lo:hi, lo:hi], axis=-1).astype(np.int32)


def slab_of(n: int, size: int = 1, rank: int = 0) -> tuple:
    """``(x0, rows)``: the rows of axis 0 of the n^3 lattice in part ``rank``
    of ``size``, as ``np.array_split`` splits them (:func:`make_grid`)."""
    bounds = np.cumsum([0] + [len(a) for a in np.array_split(np.arange(n), size)])
    return int(bounds[rank]), int(bounds[rank + 1] - bounds[rank])


def _subsample_offsets(precision: int) -> np.ndarray:
    """The precision^3 sub-voxel sample offsets (i+0.5)/precision,
    (precision^3, 3) float32, the last axis fastest."""
    c = (np.arange(precision) + 0.5) / precision
    i, j, k = np.meshgrid(c, c, c, indexing="ij")
    return np.stack([i.ravel(), j.ravel(), k.ravel()], -1).astype(np.float32)


def bucket_offsets(precision: int) -> np.ndarray:
    """The sub-voxel offsets (i + 0.5) / precision along one axis, (precision,)
    float32: the float64 quotient rounded, as :func:`_subsample_offsets`'s."""
    return ((np.arange(precision) + 0.5) / precision).astype(np.float32)


def _margin(cfg: BucketConfig) -> float:
    """Cells by which a window reaches past its tile's points on each side:
    1/16, and 2^-17 of the largest |y| of the lattice (some 64 float32 ulps)
    for the rounding of the points' and the window's coordinates."""
    return 1 / 16 + np.sqrt(3) * (cfg.n / 2 + 1) * 2.0**-17


def window_limits(cfg: BucketConfig) -> tuple:
    """(rows, columns) of the kernels' window buffers: the largest window of
    a tile at any angle, and 2 more of each, which the forward's 3 x 3 cell
    boxes of a voxel's points reach past the window's points. A tile's
    points span (TILE - 1) + c_last - c_0 along each axis, and the sum of
    |e_i| of y's unit direction is at most sqrt(3) (of z's, (0, -sq, cq), at
    most sqrt(2))."""
    c = bucket_offsets(cfg.precision).astype(np.float64)
    span = TILE - 1 + c[-1] - c[0]
    m = 2 * _margin(cfg)
    bound = lambda s: int(np.floor(s * span * (1 + 1e-6) + m)) + 4  # noqa: E731
    return bound(np.sqrt(3)), bound(np.sqrt(2))


def _windows(cfg: BucketConfig, trig: np.ndarray) -> np.ndarray:
    """The (T, 4) float32 window columns of :func:`bucket_trig` for the (T, 8)
    trigonometry ``trig``: per angle, the lowest y and z of a tile's points
    relative to its lowest corner less the margin (rounded down to float32),
    and the rows and columns of the window, floor(span + 2 margin) + 2, which
    hold every point's floor from that of the corner's lowest coordinate
    (``csrc/bucket.cu``'s ``window_of``)."""
    c = bucket_offsets(cfg.precision).astype(np.float64)
    near, far = c[0], TILE - 1 + c[-1]
    t = trig.astype(np.float64)
    m = _margin(cfg)
    out = []
    for e in (t[:, 3:6], np.stack([np.zeros(len(t)), t[:, 6], t[:, 7]], -1)):
        low = np.minimum(e * near, e * far).sum(-1) - m
        low32 = low.astype(np.float32)
        low32 = np.where(low32 > low, np.nextafter(low32, np.float32(-np.inf)), low32)
        out.append((low32, np.floor((np.abs(e) * (far - near)).sum(-1) + 2 * m) + 2))
    (ylo, rows), (zlo, cols) = out
    limits = window_limits(cfg)
    assert rows.max(initial=0) + 2 <= limits[0] and cols.max(initial=0) + 2 <= limits[1]
    return np.stack([ylo, zlo, rows, cols], -1).astype(np.float32)


def bucket_trig(cfg: BucketConfig, theta) -> torch.Tensor:
    """The (T, 12) float32 table of each angle, on theta's device: its
    trigonometry (nx, ny, nz, st, cq ct, sq ct, -sq, cq), with ct, st the
    cos and sin of the tilt and cq, sq those of the angle, then the tiled
    kernels' window (:func:`_windows`).

    Computed on the host: each cos and sin as the float64 value of the
    float32 angle, rounded to float32; each product as the float64 product
    of two such float32 values (exact), rounded once, which is the float32
    product. A device theta is copied to the host once.
    """
    device = theta.device if isinstance(theta, torch.Tensor) else None
    th = np.asarray(
        theta.detach().cpu().numpy() if isinstance(theta, torch.Tensor) else theta,
        dtype=np.float32,
    ).astype(np.float64)
    f32 = lambda x: np.asarray(x, np.float64).astype(np.float32).astype(np.float64)  # noqa: E731
    tilt = float(np.float32(cfg.tilt))
    ct, st = f32(np.cos(tilt)), f32(np.sin(tilt))
    cq, sq = f32(np.cos(th)), f32(np.sin(th))
    ct, st = np.broadcast_to(ct, cq.shape), np.broadcast_to(st, cq.shape)
    table = np.stack(
        [ct, -(cq * st), -(sq * st), st, cq * ct, sq * ct, -sq, cq], axis=-1
    ).astype(np.float32).reshape(-1, TRIG_WIDTH)
    table = np.concatenate([table, _windows(cfg, table)], -1)
    return torch.as_tensor(table, device=device)


def _weight(cfg: BucketConfig) -> float:
    """1/precision^3 as the float32 value the JAX package uses."""
    return float(np.float32(1.0 / cfg.precision**3))


def _grid_tensor(cfg: BucketConfig, grid, device, slab=None) -> torch.Tensor:
    """The voxel coordinates as an (G, 3) int32 tensor on ``device``: the
    caller's grid, or the lattice's ``slab`` (the whole lattice for None)."""
    x0, rows = _slab(cfg, grid, slab)
    if grid is None:
        grid = make_grid_full(cfg.n)[x0 : x0 + rows]
    if isinstance(grid, torch.Tensor):
        return grid.to(device=device, dtype=torch.int32).reshape(-1, 3)
    return torch.as_tensor(np.asarray(grid, np.int32).reshape(-1, 3), device=device)


def plane_coordinates(grid: torch.Tensor, offset, trig_row):
    """The in-plane coordinates (y, z), float32, of every voxel of ``grid``
    ((G, 3) int32) sampled at ``offset`` ((3,) float32) for the angle of
    ``trig_row``, in the JAX package's order of float32 operations."""
    nx, ny, nz, st, cqct, sqct, nsq, cq = trig_row[:TRIG_WIDTH].unbind(0)
    p = grid.to(torch.float32) + offset
    p0, p1, p2 = p.unbind(-1)
    d = p0 * nx + p1 * ny + p2 * nz
    px = p0 - d * nx
    py = p1 - d * ny
    pz = p2 - d * nz
    return st * px + cqct * py + sqct * pz, nsq * py + cq * pz


def plane_flat_indices(cfg: BucketConfig, grid: torch.Tensor, offset, trig_row):
    """The flat plane cell (iy n + iz, int64) of every voxel of ``grid``
    ((G, 3) int32) sampled at ``offset`` ((3,) float32) for the angle of
    ``trig_row`` (one row of :func:`bucket_trig`), in the JAX package's
    order of float32 operations."""
    y, z = plane_coordinates(grid, offset, trig_row)
    n = cfg.n
    iy = torch.remainder(torch.floor(y).to(torch.int64) + n // 2, n)
    iz = torch.remainder(torch.floor(z).to(torch.int64) + n // 2, n)
    return iy * n + iz


def _slab(cfg: BucketConfig, grid, slab) -> tuple:
    """``slab`` checked, ``(0, n)`` for None; a grid and a slab together
    raise."""
    if slab is None:
        return 0, cfg.n
    if grid is not None:
        raise ValueError("pass a grid or a slab, not both")
    x0, rows = (int(v) for v in slab)
    if x0 < 0 or rows < 0 or x0 + rows > cfg.n:
        raise ValueError(f"slab {slab} is not a run of rows of 0 .. {cfg.n - 1}")
    return x0, rows


def _trig_for(cfg: BucketConfig, theta, trig):
    """``trig`` checked against theta, or the table of theta."""
    if trig is None:
        return bucket_trig(cfg, theta)
    if tuple(trig.shape) != (theta.shape[0], TABLE_WIDTH):
        raise ValueError(
            f"trig must be ({theta.shape[0]}, {TABLE_WIDTH}); got {tuple(trig.shape)}"
        )
    return trig


def bucket_fwd_plain(cfg: BucketConfig, u, theta, grid=None, trig=None, slab=None):
    """Plain PyTorch ``bucket_fwd``: for each angle and offset, the cells
    of all voxels and an ``index_add_`` of the weighted values into a
    float-pair view of the plane. Returns (T, n, n) complex64."""
    device = u.device
    trig = _trig_for(cfg, theta, trig).to(device)
    g = _grid_tensor(cfg, grid, device, slab)
    uf = torch.view_as_real(u.reshape(-1).to(torch.complex64)) * torch.tensor(
        _weight(cfg), dtype=torch.float32, device=device
    )
    offsets = torch.as_tensor(_subsample_offsets(cfg.precision), device=device)
    out = torch.zeros((trig.shape[0], cfg.n * cfg.n, 2), dtype=torch.float32, device=device)
    for t in range(trig.shape[0]):
        for off in offsets:
            out[t].index_add_(0, plane_flat_indices(cfg, g, off, trig[t]), uf)
    return torch.view_as_complex(out).reshape(-1, cfg.n, cfg.n)


def bucket_adj_plain(cfg: BucketConfig, data, theta, grid=None, trig=None, slab=None):
    """Plain PyTorch ``bucket_adj``: for each angle (outer) and offset
    (inner), gather the plane at every voxel's cell and add it times the
    weight. Returns (G,) complex64."""
    device = data.device
    trig = _trig_for(cfg, theta, trig).to(device)
    g = _grid_tensor(cfg, grid, device, slab)
    w = torch.tensor(_weight(cfg), dtype=torch.float32, device=device)
    offsets = torch.as_tensor(_subsample_offsets(cfg.precision), device=device)
    planes = torch.view_as_real(data.to(torch.complex64)).reshape(trig.shape[0], -1, 2)
    acc = torch.zeros((g.shape[0], 2), dtype=torch.float32, device=device)
    for t in range(trig.shape[0]):
        for off in offsets:
            acc = acc + planes[t][plane_flat_indices(cfg, g, off, trig[t])] * w
    return torch.view_as_complex(acc.contiguous())


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, not on {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape {tuple(shape)}; "
            f"got {t.dtype} {tuple(t.shape)} (contiguous={t.is_contiguous()})"
        )


def _raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


OUTSIDE = kernels.CardCounter()
"""The card's count of points that fell outside their tile's window."""


def outside_windows(device) -> int:
    """Points of the lattice kernels on the card ``device`` that fell outside
    their tile's window since the last :func:`reset_outside_windows`, over
    all launches. Each still reached its cell through global memory; a
    nonzero count means the window extents are wrong. Waits for the card."""
    return OUTSIDE.read(device)


def reset_outside_windows(device) -> None:
    """Set the card's count of :func:`outside_windows` to 0."""
    OUTSIDE.reset(device)


def _kernel_inputs(cfg: BucketConfig, voxels: int, theta, grid, trig, device, slab):
    """The table and the grid (or None) as the kernels take them, checked."""
    trig = _trig_for(cfg, theta, trig)
    _check("trig", trig, torch.float32, (theta.shape[0], TABLE_WIDTH))
    if trig.device != device:
        raise ValueError(f"trig is on {trig.device}, the values on {device}")
    if grid is None:
        _, rows = _slab(cfg, None, slab)
        if slab is None and voxels != cfg.n**3:
            raise ValueError(f"without a grid the volume must hold n^3 = {cfg.n**3} voxels")
        if voxels != rows * cfg.n**2:
            raise ValueError(
                f"without a grid the volume must hold the slab's {rows} x n^2 = "
                f"{rows * cfg.n**2} voxels"
            )
        return trig, None
    if not isinstance(grid, torch.Tensor):
        grid = torch.as_tensor(np.asarray(grid, np.int32), device=device)
    grid = grid.reshape(-1, 3)
    _check("grid", grid, torch.int32, (voxels, 3))
    if grid.device != device:
        raise ValueError(f"grid is on {grid.device}, the values on {device}")
    return trig, grid


def _launch(name: str, cfg: BucketConfig, values, out, voxels, theta, grid, trig, slab):
    """Launch ``tike_<name>`` on ``values`` into ``out``."""
    device = values.device
    trig, grid = _kernel_inputs(cfg, voxels, theta, grid, trig, device, slab)
    x0, rows = _slab(cfg, grid, slab)
    window_rows, pitch = window_limits(cfg)
    offsets = bucket_offsets(cfg.precision)
    counter = OUTSIDE.tensor(device)
    lib = kernels.load("bucket")
    with torch.cuda.device(device):
        rc = getattr(lib, f"tike_{name}")(
            values.data_ptr(), None if grid is None else grid.data_ptr(), trig.data_ptr(),
            out.data_ptr(), counter.data_ptr(), offsets.ctypes.data, voxels, trig.shape[0],
            cfg.n, cfg.precision, _weight(cfg), pitch, window_rows * pitch, x0, rows,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(name, rc)
    LAUNCHES[name] += 1
    return out


def bucket_fwd_cuda(cfg: BucketConfig, u, theta, grid=None, trig=None, slab=None):
    """Launch the CUDA ``bucket_fwd`` kernel (``csrc/bucket.cu``)."""
    u = u.reshape(-1)
    voxels = u.shape[0]
    _check("u", u, torch.complex64, (voxels,))
    out = torch.empty((theta.shape[0], cfg.n, cfg.n), dtype=torch.complex64, device=u.device)
    return _launch("bucket_fwd", cfg, u, out, voxels, theta, grid, trig, slab)


def bucket_adj_cuda(cfg: BucketConfig, data, theta, grid=None, trig=None, slab=None):
    """Launch the CUDA ``bucket_adj`` kernel (``csrc/bucket.cu``)."""
    _check("data", data, torch.complex64, (theta.shape[0], cfg.n, cfg.n))
    if grid is None:
        voxels = _slab(cfg, None, slab)[1] * cfg.n**2
    else:
        voxels = int(np.prod(grid.shape)) // 3
    out = torch.empty((voxels,), dtype=torch.complex64, device=data.device)
    return _launch("bucket_adj", cfg, data, out, voxels, theta, grid, trig, slab)


def bucket_fwd(cfg: BucketConfig, u, theta, grid=None, trig=None, slab=None):
    """Forward projection: volume (any shape holding the G voxels of
    ``grid``, or of the lattice's ``slab``, complex64) -> (T, n, n)
    complex64 planes. ``trig`` is :func:`bucket_trig` of ``theta``, if the
    caller keeps it. CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if kernels.on_cpu(u, theta, grid, trig):
        return bucket_fwd_plain(cfg, u, theta, grid, trig, slab)
    return bucket_fwd_cuda(cfg, u, theta, grid, trig, slab)


def bucket_adj(cfg: BucketConfig, data, theta, grid=None, trig=None, slab=None):
    """Adjoint projection: (T, n, n) planes -> (G,) complex64 volume."""
    if kernels.on_cpu(data, theta, grid, trig):
        return bucket_adj_plain(cfg, data, theta, grid, trig, slab)
    return bucket_adj_cuda(cfg, data, theta, grid, trig, slab)


def bucket_cost(data, fwd_data):
    """Least-squares cost, a 0-d float32 tensor."""
    diff = fwd_data - data
    return torch.sum((diff * torch.conj(diff)).real)


def bucket_grad(cfg: BucketConfig, data, theta, fwd_data, grid=None, trig=None):
    """Least-squares gradient, (G,) complex64."""
    out = bucket_adj(cfg, fwd_data - data, theta, grid, trig)
    return out / (data.shape[-3] * cfg.n**3)


def bucket_step_scale(cfg: BucketConfig, u, theta, grid=None, trig=None):
    """CG step-length scale 2|A*A u| / |u|, a 0-d tensor."""
    back = bucket_adj(cfg, bucket_fwd(cfg, u, theta, grid, trig), theta, grid, trig)
    return 2 * linalg.norm(back) / (linalg.norm(u) + 1e-32)


def bucket_cost_program(cfg: BucketConfig, data, u, theta, grid=None, trig=None):
    """``cost(data, fwd(u))`` in one call, as
    :func:`tike_tpu.ops.bucket.bucket_cost_program` composes it."""
    return bucket_cost(data, bucket_fwd(cfg, u, theta, grid, trig))


def bucket_grad_program(cfg: BucketConfig, data, u, theta, grid=None, trig=None):
    """The least-squares gradient of the Bucket model at ``u`` in one call,
    as :func:`tike_tpu.ops.bucket.bucket_grad_program` composes it."""
    return bucket_grad(cfg, data, theta, bucket_fwd(cfg, u, theta, grid, trig), grid, trig)


def points(cfg: BucketConfig, voxels: int, angles: int) -> int:
    """Point projections of one forward or adjoint: one per voxel, angle
    and offset."""
    return voxels * angles * cfg.precision**3


def roofline(cfg: BucketConfig, voxels: int, angles: int, kernel: str = "bucket_fwd",
             grid: bool = False) -> dict:
    """The least time the H100 could take for one forward or adjoint
    (``kernel``), pipe by pipe: the bytes (the volume read or written once,
    8 bytes a voxel; the planes written or read once, 8 bytes a cell; the
    grid's 12 bytes a voxel where one is given; the table) at 3.35 TB/s; the
    :data:`POINT_FP32` rounded float32 operations a point on the FP32 pipe;
    and the :data:`POINT_FLOORS` floors a point, on the conversion pipe or as
    adds on the FP32 pipe, whichever the least time wants: the operations
    take max(fp32 / FP32_PER_S, (fp32 + floors) / (FP32_PER_S +
    CONVERSIONS_PER_S)). ``bound_ms`` is the larger of bytes and operations;
    ``bound_ms_first_count`` the first count's (:data:`POINT_FLOPS` a point
    at 67 TFLOP/s)."""
    nbytes = 8 * voxels + 8 * angles * cfg.n**2 + 4 * TABLE_WIDTH * angles
    if grid:
        nbytes += 12 * voxels
    n_points = points(cfg, voxels, angles)
    fp32, floors = POINT_FP32[kernel] * n_points, POINT_FLOORS * n_points
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = max(1e3 * fp32 / FP32_PER_S, 1e3 * (fp32 + floors) / (FP32_PER_S + CONVERSIONS_PER_S))
    return dict(
        bound_bytes=nbytes,
        bound_fp32=fp32,
        bound_floors=floors,
        bound_bytes_ms=bytes_ms,
        bound_fp32_ms=1e3 * fp32 / FP32_PER_S,
        bound_floors_ms=1e3 * floors / CONVERSIONS_PER_S,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bound_ms_first_count=max(bytes_ms, 1e3 * POINT_FLOPS * n_points / FP32_FLOPS_PER_S),
        points=n_points,
    )


class _MeshOps:
    """The Bucket operator over a grid of shards, ``devices`` (D, V): the
    angles split over the D data groups (rows), the lattice's x-slabs
    (:func:`slab_of`) over the V shards of a group. Volumes, projections
    and tables come and go as whole tensors on this process's first
    shard's device; each shard reads its angles and its slab from there (a
    view where it lies on that device).

    On a mesh across processes each process computes its own shards'
    parts; a group that spans processes is reduced across them, and the
    groups' results that this process lacks (another process's rows of
    projections, or slabs) are gathered along a row or column that holds
    one shard of each. Every process holds the whole data and angles."""

    def __init__(self, cfg: BucketConfig, devices: np.ndarray):
        self.cfg = cfg
        self.devices = devices
        local = np.vectorize(_is_local, otypes=[bool])(devices)
        self.home = devices[local][0]
        groups, slabs = devices.shape
        if cfg.n % slabs:
            raise ValueError(
                f"the volume mesh axis ({slabs}) must evenly divide the volume side ({cfg.n})"
            )
        self.slabs = [slab_of(cfg.n, slabs, v) for v in range(slabs)]
        # Whether each process holds a shard of every row (column): else
        # the rows' (columns') results are gathered. Computed from the
        # owners, which every process knows alike.
        owners = np.vectorize(lambda d: d.rank if not _is_local(d) else -1)(devices)
        every = set(owners.reshape(-1).tolist())
        self._rows_whole = all(set(r.tolist()) == every for r in owners)
        self._columns_whole = all(set(c.tolist()) == every for c in owners.T)

    def _groups(self, theta, trig):
        """Each data group's angles and table, checked against its size."""
        groups = self.devices.shape[0]
        if theta.shape[0] % groups:
            raise ValueError(
                f"the data mesh axis ({groups}) must evenly divide the number of angles "
                f"({theta.shape[0]})"
            )
        trig = _trig_for(self.cfg, theta, trig)
        return zip(torch.chunk(theta, groups), torch.chunk(trig, groups))

    def fwd(self, u, theta, trig=None) -> torch.Tensor:
        """(T, n, n) projections of the volume: each group's shards project
        their slabs at the group's angles, and the partial projections of a
        group are summed (``parallel.all_reduce``)."""
        cfg, out = self.cfg, {}
        u = u.reshape(cfg.n, cfg.n, cfg.n)
        for g, (row, (th, tr)) in enumerate(zip(self.devices, self._groups(theta, trig))):
            parts = [
                bucket_fwd(cfg, u[x0 : x0 + rows].to(d), th.to(d), None, tr.to(d), (x0, rows))
                for d, (x0, rows) in zip(row, self.slabs)
                if _is_local(d)
            ]
            if parts:
                out[g] = all_reduce(parts, list(row))[0].to(self.home)
        if self._rows_whole:
            return torch.cat(list(out.values()))
        column = list(self.devices[:, 0])
        mine = [out[g] for g, d in enumerate(column) if _is_local(d)]
        return all_gather(mine, column)[0].to(self.home)

    def adj(self, data, theta, trig=None) -> torch.Tensor:
        """(n, n, n) adjoint: each shard gathers its slab's voxels from its
        group's projections, the groups' parts of a slab are summed
        (``parallel.all_reduce`` down a column), and the slabs joined."""
        cfg = self.cfg
        groups = list(self._groups(theta, trig))
        slabs = {}
        for v, (x0, rows) in enumerate(self.slabs):
            column = list(self.devices[:, v])
            parts = [
                bucket_adj(cfg, d_g.to(d), th.to(d), None, tr.to(d), (x0, rows))
                for d, d_g, (th, tr) in zip(
                    column, torch.chunk(data, len(groups)), groups
                )
                if _is_local(d)
            ]
            if parts:
                slabs[v] = all_reduce(parts, column)[0].to(self.home)
        if self._columns_whole:
            return torch.cat(list(slabs.values())).reshape(cfg.n, cfg.n, cfg.n)
        row = list(self.devices[0])
        mine = [slabs[v] for v, d in enumerate(row) if _is_local(d)]
        return all_gather(mine, row)[0].to(self.home).reshape(cfg.n, cfg.n, cfg.n)

    def cost(self, data, u, theta, grid=None, trig=None):
        _no_grid(grid)
        return bucket_cost(data, self.fwd(u, theta, trig))

    def grad(self, data, u, theta, grid=None, trig=None):
        _no_grid(grid)
        g = self.adj(self.fwd(u, theta, trig) - data, theta, trig)
        return g / (data.shape[-3] * self.cfg.n**3)

    def step_scale(self, u, theta, trig=None):
        back = self.adj(self.fwd(u, theta, trig), theta, trig)
        return 2 * linalg.norm(back) / (linalg.norm(u) + 1e-32)

    def ops(self) -> tuple:
        return self.fwd, self.adj, self.cost, self.grad, self.step_scale


def _no_grid(grid) -> None:
    if grid is not None:
        raise ValueError("the mesh's operators tile the lattice's slabs; they take no grid")


def sharded_bucket_ops(cfg: BucketConfig, mesh, axis: str) -> tuple:
    """Volume-parallel Bucket operators over the mesh axis ``axis``, as
    :func:`tike_tpu.ops.bucket.sharded_bucket_ops`: each shard owns an x-slab
    of the lattice (the tiled kernels on a slab), the shards' partial
    projections are summed, and the adjoint is owner-local, each shard's
    slab gathered from the whole projections.

    Returns ``(fwd, adj, cost, grad, step_scale)``: ``fwd(u, theta,
    trig=None)``, ``adj(data, theta, trig=None)``, ``cost(data, u, theta,
    grid=None, trig=None)``, ``grad(data, u, theta, grid=None, trig=None)``
    and ``step_scale(u, theta, trig=None)``, on whole (n, n, n) volumes and
    (T, n, n) projections on the mesh's first device (``trig`` the angles'
    :func:`bucket_trig`, if the caller keeps it; a grid raises).
    """
    if list(mesh.axis_names) != [axis]:
        raise ValueError(f"a 1-D mesh over {axis!r} is needed; got {mesh.axis_names}")
    return _MeshOps(cfg, mesh.devices.reshape(1, -1)).ops()


def sharded_bucket_ops_2d(cfg: BucketConfig, mesh, data_axis: str, vol_axis: str) -> tuple:
    """(data x volume) parallel Bucket operators, as
    :func:`tike_tpu.ops.bucket.sharded_bucket_ops_2d`: the angles split over
    ``data_axis``, the lattice's x-slabs over ``vol_axis``; partial
    projections are summed within a data group, and each slab's gradient
    across the data groups. The same five callables as
    :func:`sharded_bucket_ops`.
    """
    if sorted(mesh.axis_names) != sorted([data_axis, vol_axis]) or data_axis == vol_axis:
        raise ValueError(
            f"a 2-D mesh over {data_axis!r} and {vol_axis!r} is needed; got {mesh.axis_names}"
        )
    devices = mesh.devices
    if mesh.axis_names[0] != data_axis:
        devices = devices.T
    return _MeshOps(cfg, devices).ops()
