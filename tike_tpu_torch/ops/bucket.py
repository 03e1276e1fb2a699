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
kernel or raise. Both read the same per-angle trigonometry table
(:func:`bucket_trig`) and compute each point's cell in the JAX package's
order of float32 operations, so the kernels, the plain versions and the JAX
package pick the same cells.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import kernels
from .. import linalg

LAUNCHES = {"bucket_fwd": 0, "bucket_adj": 0}
"""How many times each CUDA kernel has been launched in this process.
Incremented only by a successful launch; callers may reset them to 0."""

TABLE_WIDTH = 8
"""Columns of :func:`bucket_trig`'s table: nx, ny, nz, st, cq ct, sq ct,
-sq, cq."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
"""The H100's published HBM rate and float32 rate outside the tensor
cores (SXM, 700 W), for the bounds."""

POINT_FLOPS = 24
"""float32 operations of one point: 3 adds for the point, 5 for d, 6 for
(px, py, pz), 5 for y, 3 for z, and the 2 of the value's accumulation."""


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
    """The (n, n, n, 3) origin-centred voxel coordinate lattice."""
    lo, hi = -n // 2, n // 2
    return np.stack(np.mgrid[lo:hi, lo:hi, lo:hi], axis=-1).astype(np.int32)


def _subsample_offsets(precision: int) -> np.ndarray:
    """The precision^3 sub-voxel sample offsets (i+0.5)/precision,
    (precision^3, 3) float32, the last axis fastest."""
    c = (np.arange(precision) + 0.5) / precision
    i, j, k = np.meshgrid(c, c, c, indexing="ij")
    return np.stack([i.ravel(), j.ravel(), k.ravel()], -1).astype(np.float32)


def bucket_trig(cfg: BucketConfig, theta) -> torch.Tensor:
    """The (T, 8) float32 table of each angle's trigonometry, on theta's
    device: (nx, ny, nz, st, cq ct, sq ct, -sq, cq), with ct, st the cos
    and sin of the tilt and cq, sq those of the angle.

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
    ).astype(np.float32)
    return torch.as_tensor(table.reshape(-1, TABLE_WIDTH), device=device)


def _weight(cfg: BucketConfig) -> float:
    """1/precision^3 as the float32 value the JAX package uses."""
    return float(np.float32(1.0 / cfg.precision**3))


def _grid_tensor(cfg: BucketConfig, grid, device) -> torch.Tensor:
    """The voxel coordinates as an (G, 3) int32 tensor on ``device``."""
    if grid is None:
        grid = make_grid(cfg.n)
    if isinstance(grid, torch.Tensor):
        return grid.to(device=device, dtype=torch.int32).reshape(-1, 3)
    return torch.as_tensor(np.asarray(grid, np.int32).reshape(-1, 3), device=device)


def plane_flat_indices(cfg: BucketConfig, grid: torch.Tensor, offset, trig_row):
    """The flat plane cell (iy n + iz, int64) of every voxel of ``grid``
    ((G, 3) int32) sampled at ``offset`` ((3,) float32) for the angle of
    ``trig_row`` (one row of :func:`bucket_trig`), in the JAX package's
    order of float32 operations."""
    nx, ny, nz, st, cqct, sqct, nsq, cq = trig_row.unbind(0)
    p = grid.to(torch.float32) + offset
    p0, p1, p2 = p.unbind(-1)
    d = p0 * nx + p1 * ny + p2 * nz
    px = p0 - d * nx
    py = p1 - d * ny
    pz = p2 - d * nz
    y = st * px + cqct * py + sqct * pz
    z = nsq * py + cq * pz
    n = cfg.n
    iy = torch.remainder(torch.floor(y).to(torch.int64) + n // 2, n)
    iz = torch.remainder(torch.floor(z).to(torch.int64) + n // 2, n)
    return iy * n + iz


def _trig_for(cfg: BucketConfig, theta, trig):
    """``trig`` checked against theta, or the table of theta."""
    if trig is None:
        return bucket_trig(cfg, theta)
    if tuple(trig.shape) != (theta.shape[0], TABLE_WIDTH):
        raise ValueError(
            f"trig must be ({theta.shape[0]}, {TABLE_WIDTH}); got {tuple(trig.shape)}"
        )
    return trig


def bucket_fwd_plain(cfg: BucketConfig, u, theta, grid=None, trig=None):
    """Plain PyTorch ``bucket_fwd``: for each angle and offset, the cells
    of all voxels and an ``index_add_`` of the weighted values into a
    float-pair view of the plane. Returns (T, n, n) complex64."""
    device = u.device
    trig = _trig_for(cfg, theta, trig).to(device)
    g = _grid_tensor(cfg, grid, device)
    uf = torch.view_as_real(u.reshape(-1).to(torch.complex64)) * torch.tensor(
        _weight(cfg), dtype=torch.float32, device=device
    )
    offsets = torch.as_tensor(_subsample_offsets(cfg.precision), device=device)
    out = torch.zeros((trig.shape[0], cfg.n * cfg.n, 2), dtype=torch.float32, device=device)
    for t in range(trig.shape[0]):
        for off in offsets:
            out[t].index_add_(0, plane_flat_indices(cfg, g, off, trig[t]), uf)
    return torch.view_as_complex(out).reshape(-1, cfg.n, cfg.n)


def bucket_adj_plain(cfg: BucketConfig, data, theta, grid=None, trig=None):
    """Plain PyTorch ``bucket_adj``: for each angle (outer) and offset
    (inner), gather the plane at every voxel's cell and add it times the
    weight. Returns (G,) complex64."""
    device = data.device
    trig = _trig_for(cfg, theta, trig).to(device)
    g = _grid_tensor(cfg, grid, device)
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


def _kernel_inputs(cfg: BucketConfig, voxels: int, theta, grid, trig, device):
    """The trig table and the grid (or None) as the kernels take them,
    checked."""
    trig = _trig_for(cfg, theta, trig)
    _check("trig", trig, torch.float32, (theta.shape[0], TABLE_WIDTH))
    if trig.device != device:
        raise ValueError(f"trig is on {trig.device}, the values on {device}")
    if grid is None:
        if voxels != cfg.n**3:
            raise ValueError(f"without a grid the volume must hold n^3 = {cfg.n**3} voxels")
        return trig, None
    if not isinstance(grid, torch.Tensor):
        grid = torch.as_tensor(np.asarray(grid, np.int32), device=device)
    grid = grid.reshape(-1, 3)
    _check("grid", grid, torch.int32, (voxels, 3))
    if grid.device != device:
        raise ValueError(f"grid is on {grid.device}, the values on {device}")
    return trig, grid


def bucket_fwd_cuda(cfg: BucketConfig, u, theta, grid=None, trig=None):
    """Launch the CUDA ``bucket_fwd`` kernel (``csrc/bucket.cu``)."""
    u = u.reshape(-1)
    voxels = u.shape[0]
    _check("u", u, torch.complex64, (voxels,))
    trig, grid = _kernel_inputs(cfg, voxels, theta, grid, trig, u.device)
    angles = trig.shape[0]
    out = torch.empty((angles, cfg.n, cfg.n), dtype=torch.complex64, device=u.device)
    lib = kernels.load("bucket")
    with torch.cuda.device(u.device):
        rc = lib.tike_bucket_fwd(
            u.data_ptr(), None if grid is None else grid.data_ptr(), trig.data_ptr(),
            out.data_ptr(), voxels, angles, cfg.n, cfg.precision, _weight(cfg),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error("bucket_fwd", rc)
    LAUNCHES["bucket_fwd"] += 1
    return out


def bucket_adj_cuda(cfg: BucketConfig, data, theta, grid=None, trig=None):
    """Launch the CUDA ``bucket_adj`` kernel (``csrc/bucket.cu``)."""
    angles = theta.shape[0]
    _check("data", data, torch.complex64, (angles, cfg.n, cfg.n))
    voxels = cfg.n**3 if grid is None else int(np.prod(grid.shape)) // 3
    trig, grid = _kernel_inputs(cfg, voxels, theta, grid, trig, data.device)
    out = torch.empty((voxels,), dtype=torch.complex64, device=data.device)
    lib = kernels.load("bucket")
    with torch.cuda.device(data.device):
        rc = lib.tike_bucket_adj(
            data.data_ptr(), None if grid is None else grid.data_ptr(), trig.data_ptr(),
            out.data_ptr(), voxels, angles, cfg.n, cfg.precision, _weight(cfg),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error("bucket_adj", rc)
    LAUNCHES["bucket_adj"] += 1
    return out


def _on_cpu(*tensors) -> bool:
    devices = {t.device.type for t in tensors if isinstance(t, torch.Tensor)}
    if devices == {"cpu"}:
        return True
    if "cpu" in devices:
        raise ValueError(f"tensors must all be on one device; got {sorted(devices)}")
    return False


def bucket_fwd(cfg: BucketConfig, u, theta, grid=None, trig=None):
    """Forward projection: volume (any shape holding the G voxels of
    ``grid``, complex64) -> (T, n, n) complex64 planes. ``trig`` is
    :func:`bucket_trig` of ``theta``, if the caller keeps it. CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if _on_cpu(u, theta, grid, trig):
        return bucket_fwd_plain(cfg, u, theta, grid, trig)
    return bucket_fwd_cuda(cfg, u, theta, grid, trig)


def bucket_adj(cfg: BucketConfig, data, theta, grid=None, trig=None):
    """Adjoint projection: (T, n, n) planes -> (G,) complex64 volume."""
    if _on_cpu(data, theta, grid, trig):
        return bucket_adj_plain(cfg, data, theta, grid, trig)
    return bucket_adj_cuda(cfg, data, theta, grid, trig)


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


def points(cfg: BucketConfig, voxels: int, angles: int) -> int:
    """Point projections of one forward or adjoint: one per voxel, angle
    and offset (and, in the forward, as many float2 atomics)."""
    return voxels * angles * cfg.precision**3


def roofline(cfg: BucketConfig, voxels: int, angles: int, grid: bool = False) -> dict:
    """The least time the H100 could take for one forward or adjoint: the
    larger of the bytes (the volume read or written once, 8 bytes a voxel;
    the planes written or read once, 8 bytes a cell; the grid's 12 bytes a
    voxel where one is given; the table) at 3.35 TB/s and the operations
    (:data:`POINT_FLOPS` a point) at 67 TFLOP/s."""
    nbytes = 8 * voxels + 8 * angles * cfg.n**2 + 4 * TABLE_WIDTH * angles
    if grid:
        nbytes += 12 * voxels
    flops = POINT_FLOPS * points(cfg, voxels, angles)
    bytes_ms, flops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOPS_PER_S
    return dict(
        bound_bytes=nbytes,
        bound_flops=flops,
        bound_ms=max(bytes_ms, flops_ms),
        bound_by="bytes" if bytes_ms >= flops_ms else "operations",
        points=points(cfg, voxels, angles),
    )
