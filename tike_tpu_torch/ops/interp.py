"""Lanczos-windowed 2D resampling (remap) and its adjoint.

Counterpart of :mod:`tike_tpu.ops.interp`: each non-uniform point (y, x)
combines the (2m+1)^2 pixels around (floor(y), floor(x)) with 2-lobe
Lanczos weights L(y - row) L(x - col); in the forward a tap outside the
grid adds the constant ``cval`` times its weight, in the adjoint it is
dropped.

Both functions take a batch of images at once: images (I, H, W) (or one
(H, W) image) and points either (I, N, 2), one set per image as the flow
warp gives them, or (N, 2), one set every image shares, as the rotation
gives them. Values are complex64 or float32.

Each operator has two implementations:

- a plain PyTorch version (``remap_lanczos_fwd_plain``,
  ``remap_lanczos_adj_plain``): the JAX package's loop over the taps in its
  order, with its 1e-12 guards, a gather (or an ``index_add_``) per tap;
- hand-written CUDA kernels (``csrc/interp.cu``, ``remap_lanczos_fwd_cuda``,
  ``remap_lanczos_adj_cuda``), the counterparts of the original tike's
  ``interp.cu`` kernels, which the JAX package wrote as XLA code. They
  compute the window that half-width m reduces to (:func:`window`: every
  m >= 2 is m = 2's 4 x 4 taps), with weights from one sine pair an axis.

``remap_lanczos_fwd`` and ``remap_lanczos_adj`` dispatch on the device of
the tensors they are given: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import math
import typing

import torch

from .. import kernels

LAUNCHES = {"lanczos_fwd": 0, "lanczos_adj": 0}
"""How many times each CUDA kernel has been launched in this process.
Incremented only by a successful launch; callers may reset them to 0."""

HBM_BYTES_PER_S = 3.35e12
"""The H100's published HBM rate (SXM, 700 W)."""
FP32_PER_S = 132 * 128 * 1.98e9
"""float32 instructions a second on the H100's FP32 pipe (132 SMs, 128 a
clock, 1.98 GHz); each rounded operation is one instruction."""
AXIS_FP32 = 8
"""float32 operations of one axis's sine pair: the floor, the fraction, its
half, the sine and the cosine (each counted as one instruction, the least
it could take) and three products."""
TAP_FP32 = 3
"""float32 operations of one weight from its axis's sine pair: the
distance, its square and the quotient."""

_DTYPES = (torch.complex64, torch.float32)


def _lanczos_weight(d: torch.Tensor, nlobes: float = 2.0) -> torch.Tensor:
    """The 1-D Lanczos window, ``tike_tpu.ops.interp._lanczos_weight``."""
    pix = d * math.pi
    safe = torch.where(torch.abs(pix) < 1e-12, 1.0, pix)
    w = nlobes * torch.sin(safe) * torch.sin(safe / nlobes) / (safe * safe)
    w = torch.where(torch.abs(d) < 1e-12, 1.0, w)
    return torch.where(torch.abs(d) <= nlobes, w, 0.0)


def window(m: int) -> typing.Tuple[int, int]:
    """(K, lo): the kernels' window of half-width m, the K taps a side at
    offsets lo .. lo + K - 1 from floor(c). The 2-lobe window is 0 beyond
    |d| > 2, so every m >= 2 weighs only m = 2's offsets -1 .. 2 (the offset
    -2 is inside only at a fraction of 0, where its weight is 0)."""
    return (1, 0) if m == 0 else (3, -1) if m == 1 else (4, -1)


def _offsets(m: int):
    """The taps (di, dj) in the JAX package's order: rows outer."""
    return [(i, j) for i in range(-m, m + 1) for j in range(-m, m + 1)]


def _real_view(x: torch.Tensor) -> torch.Tensor:
    """(..., 2) float pairs of a complex tensor, (..., 1) of a real one."""
    return torch.view_as_real(x) if x.is_complex() else x[..., None]


def _batch(images_or_values: torch.Tensor, x: torch.Tensor, ndim: int):
    """Add the image axis where it is missing; return (batched, points
    (I or 1, N, 2), whether the input had no image axis)."""
    single = images_or_values.dim() == ndim
    batched = images_or_values[None] if single else images_or_values
    return batched, (x if x.dim() == 3 else x[None]), single


def _tap(x: torch.Tensor, center: torch.Tensor, di: int, dj: int, h: int, w: int):
    """One tap's weight, whether it lies inside the grid, and its flat
    index, clamped into the grid, for every point."""
    py, px = center[..., 0] + di, center[..., 1] + dj
    wgt = _lanczos_weight(x[..., 0] - py.to(x.dtype)) * _lanczos_weight(
        x[..., 1] - px.to(x.dtype)
    )
    inside = (py >= 0) & (py < h) & (px >= 0) & (px < w)
    flat = py.clamp(0, h - 1) * w + px.clamp(0, w - 1)
    return wgt, inside, flat


def remap_lanczos_fwd_plain(Fe: torch.Tensor, x: torch.Tensor, m: int, cval=0.0):
    """Plain PyTorch forward: Fe (H, W) or (I, H, W) sampled at x (N, 2) or
    (I, N, 2); returns (N,) or (I, N) of Fe's dtype."""
    F, X, single = _batch(Fe, x, 2)
    i, h, w = F.shape
    vals = _real_view(F).reshape(i, h * w, -1)
    nch = vals.shape[-1]
    cval = complex(cval)
    # Filled, not copied from the host, so a CUDA graph can capture it.
    cv = torch.cat(
        [torch.full((1,), v, dtype=vals.dtype, device=vals.device)
         for v in (cval.real, cval.imag)[:nch]]
    )
    center = torch.floor(X).to(torch.int64)
    n = X.shape[-2]
    acc = torch.zeros((i, n, nch), dtype=vals.dtype, device=vals.device)
    for di, dj in _offsets(m):
        wgt, inside, flat = _tap(X, center, di, dj, h, w)
        taps = torch.gather(vals, 1, flat.expand(i, n)[..., None].expand(i, n, nch))
        acc = acc + torch.where(inside[..., None], taps, cv) * wgt[..., None]
    out = torch.view_as_complex(acc) if Fe.is_complex() else acc[..., 0]
    return out[0] if single else out


def remap_lanczos_adj_plain(points: torch.Tensor, x: torch.Tensor, m: int, grid_shape):
    """Plain PyTorch adjoint: point values (N,) or (I, N) at x (N, 2) or
    (I, N, 2) spread onto (H, W) or (I, H, W) grids of their dtype."""
    V, X, single = _batch(points, x, 1)
    h, w = (int(s) for s in grid_shape)
    i, n = V.shape
    pv = _real_view(V)
    nch = pv.shape[-1]
    G = torch.zeros((i * h * w, nch), dtype=pv.dtype, device=pv.device)
    base = torch.arange(i, device=pv.device)[:, None] * (h * w)
    center = torch.floor(X).to(torch.int64)
    for di, dj in _offsets(m):
        wgt, inside, flat = _tap(X, center, di, dj, h, w)
        vals = torch.where(inside[..., None], pv * wgt[..., None], 0)
        G.index_add_(0, (flat + base).reshape(-1), vals.reshape(-1, nch))
    G = G.reshape(i, h, w, nch)
    out = torch.view_as_complex(G) if points.is_complex() else G[..., 0]
    return out[0] if single else out


def _check(name: str, t: torch.Tensor, ndims, device=None, dtypes=_DTYPES) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, not on {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, not on {device}")
    if t.dtype not in dtypes or t.dim() not in ndims or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {' or '.join(map(str, ndims))}-D tensor of "
            f"{' or '.join(map(str, dtypes))}; got {t.dtype} {tuple(t.shape)} "
            f"(contiguous={t.is_contiguous()})"
        )
    if t.data_ptr() % 8:
        raise ValueError(f"{name} must be 8-byte aligned")


def _check_points(x: torch.Tensor, images: int, device) -> typing.Tuple[int, int]:
    """Return (N, shared) for points (N, 2) or (images, N, 2)."""
    _check("points", x, (2, 3), device, (torch.float32,))
    if x.shape[-1] != 2 or (x.dim() == 3 and x.shape[0] != images):
        raise ValueError(
            f"points {tuple(x.shape)} must be (N, 2) or ({images}, N, 2)"
        )
    return x.shape[-2], int(x.dim() == 2)


def _check_m(m: int) -> int:
    m = int(m)
    if not 0 <= m < 2**29:
        raise ValueError(f"the kernels take 0 <= m < 2**29, not {m}")
    return m


def _raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def remap_lanczos_fwd_cuda(Fe: torch.Tensor, x: torch.Tensor, m: int, cval=0.0):
    """Launch ``csrc/interp.cu``'s forward kernel, one launch for every
    image."""
    _check("images", Fe, (2, 3))
    images = 1 if Fe.dim() == 2 else Fe.shape[0]
    n, shared = _check_points(x, images, Fe.device)
    m = _check_m(m)
    h, w = Fe.shape[-2:]
    out = torch.empty((images, n), dtype=Fe.dtype, device=Fe.device)
    cval = complex(cval)
    lib = kernels.load("interp")
    with torch.cuda.device(Fe.device):
        rc = lib.tike_lanczos_fwd(
            Fe.data_ptr(), x.data_ptr(), out.data_ptr(), images, n, h, w, m, shared,
            2 if Fe.is_complex() else 1, cval.real, cval.imag,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error("lanczos_fwd", rc)
    LAUNCHES["lanczos_fwd"] += 1
    return out[0] if Fe.dim() == 2 else out


FALLBACK_SLOTS = 256
"""``csrc/interp.cu``'s ``kFallbackSlots``: the int64 slots over which the
adjoint spreads its count of fallback warps."""
FALLBACK = kernels.CardCounter(FALLBACK_SLOTS)
"""The card's count of adjoint warps whose windows did not fit their
buffer."""


def fallback_warps(device) -> int:
    """Warps of the adjoint kernel on the card ``device`` that added tap by
    tap to the grid (their windows' box did not fit the warp's buffer) since
    the last :func:`reset_fallback_warps`, over all launches. Waits for the
    card."""
    return FALLBACK.read(device)


def reset_fallback_warps(device) -> None:
    """Set the card's count of :func:`fallback_warps` to 0."""
    FALLBACK.reset(device)


def remap_lanczos_adj_cuda(points: torch.Tensor, x: torch.Tensor, m: int, grid_shape):
    """Launch ``csrc/interp.cu``'s adjoint kernel (each warp's windows
    summed in shared memory, one atomic a touched cell) onto zeroed
    grids, one launch for every image. Its float atomics add in no fixed
    order, so the last bits vary from run to run."""
    _check("values", points, (1, 2))
    images = 1 if points.dim() == 1 else points.shape[0]
    n, shared = _check_points(x, images, points.device)
    if points.shape[-1] != n:
        raise ValueError(f"values {tuple(points.shape)} do not match {n} points")
    m = _check_m(m)
    h, w = (int(s) for s in grid_shape)
    grid = torch.zeros((images, h, w), dtype=points.dtype, device=points.device)
    counter = FALLBACK.tensor(points.device)
    lib = kernels.load("interp")
    with torch.cuda.device(points.device):
        rc = lib.tike_lanczos_adj(
            points.data_ptr(), x.data_ptr(), grid.data_ptr(), counter.data_ptr(), images, n,
            h, w, m, shared, 2 if points.is_complex() else 1,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error("lanczos_adj", rc)
    LAUNCHES["lanczos_adj"] += 1
    return grid[0] if points.dim() == 1 else grid


def remap_lanczos_fwd(Fe: torch.Tensor, x: torch.Tensor, m: int, cval=0.0):
    """Sample Fe (H, W) or (I, H, W) at points x (N, 2) or (I, N, 2) with
    Lanczos filtering; returns (N,) or (I, N). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if kernels.on_cpu(Fe, x):
        return remap_lanczos_fwd_plain(Fe, x, m, cval)
    return remap_lanczos_fwd_cuda(Fe, x, m, cval)


def remap_lanczos_adj(points: torch.Tensor, x: torch.Tensor, m: int, grid_shape):
    """Adjoint of :func:`remap_lanczos_fwd` (with cval 0): spread point
    values (N,) or (I, N) onto (H, W) or (I, H, W) grids. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if kernels.on_cpu(points, x):
        return remap_lanczos_adj_plain(points, x, m, grid_shape)
    return remap_lanczos_adj_cuda(points, x, m, grid_shape)


def roofline(kernel: str, images: int, npoints: int, h: int, w: int, m: int,
             complex_values: bool = True, shared_points: bool = False) -> dict:
    """The least time the H100 could take for one launch of ``kernel``
    (``lanczos_fwd`` or ``lanczos_adj``): the larger of the bytes (the
    images read or the grids written once, the values written or read once,
    the points read once) at 3.35 TB/s and the least float32 instructions on
    the FP32 pipe for the window half-width m reduces to (:func:`window`, K
    taps a side): one sine pair an axis (:data:`AXIS_FP32`) and K weights
    from it (:data:`TAP_FP32` each), and, the weights being separable, the
    taps summed row by row (forward: a row's sum of wx[j] v, then wy[i]
    times it; adjoint: wy[i] v once a row, then wx[j] times it a tap), one
    multiply(-add) a channel each: K^2 + K a channel."""
    item = 8 if complex_values else 4
    channels = 2 if complex_values else 1
    nbytes = (
        item * images * h * w
        + item * images * npoints
        + 8 * npoints * (1 if shared_points else images)
    )
    taps = window(m)[0]
    fp32 = images * npoints * (
        2 * (AXIS_FP32 + TAP_FP32 * taps) + (taps * taps + taps) * channels
    )
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * fp32 / FP32_PER_S
    return dict(
        bound_bytes=nbytes,
        bound_fp32=fp32,
        bound_bytes_ms=bytes_ms,
        bound_fp32_ms=ops_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )
