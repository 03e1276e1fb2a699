"""Unequally-spaced fast Fourier transforms (USFFT / NUFFT) in PyTorch.

Counterpart of :mod:`tike_tpu.ops.usfft`, with the same composition (zero
pad, deapodization, centred FFT, interpolation between the uniform grid and
the non-uniform points) and the same conventions: uniform grids are
zero-centred, non-uniform frequencies x lie about [-0.5, 0.5) and wrap
periodically outside it, and ``eq2us(f)(x) ~ sum_k f[k] exp(-2 pi i x . k)``.

The interpolation has two windows, Kaiser-Bessel (``gather_kb``,
``scatter_kb``) and the original tike's Gaussian (``gather``, ``scatter``),
and each has two implementations:

- a plain PyTorch version (``gather_kb_plain``, ``scatter_kb_plain``,
  ``gather_gaussian_plain``, ``scatter_gaussian_plain``): the tap scans of
  ``tike_tpu``'s ``gather_kb``/``scatter_kb`` and ``gather``/``scatter``,
  one indexed gather (or ``index_add_``) of all points per 3-D tap (for
  the Gaussian, per row of 2m taps, added tap after tap);
- hand-written CUDA kernels, which read a geometry plan
  (:func:`geometry_plan`): the points sorted by the grid cell they fall in,
  with their axis weights in a table. Both windows are separable, so a
  table of per-axis factors holds either, and the plan's base cell puts
  each window's 2m taps where the kernels look for them. ``csrc/usfft.cu``
  (``gather_kb_cuda``, ``scatter_kb_cuda``) for the KB window: the gather
  walks the points in that order, the scatter gives each row of the grid one
  block; ``csrc/usfft_gaussian.cu`` (``gather_gaussian_cuda``,
  ``scatter_gaussian_cuda``) for the Gaussian: the gather gives each point a
  thread (m <= 2), a group of 2m lanes that load its rows of taps together
  (2m <= 32), or above that a group of 16 lanes with a slot of taps a lane;
  the scatter gives each block a band of :func:`band_rows` rows of one
  plane, whose warps add each point reaching it, loaded once, to their
  copies of the band in shared memory. The kernels take any grid the card's memory holds (a
  cell is a row ``c0 n + c1`` and a column, never a 32-bit flat index) and
  any half-support with 2m <= n. Both scatters add the points
  reaching a cell in an order the plan fixes, with no atomics, so two
  launches agree to the bit. ``tike_tpu`` has no Pallas kernel here: its tap scans and its
  ``gather_kb_rows``/``scatter_kb_rows`` (einsum chains over dense rows,
  shaped for the TPU's matrix unit) are XLA code, and the kernels replace
  them.

Each dispatching function takes the device of the tensors it is given:
CPU tensors take the plain version, CUDA tensors launch the kernel or
raise; nothing falls back to the plain version on the card. Each takes an
optional ``plan=``; without one it is built for the
call. A plan depends on the points and the window alone, so a caller whose
points stay (laminography) builds it once. The row-structured layout
(``(R, C, 3)`` points, ``gather_kb_rows``/``scatter_kb_rows``) is the flat
one reshaped.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from .. import kernels
from .patch import _on_cpu, _raise_on_error

LAUNCHES = {
    "usfft_gather_kb": 0, "usfft_scatter_kb": 0,
    "usfft_gather_gaussian": 0, "usfft_scatter_gaussian": 0,
}
"""How many times each CUDA kernel has been launched in this process, by
window. Incremented only by a successful launch; callers may reset them to
0."""

MAX_N = 32767
"""The largest grid a plan indexes: each point's row of cells ``c0 n + c1``
is an int32 and its column ``c2`` an int16. That grid is 2^45 cells, 281
TB of complex64: the card's memory ends far below it."""

# csrc/usfft_gaussian.cu's scatter: its warps, each with its copy of the
# band, the band's rows at m <= 2 and above, and the shared memory a block
# may use on sm_90 once it opts in.
_SCATTER_WARPS = 4
_BAND_ROWS_SMALL_M, _BAND_ROWS_LARGE_M = 4, 2
MAX_SHARED = 232448


def band_rows(m: int, n: int) -> int:
    """Rows along axis 1 of one plane that a block of the Gaussian scatter
    owns at half-support m on an n^3 grid, whole along axis 2
    (``csrc/usfft_gaussian.cu``'s ``band_height``): 4 up to m = 2, else 2,
    fewer while the warps' copies of the band pass ``MAX_SHARED``."""
    rows = _BAND_ROWS_SMALL_M if m <= 2 else _BAND_ROWS_LARGE_M
    while rows > 1 and _SCATTER_WARPS * rows * n * 8 > MAX_SHARED:
        rows -= 1
    return rows


def usfft_parameters(n: int, eps: float, upsample: float = 1):
    """Return (upsampled, pad, mu, m): grid size, padding, kernel params."""
    upsampled = 2 * int(upsample * n / 2)
    pad = (upsampled - n) // 2
    mu = -np.log(eps) / (2 * n**2)
    Te = 1 / np.pi * np.sqrt(-mu * np.log(eps) + (mu * n) ** 2 / 4)
    m = int(np.ceil(upsampled * Te))
    return upsampled, pad, float(mu), m


def _get_kernel(n: int, mu: float, dtype=torch.float32, device=None):
    """The separable Gaussian deapodization kernel."""
    pad = n // 2
    end = n - pad
    u = -mu * torch.arange(-pad, end, dtype=dtype, device=device) ** 2
    norm = u[None, None, :] + u[None, :, None] + u[:, None, None]
    return torch.exp(norm)


def checkerboard(array: torch.Tensor, axes=None, inverse: bool = False):
    """FFT shift for even-sized grids by sign flips."""
    axes = range(array.ndim) if axes is None else axes
    for i in axes:
        if array.shape[i] % 2 != 0:
            raise ValueError(
                "Can only use checkerboard algorithm for even dimensions. "
                f"This dimension is {array.shape[i]}."
            )
        n = array.shape[i]
        sign = 1 - 2 * (torch.arange(n, device=array.device) % 2)
        shape = [1] * array.ndim
        shape[i] = n
        array = array * sign.reshape(shape)
        if inverse:
            array = array * (1 - 2 * ((n // 2) % 2))
    return array


def kb_parameters(n: int, eps: float, upsample: float = 2):
    """Return (upsampled, pad, m, beta) for the Kaiser-Bessel kernel.

    Support is 2m points per axis; beta from Beatty's formula for the
    oversampling ratio sigma = upsampled / n. Below sigma = 1.25 the window
    is the minimal 2-point one (m = 1, beta = 2.0).
    """
    upsampled = 2 * int(upsample * n / 2)
    pad = (upsampled - n) // 2
    sigma = upsampled / n
    if sigma < 1.25:
        return upsampled, pad, 1, 2.0
    rate = np.pi * np.sqrt(1 - 1 / sigma)
    ns = int(np.ceil(-np.log(eps) / rate))
    ns = max(4, ns + (ns % 2))  # even so taps pair around floor(n x)
    m = ns // 2
    beta = np.pi * np.sqrt((ns / sigma) ** 2 * (sigma - 0.5) ** 2 - 0.8)
    return upsampled, pad, m, float(beta)


def _kb_deapod_axis(n: int, upsampled: int, m: int, beta: float):
    """Exact 1D deapodization: FT of the normalized KB window at k/N.

    Computed in float64 log-space on the host so sinh never overflows.
    """
    k = np.arange(n, dtype=np.float64) - n // 2
    t = beta**2 - (2 * np.pi * m * k / upsampled) ** 2
    st = np.sqrt(np.abs(t))
    with np.errstate(over="ignore"):
        body = np.where(
            t > 0,
            np.log(np.sinh(np.maximum(st, 1e-30)) / np.maximum(st, 1e-30)),
            np.log(np.maximum(np.abs(np.sinc(st / np.pi)), 1e-300)),
        )
    log_i0_beta = np.log(_i0e_host(beta)) + beta
    return (2 * m * np.exp(body - log_i0_beta)).astype(np.float64)


def _i0e_host(x):
    """Host-side exponentially-scaled I0 (float64), from the Abramowitz &
    Stegun 9.8.1/9.8.2 rational fits, accurate to ~2e-7."""
    x = np.abs(np.asarray(x, dtype=np.float64))
    small = x < 3.75
    ts = (x / 3.75) ** 2
    ps = 1.0 + ts * (
        3.5156229
        + ts
        * (
            3.0899424
            + ts * (1.2067492 + ts * (0.2659732 + ts * (0.0360768 + ts * 0.0045813)))
        )
    )
    tl = 3.75 / np.maximum(x, 3.75)
    pl = 0.39894228 + tl * (
        0.01328592
        + tl
        * (
            0.00225319
            + tl
            * (
                -0.00157565
                + tl
                * (
                    0.00916281
                    + tl
                    * (
                        -0.02057706
                        + tl * (0.02635537 + tl * (-0.01647633 + tl * 0.00392377))
                    )
                )
            )
        )
    )
    return np.where(small, ps * np.exp(-x), pl / np.sqrt(np.maximum(x, 1e-30)))


def _kb_get_kernel(n: int, upsampled: int, m: int, beta: float, dtype, device=None):
    """Separable 3D deapodization array for the KB window."""
    d = torch.as_tensor(
        _kb_deapod_axis(n, upsampled, m, beta), dtype=dtype, device=device
    )
    return d[:, None, None] * d[None, :, None] * d[None, None, :]


def _kb_axis_weights(x_axis, ell_axis, m: int, beta: float, n: int):
    """(..., 2m) normalized KB weights of one axis's taps ell + [1-m, m]."""
    offs = torch.arange(1 - m, m + 1, dtype=x_axis.dtype, device=x_axis.device)
    d = n * x_axis[..., None] - (ell_axis[..., None] + offs)
    s = torch.sqrt(torch.clamp(1.0 - (d / m) ** 2, min=0.0))
    # i0(beta*s)/i0(beta) without overflow: i0e ratios times exp(beta(s-1)).
    i0e_beta = torch.special.i0e(
        torch.tensor(beta, dtype=x_axis.dtype, device=x_axis.device)
    )
    return torch.special.i0e(beta * s) / i0e_beta * torch.exp(beta * (s - 1.0))


def _kb_axis_taps(x, n: int, m: int, beta: float):
    """Per axis a of the (N, 3) points: the (N, 2m) weights and wrapped
    grid indices ``(n//2 + ell + tap) % n`` of its taps."""
    ell = torch.floor(n * x)
    offs = torch.arange(1 - m, m + 1, device=x.device)
    taps = []
    for a in range(3):
        w = _kb_axis_weights(x[:, a], ell[:, a], m, beta, n)
        g = torch.remainder(n // 2 + ell[:, a, None].to(torch.int64) + offs, n)
        taps.append((w, g))
    return taps


def _tap_scan(x, n: int, m: int, beta: float):
    """Yield (weight, flat grid index) of each of the (2m)^3 taps of every
    point, axis 0 outermost, the weight (w0 w1) w2 as in ``tike_tpu``."""
    (w0, g0), (w1, g1), (w2, g2) = _kb_axis_taps(x, n, m, beta)
    for j0 in range(2 * m):
        for j1 in range(2 * m):
            w01 = w0[:, j0] * w1[:, j1]
            row = (g0[:, j0] * n + g1[:, j1]) * n
            for j2 in range(2 * m):
                yield w01 * w2[:, j2], row + g2[:, j2]


def gather_kb_plain(Fe, x, n: int, m: int, beta: float):
    """Plain ``gather_kb``: the tap scan of indexed gathers.

    Fe (n, n, n) complex64, x (N, 3) float32. Returns (N,) complex64.
    """
    Fe_flat = torch.view_as_real(Fe.contiguous()).reshape(-1, 2)
    acc = torch.zeros((x.shape[0], 2), dtype=Fe_flat.dtype, device=x.device)
    for w, flat in _tap_scan(x, n, m, beta):
        acc = acc + Fe_flat[flat] * w[:, None]
    return torch.view_as_complex(acc)


def scatter_kb_plain(f, x, n: int, m: int, beta: float):
    """Plain ``scatter_kb``: the tap scan of ``index_add_``s.

    f (N,) complex64, x (N, 3) float32. Returns (n, n, n) complex64.
    """
    f2 = torch.view_as_real(f.contiguous())
    G = torch.zeros((n * n * n, 2), dtype=f2.dtype, device=f.device)
    for w, flat in _tap_scan(x, n, m, beta):
        G.index_add_(0, flat, f2 * w[:, None])
    return torch.view_as_complex(G).reshape(n, n, n)


GATHER_TILE = (8, 8)
"""The tile of cells, on axes 1 and 2, that the gather's own plan sorts the
points by at m = 1 (see :func:`gather_tile`)."""

# How far a window's first tap lies below floor(n x) + 1 - m: the plan's base
# cell is (n // 2 + floor(n x) - shift) % n, and the kernels take the taps
# base + 1 - m ... base + m. The KB window's taps are floor(n x) + [1 - m, m],
# the Gaussian's floor(n x) + [-m, m - 1].
_SHIFT = {"kb": 0, "gaussian": 1}


@dataclasses.dataclass(frozen=True)
class GeometryPlan:
    """What a gather or scatter of ``csrc/usfft.cu`` (KB) or
    ``csrc/usfft_gaussian.cu`` (Gaussian) needs of its points, built once
    by :func:`geometry_plan` and read by the kernels.

    ``window`` is "kb" (Kaiser-Bessel) or "gaussian" and ``param`` its
    parameter (the KB window's beta, the Gaussian's mu). A point's base
    cell is ``(n // 2 + floor(n x) - shift) % n`` on each axis (shift 0 for
    KB, 1 for the Gaussian, so that the 2m taps are the cells base + 1 - m
    ... base + m); its bin is that cell linearised with axis 2 fastest, its
    row of bins ``c0 n + c1``. ``order`` (N,) int32 lists the points sorted
    by bin (or by ``tile``), ties in ascending point index; ``rows`` (N,)
    int32 and ``cols`` (N,) int16 are each sorted point's row of bins and
    column ``c2``, so that no index of a cell passes 32 bits (``bins``, the
    flat bin in int64, is derived from them); ``weights`` (3, 2m, N) float32
    holds each sorted point's axis weights (the point index last, so that a
    warp's loads of one tap are contiguous); a 3-D tap's weight is their
    product. ``row_start`` (n^2 + 1,) int32 is where each row of bins'
    points start in the sorted list: all that the scatters read of the
    sort. A plan sorted by tiles has no ``row_start`` and serves the gather
    alone. A Gaussian plan in bin order also holds ``blocks`` (B, 2) int32,
    the Gaussian scatter's blocks (:func:`_scatter_blocks`): (c0 n + c1,
    rows), rows c1 ... c1 + rows - 1 of plane c0, in the order they are
    launched.
    """

    n: int
    m: int
    param: float
    order: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    weights: torch.Tensor
    row_start: torch.Tensor | None = None
    tile: tuple | None = None
    window: str = "kb"
    blocks: torch.Tensor | None = None

    @property
    def npoints(self) -> int:
        return self.order.shape[0]

    @property
    def bins(self) -> torch.Tensor:
        """(N,) int64: each sorted point's bin, ``rows n + cols``."""
        return self.rows.to(torch.int64) * self.n + self.cols.to(torch.int64)

    @property
    def nbytes(self) -> int:
        """The bytes of the plan's tensors."""
        tensors = (self.order, self.rows, self.cols, self.weights, self.row_start, self.blocks)
        return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _check_window(n: int, m: int) -> None:
    if not (m >= 1 and 2 * m <= n):
        raise ValueError(f"the window needs m >= 1 and 2 m <= n; got m = {m}, n = {n}")


def gather_tile(m: int):
    """The order a gather's own plan takes: tiles of ``GATHER_TILE`` cells
    at m = 1, where neighbouring points of laminography's lines then store
    neighbouring outputs (a quarter faster at 256^3 / 128 angles on the
    H100); bin order above, where the (2m)^3 taps dominate and bin order
    packs them best (a tenth faster at m = 2)."""
    return GATHER_TILE if m == 1 else None


def _gaussian_axis_weights(x_axis, ell_axis, m: int, mu: float, n: int):
    """(..., 2m) factors ``exp(-pi^2 / mu d^2)`` of one axis's taps ell +
    [-m, m - 1], d = (ell + tap) / n - x in float32 as the plain version
    computes it; their product over the axes, times (pi / mu)^(3/2), is the
    Gaussian weight of a 3-D tap."""
    offs = torch.arange(-m, m, device=x_axis.device)
    idx = (ell_axis.to(torch.int64)[..., None] + offs).to(x_axis.dtype)
    d = idx / n - x_axis[..., None]
    return torch.exp(float(-np.pi**2 / mu) * d**2)


def geometry_plan(x, n: int, m: int, param: float, tile=None, window: str = "kb") -> GeometryPlan:
    """The geometry plan of the points x (N, 3) float32 on an n^3 grid with
    ``window``'s 2m taps, on x's device: "kb", the Kaiser-Bessel window of
    parameter beta, or "gaussian", the Gaussian of parameter mu, whose base
    cell lies one below the KB window's.

    Set-up, like an FFT plan: a stable sort of the points by bin (an int64
    key), a count of each row of bins (n^2 of them, never the n^3 cells),
    and the axis weights (:func:`_kb_axis_weights`, so the KB kernels blend
    with the plain version's weights, and ``n x`` and its floor round as
    they do there; :func:`_gaussian_axis_weights`, the constant (pi /
    mu)^(3/2) folded into axis 0's). Plain PyTorch calls on either device.
    With ``tile = (t1, t2)`` the points are sorted by the t1 x t2 tile of
    cells (axes 1 and 2) their base cell lies in, and no rows are counted: a
    plan for the gather alone.
    """
    _check_window(n, m)
    if window not in _SHIFT:
        raise ValueError(f"window must be 'kb' or 'gaussian'; got {window!r}")
    if x.ndim != 2 or x.shape[1] != 3 or x.dtype != torch.float32:
        raise ValueError(f"x must be (N, 3) float32; got {x.dtype} {tuple(x.shape)}")
    if n > MAX_N or x.shape[0] >= 2**31:
        raise ValueError(
            f"a plan indexes rows of cells in int32, columns in int16 and points in int32: "
            f"n <= {MAX_N} and N < 2^31; got n = {n}, N = {x.shape[0]}"
        )
    cell = torch.remainder(n // 2 - _SHIFT[window] + torch.floor(n * x).to(torch.int64), n)
    row = cell[:, 0] * n + cell[:, 1]
    row_start = None
    if tile is None:
        order = torch.sort(row * n + cell[:, 2], stable=True)[1]
    else:
        key = (cell[:, 0] * n + cell[:, 1] // tile[0]) * n + cell[:, 2] // tile[1]
        order = torch.sort(key, stable=True)[1]
    rows = row[order]
    cols = cell[order, 2]
    del cell, row
    if tile is None:
        row_start = torch.zeros(n * n + 1, dtype=torch.int32, device=x.device)
        row_start[1:] = torch.cumsum(torch.bincount(rows, minlength=n * n), 0)
    xs = x[order]
    axis_weights = _kb_axis_weights if window == "kb" else _gaussian_axis_weights
    weights = torch.stack(
        [axis_weights(xs[:, a], torch.floor(n * xs[:, a]), m, param, n).T for a in range(3)]
    )
    if window == "gaussian":
        weights[0] *= float(np.sqrt(np.pi / param) ** 3)
    blocks = None
    if window == "gaussian" and tile is None:
        blocks = _scatter_blocks(row_start, n, m)
    return GeometryPlan(
        n=n, m=m, param=float(param), order=order.to(torch.int32), rows=rows.to(torch.int32),
        cols=cols.to(torch.int16), weights=weights.contiguous(), row_start=row_start,
        tile=None if tile is None else tuple(tile), window=window, blocks=blocks,
    )


def _scatter_blocks(row_start, n: int, m: int, rows: int | None = None,
                    busiest_first: bool = True) -> torch.Tensor:
    """The Gaussian scatter's blocks, each plane in bands of ``rows`` rows
    (:func:`band_rows` unless given; fewer in its last), as (c0 n + c1,
    rows) int32 pairs, from the plan's ``row_start``. With
    ``busiest_first``, by the points in the 2m x (rows + 2m - 1) rows of
    bins that reach them, most first (ties in ascending c0 n + c1): the
    order they are launched in, so that the busiest bands, near
    laminography's rotation axis, do not start last and end the launch
    alone; else in the grid's order."""
    band = band_rows(m, n) if rows is None else rows
    per_row = (row_start[1:] - row_start[:-1]).reshape(n, n).to(torch.int64)
    device = per_row.device
    starts = torch.arange(0, n, band, device=device)
    rows = torch.clamp(n - starts, max=band)
    # Box sums on the torus: planes c0 - m ... c0 + m - 1, rows c1 - m ...
    # c1 + rows + m - 2.
    planes = sum(torch.roll(per_row, -d, dims=0) for d in range(-m, m))
    wide = torch.cat([planes] * (2 + (band + 2 * m) // n), dim=1)
    sums = torch.cumsum(torch.cat([torch.zeros_like(wide[:, :1]), wide], dim=1), dim=1)
    first = (starts - m) % n
    points = (sums[:, first + rows + 2 * m - 1] - sums[:, first]).reshape(-1)
    blocks = torch.stack([(torch.arange(n, device=device)[:, None] * n + starts).reshape(-1),
                          rows.repeat(n)], dim=1)
    if busiest_first:
        blocks = blocks[torch.sort(points, descending=True, stable=True)[1]]
    return blocks.to(torch.int32).contiguous()


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, not on {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape {tuple(shape)}; "
            f"got {t.dtype} {tuple(t.shape)} (contiguous={t.is_contiguous()})"
        )
    if t.data_ptr() % 8:
        raise ValueError(f"{name} must be 8-byte aligned")


def _plan_for(plan, x, n: int, m: int, param: float, window: str, tile=None, build=True):
    """``plan`` checked against the call it is given to, or (with
    ``build``) a new one of ``window``, sorted by ``tile``."""
    if plan is None:
        return geometry_plan(x, n, m, param, tile, window) if build else None
    if (plan.window, plan.n, plan.m, plan.param, plan.npoints) != (
        window, n, m, float(param), x.shape[0]
    ):
        raise ValueError(
            f"the plan is for the {plan.window} window, n = {plan.n}, m = {plan.m}, "
            f"parameter {plan.param}, {plan.npoints} points; the call has the {window} "
            f"window, n = {n}, m = {m}, parameter {param}, {x.shape[0]} points"
        )
    if plan.order.device != x.device:
        raise ValueError(f"the plan is on {plan.order.device}, x on {x.device}")
    return plan


def _gather_cuda(Fe, x, n: int, m: int, param: float, plan):
    """The KB gather kernel of ``csrc/usfft.cu`` on ``plan``."""
    _check_window(n, m)
    npoints = x.shape[0]
    _check("Fe", Fe, torch.complex64, (n, n, n))
    _check("x", x, torch.float32, (npoints, 3))
    if Fe.device != x.device:
        raise ValueError(f"Fe is on {Fe.device}, x on {x.device}")
    plan = _plan_for(plan, x, n, m, param, "kb", gather_tile(m))
    out = torch.empty(npoints, dtype=torch.complex64, device=x.device)
    lib = kernels.load("usfft")
    with torch.cuda.device(x.device):
        rc = lib.tike_kb_gather(
            Fe.data_ptr(), plan.rows.data_ptr(), plan.cols.data_ptr(), plan.order.data_ptr(),
            plan.weights.data_ptr(), out.data_ptr(), npoints, n, m,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error("kb_gather", rc)
    if npoints:
        LAUNCHES["usfft_gather_kb"] += 1
    return out


def _scatter_cuda(f, x, n: int, m: int, param: float, plan):
    """The KB scatter kernel of ``csrc/usfft.cu`` on ``plan``."""
    _check_window(n, m)
    npoints = x.shape[0]
    _check("f", f, torch.complex64, (npoints,))
    _check("x", x, torch.float32, (npoints, 3))
    if f.device != x.device:
        raise ValueError(f"f is on {f.device}, x on {x.device}")
    plan = _plan_for(plan, x, n, m, param, "kb")
    if plan.row_start is None:
        raise ValueError("the scatter needs a plan in bin order (tile=None)")
    G = torch.empty((n, n, n), dtype=torch.complex64, device=x.device)
    lib = kernels.load("usfft")
    with torch.cuda.device(x.device):
        rc = lib.tike_kb_scatter(
            f.data_ptr(), plan.cols.data_ptr(), plan.order.data_ptr(),
            plan.row_start.data_ptr(), plan.weights.data_ptr(), G.data_ptr(), npoints, n, m,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error("kb_scatter", rc)
    LAUNCHES["usfft_scatter_kb"] += 1
    return G


def gather_kb_cuda(Fe, x, n: int, m: int, beta: float, plan: GeometryPlan | None = None):
    """Launch the CUDA ``kb_gather`` kernel (``csrc/usfft.cu``) on the
    points of ``plan`` (built here from x if not given)."""
    return _gather_cuda(Fe, x, n, m, beta, plan)


def scatter_kb_cuda(f, x, n: int, m: int, beta: float, plan: GeometryPlan | None = None):
    """Launch the CUDA ``kb_scatter`` kernel (``csrc/usfft.cu``) on the
    points of ``plan`` (built here from x if not given).

    The kernel writes every value of a fresh grid once, each the sum of
    its points in the plan's order: two launches agree to the bit.
    """
    return _scatter_cuda(f, x, n, m, beta, plan)


def gather_kb(Fe, x, n: int, m: int, beta: float, plan: GeometryPlan | None = None):
    """KB-window interpolation of Fe (n,n,n) at frequencies x (N,3).
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    on ``plan`` (:func:`geometry_plan` of the same x and window) if given."""
    if _on_cpu(Fe, x):
        _plan_for(plan, x, n, m, beta, "kb", build=False)
        return gather_kb_plain(Fe, x, n, m, beta)
    return gather_kb_cuda(Fe, x, n, m, beta, plan)


def scatter_kb(f, x, n: int, m: int, beta: float, plan: GeometryPlan | None = None):
    """Adjoint of :func:`gather_kb`: spread f (N,) onto an (n,n,n) grid."""
    if _on_cpu(f, x):
        _plan_for(plan, x, n, m, beta, "kb", build=False)
        return scatter_kb_plain(f, x, n, m, beta)
    return scatter_kb_cuda(f, x, n, m, beta, plan)


def gather_kb_rows(Fe, x, n: int, m: int, beta: float, plan: GeometryPlan | None = None):
    """KB interpolation of Fe (n,n,n) at row-structured points x (R, C, 3).

    Returns (R, C). ``tike_tpu`` contracts dense rows on the matrix unit
    here; the port runs :func:`gather_kb` on the flattened points.
    """
    R, C, _ = x.shape
    return gather_kb(Fe, x.reshape(R * C, 3), n, m, beta, plan).reshape(R, C)


def scatter_kb_rows(f, x, n: int, m: int, beta: float, plan: GeometryPlan | None = None):
    """Adjoint of :func:`gather_kb_rows`: spread f (R, C) onto (n,n,n)."""
    R, C = f.shape
    return scatter_kb(f.reshape(R * C), x.reshape(R * C, 3), n, m, beta, plan)


def _tap_offsets(m: int, device=None):
    """All (2m)^3 integer offsets of the Gaussian kernel, ((2m)^3, 3)."""
    r = torch.arange(-m, m, device=device)
    i0, i1, i2 = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([i0.ravel(), i1.ravel(), i2.ravel()], dim=-1)


def _gaussian_rows(x, n: int, m: int, mu: float):
    """Yield, for each of the (2m)^2 rows of Gaussian taps (axis-0 tap
    outermost), the (N, 2m) weights and flat grid indices of its 2m taps
    along axis 2, each tap's as ``tike_tpu``'s tap scan computes it: the
    same three squared distances summed by one ``torch.sum``, from each
    axis's 2m taps formed once."""
    cons0 = float(np.sqrt(np.pi / mu) ** 3)
    cons1 = float(-np.pi**2 / mu)
    ell = torch.floor(n * x).to(torch.int64)
    idx = ell[:, :, None] + torch.arange(-m, m, device=x.device)  # (N, 3, 2m)
    sq = (idx.to(x.dtype) / n - x[:, :, None]) ** 2
    g = torch.remainder(n // 2 + idx, n)
    taps = 2 * m
    for j0 in range(taps):
        for j1 in range(taps):
            d = torch.stack([sq[:, 0, j0, None].expand(-1, taps),
                             sq[:, 1, j1, None].expand(-1, taps), sq[:, 2]], dim=-1)
            delta = torch.sum(d, dim=-1)
            row = (g[:, 0, j0] * n + g[:, 1, j1]) * n
            yield cons0 * torch.exp(cons1 * delta), row[:, None] + g[:, 2]


def gather_gaussian_plain(Fe, x, n: int, m: int, mu: float):
    """Plain ``gather``: the tap scan of ``tike_tpu``'s, each weight ``cons0
    exp(cons1 |d|^2)`` and each tap's values added to the sum in turn, the
    indexed gathers made a row of taps at a time.

    Fe (n, n, n) complex64, x (N, 3) float32. Returns (N,) complex64.
    """
    Fe_flat = torch.view_as_real(Fe.contiguous()).reshape(-1, 2)
    acc = torch.zeros((x.shape[0], 2), dtype=Fe_flat.dtype, device=x.device)
    for w, flat in _gaussian_rows(x, n, m, mu):
        terms = Fe_flat[flat] * w[..., None]
        for j2 in range(2 * m):
            acc = acc + terms[:, j2]
    return torch.view_as_complex(acc)


def scatter_gaussian_plain(f, x, n: int, m: int, mu: float):
    """Plain ``scatter``: the tap scan of ``index_add_``s, a row of taps to
    a call, tap after tap.

    f (N,) complex64, x (N, 3) float32. Returns (n, n, n) complex64.
    """
    f2 = torch.view_as_real(f.contiguous())
    G = torch.zeros((n * n * n, 2), dtype=f2.dtype, device=f.device)
    for w, flat in _gaussian_rows(x, n, m, mu):
        terms = f2[:, None, :] * w[..., None]  # (N, 2m, 2)
        G.index_add_(0, flat.T.reshape(-1), terms.transpose(0, 1).reshape(-1, 2))
    return torch.view_as_complex(G).reshape(n, n, n)


def gather_gaussian_cuda(Fe, x, n: int, m: int, mu: float, plan: GeometryPlan | None = None):
    """Launch the CUDA ``gaussian_gather`` kernel (``csrc/usfft_gaussian.cu``)
    on the points of a Gaussian ``plan`` (:func:`geometry_plan` with
    ``window="gaussian"``, in bin order or by tiles; built here from x if not
    given)."""
    _check_window(n, m)
    plan = _plan_for(plan, x, n, m, mu, "gaussian", build=False)
    npoints = x.shape[0]
    _check("Fe", Fe, torch.complex64, (n, n, n))
    _check("x", x, torch.float32, (npoints, 3))
    if Fe.device != x.device:
        raise ValueError(f"Fe is on {Fe.device}, x on {x.device}")
    if plan is None:
        plan = geometry_plan(x, n, m, mu, gather_tile(m), "gaussian")
    out = torch.empty(npoints, dtype=torch.complex64, device=x.device)
    lib = kernels.load("usfft_gaussian")
    with torch.cuda.device(x.device):
        rc = lib.tike_gaussian_gather(
            Fe.data_ptr(), plan.rows.data_ptr(), plan.cols.data_ptr(), plan.order.data_ptr(),
            plan.weights.data_ptr(), out.data_ptr(), npoints, n, m,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error("gaussian_gather", rc)
    if npoints:
        LAUNCHES["usfft_gather_gaussian"] += 1
    return out


def scatter_gaussian_cuda(f, x, n: int, m: int, mu: float, plan: GeometryPlan | None = None):
    """Launch the CUDA ``gaussian_scatter`` kernel (``csrc/usfft_gaussian.cu``)
    on the points of a Gaussian ``plan`` in bin order (built here from x if
    not given) by the plan's ``blocks``: every grid value written once, the
    sum of its points in an order that the plan fixes (its bands' heights,
    not their order), so two launches agree to the bit."""
    _check_window(n, m)
    plan = _plan_for(plan, x, n, m, mu, "gaussian", build=False)
    npoints = x.shape[0]
    _check("f", f, torch.complex64, (npoints,))
    _check("x", x, torch.float32, (npoints, 3))
    if f.device != x.device:
        raise ValueError(f"f is on {f.device}, x on {x.device}")
    if plan is None:
        plan = geometry_plan(x, n, m, mu, window="gaussian")
    if plan.row_start is None or plan.blocks is None:
        raise ValueError("the scatter needs a plan in bin order (tile=None) with its blocks")
    G = torch.empty((n, n, n), dtype=torch.complex64, device=x.device)
    lib = kernels.load("usfft_gaussian")
    with torch.cuda.device(x.device):
        rc = lib.tike_gaussian_scatter(
            f.data_ptr(), plan.cols.data_ptr(), plan.order.data_ptr(),
            plan.row_start.data_ptr(), plan.weights.data_ptr(), plan.blocks.data_ptr(),
            plan.blocks.shape[0], G.data_ptr(), npoints, n, m,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error("gaussian_scatter", rc)
    LAUNCHES["usfft_scatter_gaussian"] += 1
    return G


def gather(Fe, x, n: int, m: int, mu: float, plan: GeometryPlan | None = None):
    """Gaussian-window interpolation of Fe (n,n,n) at x (N,3) -> (N,).
    CPU tensors take the plain version; CUDA tensors launch the kernel, on
    ``plan`` (:func:`geometry_plan` of the same x and window) if given."""
    if _on_cpu(Fe, x):
        _plan_for(plan, x, n, m, mu, "gaussian", build=False)
        return gather_gaussian_plain(Fe, x, n, m, mu)
    return gather_gaussian_cuda(Fe, x, n, m, mu, plan)


def scatter(f, x, n: int, m: int, mu: float, plan: GeometryPlan | None = None):
    """Adjoint of :func:`gather`: spread f (N,) onto an (n,n,n) grid."""
    if _on_cpu(f, x):
        _plan_for(plan, x, n, m, mu, "gaussian", build=False)
        return scatter_gaussian_plain(f, x, n, m, mu)
    return scatter_gaussian_cuda(f, x, n, m, mu, plan)


# The names of the Gaussian-window gather and scatter in the numpy test
# oracles of the original tike.
def vector_gather(Fe, x, n: int, m: int, mu: float, plan: GeometryPlan | None = None):
    """:func:`gather`."""
    return gather(Fe, x, n, m, mu, plan)


def vector_scatter(f, x, n: int, m: int, mu: float, plan: GeometryPlan | None = None):
    """:func:`scatter`."""
    return scatter(f, x, n, m, mu, plan)


LEAN_CELLS = 2**30
"""Upsampled grids of this many cells (8 GiB of complex64) or more are
shifted and transformed in place (:func:`_shift`, :func:`_fftn`): at 1292^3
``torch.fft.fftn`` held four grids (the grid, its transform and cuFFT's work
area) on the H100, more than the card holds beside a reconstruction."""

_SLAB_CELLS = 2**27


def _shift(a):
    """``fftshift`` (which is ``ifftshift``) of an even-sided (u, u, u) grid;
    from ``LEAN_CELLS`` on in place, bit for bit: each of the four pairs of
    opposite octants swapped through a copy of one (an eighth of the grid)."""
    if a.numel() < LEAN_CELLS:
        return torch.fft.fftshift(a)
    h = a.shape[0] // 2
    low, high = slice(0, h), slice(h, None)
    for octant in itertools.product((low,), (low, high), (low, high)):
        opposite = tuple(high if half == low else low for half in octant)
        kept = a[octant].clone()
        a[octant] = a[opposite]
        a[opposite] = kept
    return a


def _fftn(a, inverse: bool = False):
    """``fftn`` (or ``ifftn``) of a (u, u, u) grid; from ``LEAN_CELLS`` on in
    place, an axis at a time on slabs of about ``_SLAB_CELLS`` cells (2-D
    transforms of planes along axes 1 and 2, then 1-D along axis 0), so that
    it holds one grid and a slab: the same transform, rounded in another
    order."""
    if a.numel() < LEAN_CELLS:
        return torch.fft.ifftn(a) if inverse else torch.fft.fftn(a)
    plane, line = (torch.fft.ifft2, torch.fft.ifft) if inverse else (torch.fft.fft2, torch.fft.fft)
    u = a.shape[0]
    step = max(1, _SLAB_CELLS // (u * u))
    for i in range(0, u, step):
        a[i:i + step] = plane(a[i:i + step], dim=(1, 2))
    for i in range(0, u, step):
        a[:, i:i + step] = line(a[:, i:i + step], dim=0)
    return a


def _parameters(n: int, eps: float, upsample: float, kernel: str):
    """(upsampled, pad, m, beta or mu) of a transform's window."""
    if kernel == "kb":
        return kb_parameters(n, eps, upsample)
    if kernel == "gaussian":
        upsampled, pad, mu, m = usfft_parameters(n, eps, upsample)
        return upsampled, pad, m, mu
    raise ValueError(f"kernel must be 'kb' or 'gaussian'; got {kernel!r}")


def deapodization(n: int, eps: float, upsample: float, kernel: str, dtype, device=None):
    """The (n, n, n) array a transform's uniform side is divided by."""
    upsampled, _, m, param = _parameters(n, eps, upsample, kernel)
    if kernel == "kb":
        return _kb_get_kernel(n, upsampled, m, param, dtype, device)
    return _get_kernel(n, param, dtype, device) * upsampled**3


def spread(f, x, n: int, eps: float, upsample: float = 1, kernel: str = "kb", plan=None):
    """f (N,) at x (N, 3), or f (R, C) at rows x (R, C, 3), spread onto the
    centred (upsampled,)^3 grid: the first step of :func:`us2eq`. ``plan``
    is the window's plan of x (:func:`geometry_plan`), if
    the caller keeps one."""
    upsampled, _, m, param = _parameters(n, eps, upsample, kernel)
    spread_with = scatter_kb if kernel == "kb" else scatter
    return spread_with(f.reshape(-1), x.reshape(-1, 3), upsampled, m, param, plan)


def eq2us(f, x, n: int, eps: float, upsample: float = 1, kernel: str = "kb",
          plan=None, deapod=None):
    """USFFT from an equally-spaced grid to an unequally-spaced grid.

    f (n,n,n) complex64; x (N,3), or row-structured (R, C, 3), float32.
    Returns (N,), or (R, C). ``kernel`` is "kb" (Kaiser-Bessel) or
    "gaussian" (the original tike's window). A caller that keeps them hands
    in the window's plan of x (:func:`geometry_plan`) and
    the :func:`deapodization` array.
    """
    upsampled, pad, m, param = _parameters(n, eps, upsample, kernel)
    end = pad + n
    if deapod is None:
        deapod = deapodization(n, eps, upsample, kernel, f.real.dtype, f.device)
    fe = torch.zeros((upsampled,) * 3, dtype=f.dtype, device=f.device)
    fe[pad:end, pad:end, pad:end] = f / deapod
    Fe = _shift(_fftn(_shift(fe)))
    gather_with = gather_kb if kernel == "kb" else gather
    return gather_with(Fe, x.reshape(-1, 3), upsampled, m, param, plan).reshape(x.shape[:-1])


def us2eq(f, x, n: int, eps: float, upsample: float = 1, kernel: str = "kb",
          plan=None, deapod=None):
    """USFFT from an unequally-spaced grid to an equally-spaced grid.

    f (N,) complex64 at x (N,3), or f (R, C) at row-structured x (R, C, 3).
    Returns (n, n, n). ``plan`` and ``deapod`` as in :func:`eq2us`.
    """
    _, pad, _, _ = _parameters(n, eps, upsample, kernel)
    F = _shift(_fftn(_shift(spread(f, x, n, eps, upsample, kernel, plan))))
    end = pad + n
    if deapod is None:
        deapod = deapodization(n, eps, upsample, kernel, f.real.dtype, f.device)
    return F[pad:end, pad:end, pad:end] / deapod


def touched_cells(x, n: int, m: int, window: str = "kb") -> int:
    """How many grid values the (2m)^3 taps of the points x (N, 3) touch
    with ``window``'s tap range: all that a gather must read. Counted on
    the points' device."""
    ell = torch.floor(n * x).to(torch.int64)
    offs = torch.arange(1 - m, m + 1, device=x.device) - _SHIFT[window]
    g0, g1, g2 = (torch.remainder(n // 2 + ell[:, a, None] + offs, n) for a in range(3))
    mask = torch.zeros(n * n * n, dtype=torch.bool, device=x.device)
    for j0 in range(2 * m):
        for j1 in range(2 * m):
            mask[((g0[:, j0] * n + g1[:, j1]) * n)[:, None] + g2] = True
    return int(mask.sum())


def roofline_bytes(name: str, npoints: int, n: int, grid_values: int | None = None) -> int:
    """The bytes a gather or scatter of either window must move at the least.

    ``usfft_gather_*``: the grid values its points touch (``grid_values``,
    from :func:`touched_cells`; at most the whole grid), 12 bytes of x and 8
    of output per point. ``usfft_scatter_*``: 8 bytes of input and 12 of x
    per point, and the whole n^3 complex64 grid written once.
    """
    per_point = 12 + 8
    if name in ("usfft_gather_kb", "usfft_gather_gaussian"):
        cells = n**3 if grid_values is None else grid_values
        return cells * 8 + npoints * per_point
    if name in ("usfft_scatter_kb", "usfft_scatter_gaussian"):
        return n**3 * 8 + npoints * per_point
    raise ValueError(f"no such kernel: {name!r}")


def flops(npoints: int, m: int) -> int:
    """The float32 operations of a KB gather or scatter: per point, 6m
    weights (about 20 operations each with the Bessel series) and, per 3-D
    tap, two products of weights and a complex times real multiply-add."""
    return npoints * (6 * m * 20 + (2 * m) ** 3 * 6)


def fp32_instructions(npoints: int, m: int) -> int:
    """The FP32 instructions a gather or scatter of a separable window must
    issue at the least, its axis weights given: per point, a sum over each
    of the (2m)^2 rows of taps of w2 times the complex value (two
    multiply-adds a tap), each row's sum folded in with w1 (two a row), and
    each plane's with w0 (two a plane); the scatter's adjoint takes the same
    steps backwards."""
    taps = 2 * m
    return npoints * 2 * (taps**3 + taps**2 + taps)
