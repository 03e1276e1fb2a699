"""Unequally-spaced fast Fourier transforms (USFFT / NUFFT) in PyTorch.

Counterpart of :mod:`tike_tpu.ops.usfft`, with the same composition (zero
pad, deapodization, centred FFT, interpolation between the uniform grid and
the non-uniform points) and the same conventions: uniform grids are
zero-centred, non-uniform frequencies x lie about [-0.5, 0.5) and wrap
periodically outside it, and ``eq2us(f)(x) ~ sum_k f[k] exp(-2 pi i x . k)``.

The Kaiser-Bessel interpolation has two implementations:

- a plain PyTorch version (``gather_kb_plain``, ``scatter_kb_plain``): the
  tap scan of ``tike_tpu``'s ``gather_kb``/``scatter_kb``, one indexed
  gather (or ``index_add_``) of all points per 3-D tap;
- hand-written CUDA kernels (``csrc/usfft.cu``, ``gather_kb_cuda``,
  ``scatter_kb_cuda``) that read a geometry plan (:func:`kb_plan`): the
  points sorted by the grid cell they fall in, with their axis weights in a
  table. The gather walks the points in that order; the scatter gives each
  row of the grid one block that adds the points reaching it in a fixed
  order, with no atomics, so two launches agree to the bit. ``tike_tpu`` has no
  Pallas kernel here: its ``gather_kb_rows``/``scatter_kb_rows`` are einsum
  chains over dense rows, shaped for the TPU's matrix unit, and the kernels
  replace them too.

``gather_kb`` and ``scatter_kb`` dispatch on the device of the tensors they
are given: CPU tensors take the plain version, CUDA tensors launch the
kernel or raise. Both take an optional ``plan=``; without one they build it
for the call. A plan depends on the points and the window alone, so a
caller whose points stay (laminography) builds it once. The row-structured
layout (``(R, C, 3)`` points, ``gather_kb_rows``/``scatter_kb_rows``) is the
flat one reshaped. The Gaussian window (``gather``/``scatter``) is the
reference's cross-check and stays plain PyTorch on every device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import kernels
from .patch import _on_cpu, _raise_on_error

LAUNCHES = {"usfft_gather_kb": 0, "usfft_scatter_kb": 0}
"""How many times each CUDA kernel has been launched in this process.
Incremented only by a successful launch; callers may reset them to 0."""

MAX_N = 1290
"""The largest grid the kernels take: they index its n^3 cells in int32."""


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


@dataclasses.dataclass(frozen=True)
class KBPlan:
    """What a KB gather or scatter needs of its points, built once by
    :func:`kb_plan` and read by the kernels of ``csrc/usfft.cu``.

    A point's bin is its base cell ``(n // 2 + floor(n x)) % n`` on each
    axis, linearised with axis 2 fastest. ``order`` (N,) int32 lists the
    points sorted by bin (or by ``tile``), ties in ascending point index;
    ``bins`` (N,) int32 is the bin of each sorted point; ``weights``
    (3, 2m, N) float32 holds each sorted point's axis weights (the point
    index last, so that a warp's loads of one tap are contiguous);
    ``bin_start`` (n^3 + 1,) int32 is where each bin's points start in the
    sorted list. A plan sorted by tiles has no ``bin_start`` and serves the
    gather alone.
    """

    n: int
    m: int
    beta: float
    order: torch.Tensor
    bins: torch.Tensor
    weights: torch.Tensor
    bin_start: torch.Tensor | None = None
    tile: tuple | None = None

    @property
    def npoints(self) -> int:
        return self.order.shape[0]

    @property
    def nbytes(self) -> int:
        """The bytes of the plan's tensors."""
        tensors = (self.order, self.bins, self.weights, self.bin_start)
        return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _check_window(n: int, m: int) -> None:
    if not (m >= 1 and 2 * m <= n <= MAX_N):
        raise ValueError(
            f"the KB window needs m >= 1 and 2 m <= n <= {MAX_N}; got m = {m}, n = {n}"
        )


def gather_tile(m: int):
    """The order a gather's own plan takes: tiles of ``GATHER_TILE`` cells
    at m = 1, where neighbouring points of laminography's lines then store
    neighbouring outputs (a quarter faster at 256^3 / 128 angles on the
    H100); bin order above, where the (2m)^3 taps dominate and bin order
    packs them best (a tenth faster at m = 2)."""
    return GATHER_TILE if m == 1 else None


def kb_plan(x, n: int, m: int, beta: float, tile=None) -> KBPlan:
    """The geometry plan of the points x (N, 3) float32 on an n^3 grid with
    the 2m-tap window of parameter beta, on x's device.

    Set-up, like an FFT plan: a stable sort of the points by bin, a count of
    each bin, and the axis weights of :func:`_kb_axis_weights` (so the
    kernels blend with the plain version's weights, and ``n x`` and its
    floor round as they do there). Plain PyTorch calls on either device.
    With ``tile = (t1, t2)`` the points are sorted by the t1 x t2 tile of
    cells (axes 1 and 2) their base cell lies in, and no bins are counted:
    a plan for the gather alone.
    """
    _check_window(n, m)
    if x.ndim != 2 or x.shape[1] != 3 or x.dtype != torch.float32:
        raise ValueError(f"x must be (N, 3) float32; got {x.dtype} {tuple(x.shape)}")
    cell = torch.remainder(n // 2 + torch.floor(n * x).to(torch.int64), n)
    bins = (cell[:, 0] * n + cell[:, 1]) * n + cell[:, 2]
    bin_start = None
    if tile is None:
        bins, order = torch.sort(bins, stable=True)
        bin_start = torch.zeros(n**3 + 1, dtype=torch.int32, device=x.device)
        bin_start[1:] = torch.cumsum(torch.bincount(bins, minlength=n**3), 0)
    else:
        key = (cell[:, 0] * n + cell[:, 1] // tile[0]) * n + cell[:, 2] // tile[1]
        order = torch.sort(key, stable=True)[1]
        bins = bins[order]
    xs = x[order]
    weights = torch.stack(
        [_kb_axis_weights(xs[:, a], torch.floor(n * xs[:, a]), m, beta, n).T for a in range(3)]
    )
    return KBPlan(
        n=n, m=m, beta=float(beta), order=order.to(torch.int32),
        bins=bins.to(torch.int32), weights=weights.contiguous(), bin_start=bin_start,
        tile=None if tile is None else tuple(tile),
    )


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


def _plan_for(plan, x, n: int, m: int, beta: float, tile=None, build=True):
    """``plan`` checked against the call it is given to, or (with
    ``build``) a new one, sorted by ``tile``."""
    if plan is None:
        return kb_plan(x, n, m, beta, tile) if build else None
    if (plan.n, plan.m, plan.beta, plan.npoints) != (n, m, float(beta), x.shape[0]):
        raise ValueError(
            f"the plan is for n = {plan.n}, m = {plan.m}, beta = {plan.beta}, "
            f"{plan.npoints} points; the call has n = {n}, m = {m}, beta = {beta}, "
            f"{x.shape[0]} points"
        )
    if plan.order.device != x.device:
        raise ValueError(f"the plan is on {plan.order.device}, x on {x.device}")
    return plan


def gather_kb_cuda(Fe, x, n: int, m: int, beta: float, plan: KBPlan | None = None):
    """Launch the CUDA ``kb_gather`` kernel (``csrc/usfft.cu``) on the
    points of ``plan`` (built here from x if not given)."""
    _check_window(n, m)
    npoints = x.shape[0]
    _check("Fe", Fe, torch.complex64, (n, n, n))
    _check("x", x, torch.float32, (npoints, 3))
    if Fe.device != x.device:
        raise ValueError(f"Fe is on {Fe.device}, x on {x.device}")
    plan = _plan_for(plan, x, n, m, beta, gather_tile(m))
    out = torch.empty(npoints, dtype=torch.complex64, device=x.device)
    lib = kernels.load("usfft")
    with torch.cuda.device(x.device):
        rc = lib.tike_kb_gather(
            Fe.data_ptr(), plan.bins.data_ptr(), plan.order.data_ptr(),
            plan.weights.data_ptr(), out.data_ptr(), npoints, n, m,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error("kb_gather", rc)
    if npoints:
        LAUNCHES["usfft_gather_kb"] += 1
    return out


def scatter_kb_cuda(f, x, n: int, m: int, beta: float, plan: KBPlan | None = None):
    """Launch the CUDA ``kb_scatter`` kernel (``csrc/usfft.cu``) on the
    points of ``plan`` (built here from x if not given).

    The kernel writes every value of a fresh grid once, each the sum of
    its points in the plan's order: two launches agree to the bit.
    """
    _check_window(n, m)
    npoints = x.shape[0]
    _check("f", f, torch.complex64, (npoints,))
    _check("x", x, torch.float32, (npoints, 3))
    if f.device != x.device:
        raise ValueError(f"f is on {f.device}, x on {x.device}")
    plan = _plan_for(plan, x, n, m, beta)
    if plan.bin_start is None:
        raise ValueError("the scatter needs a plan in bin order (kb_plan with tile=None)")
    G = torch.empty((n, n, n), dtype=torch.complex64, device=x.device)
    lib = kernels.load("usfft")
    with torch.cuda.device(x.device):
        rc = lib.tike_kb_scatter(
            f.data_ptr(), plan.bins.data_ptr(), plan.order.data_ptr(),
            plan.bin_start.data_ptr(), plan.weights.data_ptr(), G.data_ptr(), npoints, n, m,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error("kb_scatter", rc)
    LAUNCHES["usfft_scatter_kb"] += 1
    return G


def gather_kb(Fe, x, n: int, m: int, beta: float, plan: KBPlan | None = None):
    """KB-window interpolation of Fe (n,n,n) at frequencies x (N,3).
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    on ``plan`` (:func:`kb_plan` of the same x and window) if given."""
    if _on_cpu(Fe, x):
        _plan_for(plan, x, n, m, beta, build=False)
        return gather_kb_plain(Fe, x, n, m, beta)
    return gather_kb_cuda(Fe, x, n, m, beta, plan)


def scatter_kb(f, x, n: int, m: int, beta: float, plan: KBPlan | None = None):
    """Adjoint of :func:`gather_kb`: spread f (N,) onto an (n,n,n) grid."""
    if _on_cpu(f, x):
        _plan_for(plan, x, n, m, beta, build=False)
        return scatter_kb_plain(f, x, n, m, beta)
    return scatter_kb_cuda(f, x, n, m, beta, plan)


def gather_kb_rows(Fe, x, n: int, m: int, beta: float, plan: KBPlan | None = None):
    """KB interpolation of Fe (n,n,n) at row-structured points x (R, C, 3).

    Returns (R, C). ``tike_tpu`` contracts dense rows on the matrix unit
    here; the port runs :func:`gather_kb` on the flattened points.
    """
    R, C, _ = x.shape
    return gather_kb(Fe, x.reshape(R * C, 3), n, m, beta, plan).reshape(R, C)


def scatter_kb_rows(f, x, n: int, m: int, beta: float, plan: KBPlan | None = None):
    """Adjoint of :func:`gather_kb_rows`: spread f (R, C) onto (n,n,n)."""
    R, C = f.shape
    return scatter_kb(f.reshape(R * C), x.reshape(R * C, 3), n, m, beta, plan)


def _tap_offsets(m: int, device=None):
    """All (2m)^3 integer offsets of the Gaussian kernel, ((2m)^3, 3)."""
    r = torch.arange(-m, m, device=device)
    i0, i1, i2 = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([i0.ravel(), i1.ravel(), i2.ravel()], dim=-1)


def _gaussian_taps(x, n: int, m: int, mu: float):
    """Yield (weight, flat grid index) of each Gaussian tap of every point."""
    cons0 = float(np.sqrt(np.pi / mu) ** 3)
    cons1 = float(-np.pi**2 / mu)
    ell = torch.floor(n * x).to(torch.int64)
    for off in _tap_offsets(m, x.device):
        idx = ell + off[None, :]
        delta = torch.sum((idx.to(x.dtype) / n - x) ** 2, dim=-1)
        g = torch.remainder(n // 2 + idx, n)
        yield cons0 * torch.exp(cons1 * delta), (g[:, 0] * n + g[:, 1]) * n + g[:, 2]


def gather(Fe, x, n: int, m: int, mu: float):
    """Gaussian-window interpolation of Fe (n,n,n) at x (N,3) -> (N,)."""
    Fe_flat = torch.view_as_real(Fe.contiguous()).reshape(-1, 2)
    acc = torch.zeros((x.shape[0], 2), dtype=Fe_flat.dtype, device=x.device)
    for w, flat in _gaussian_taps(x, n, m, mu):
        acc = acc + Fe_flat[flat] * w[:, None]
    return torch.view_as_complex(acc)


def scatter(f, x, n: int, m: int, mu: float):
    """Adjoint of :func:`gather`: spread f (N,) onto an (n,n,n) grid."""
    f2 = torch.view_as_real(f.contiguous())
    G = torch.zeros((n * n * n, 2), dtype=f2.dtype, device=f.device)
    for w, flat in _gaussian_taps(x, n, m, mu):
        G.index_add_(0, flat, f2 * w[:, None])
    return torch.view_as_complex(G).reshape(n, n, n)


def _centered_fftn(x):
    return torch.fft.fftshift(torch.fft.fftn(torch.fft.ifftshift(x)))


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
    is the KB window's :func:`kb_plan` of x, if the caller keeps one."""
    upsampled, _, m, param = _parameters(n, eps, upsample, kernel)
    if kernel == "kb":
        return scatter_kb(f.reshape(-1), x.reshape(-1, 3), upsampled, m, param, plan)
    return scatter(f.reshape(-1), x.reshape(-1, 3), upsampled, m, param)


def eq2us(f, x, n: int, eps: float, upsample: float = 1, kernel: str = "kb",
          plan=None, deapod=None):
    """USFFT from an equally-spaced grid to an unequally-spaced grid.

    f (n,n,n) complex64; x (N,3), or row-structured (R, C, 3), float32.
    Returns (N,), or (R, C). ``kernel`` is "kb" (Kaiser-Bessel) or
    "gaussian" (the reference's window). A caller that keeps them hands in
    the :func:`kb_plan` of x and the :func:`deapodization` array.
    """
    upsampled, pad, m, param = _parameters(n, eps, upsample, kernel)
    end = pad + n
    if deapod is None:
        deapod = deapodization(n, eps, upsample, kernel, f.real.dtype, f.device)
    fe = torch.zeros((upsampled,) * 3, dtype=f.dtype, device=f.device)
    fe[pad:end, pad:end, pad:end] = f / deapod
    Fe = _centered_fftn(fe)
    if kernel == "kb":
        out = gather_kb(Fe, x.reshape(-1, 3), upsampled, m, param, plan)
    else:
        out = gather(Fe, x.reshape(-1, 3), upsampled, m, param)
    return out.reshape(x.shape[:-1])


def us2eq(f, x, n: int, eps: float, upsample: float = 1, kernel: str = "kb",
          plan=None, deapod=None):
    """USFFT from an unequally-spaced grid to an equally-spaced grid.

    f (N,) complex64 at x (N,3), or f (R, C) at row-structured x (R, C, 3).
    Returns (n, n, n). ``plan`` and ``deapod`` as in :func:`eq2us`.
    """
    _, pad, _, _ = _parameters(n, eps, upsample, kernel)
    F = _centered_fftn(spread(f, x, n, eps, upsample, kernel, plan))
    end = pad + n
    if deapod is None:
        deapod = deapodization(n, eps, upsample, kernel, f.real.dtype, f.device)
    return F[pad:end, pad:end, pad:end] / deapod


def touched_cells(x, n: int, m: int) -> int:
    """How many grid values the (2m)^3 taps of the points x (N, 3) touch:
    all that a gather must read. Counted on the points' device."""
    (_, g0), (_, g1), (_, g2) = _kb_axis_taps(x, n, m, 1.0)
    mask = torch.zeros(n * n * n, dtype=torch.bool, device=x.device)
    for j0 in range(2 * m):
        for j1 in range(2 * m):
            row = (g0[:, j0] * n + g1[:, j1]) * n
            for j2 in range(2 * m):
                mask[row + g2[:, j2]] = True
    return int(mask.sum())


def roofline_bytes(name: str, npoints: int, n: int, grid_values: int | None = None) -> int:
    """The bytes a KB gather or scatter must move at the least.

    ``usfft_gather_kb``: the grid values its points touch (``grid_values``,
    from :func:`touched_cells`; at most the whole grid), 12 bytes of x and 8
    of output per point. ``usfft_scatter_kb``: 8 bytes of input and 12 of x
    per point, and the whole n^3 complex64 grid written once.
    """
    per_point = 12 + 8
    if name == "usfft_gather_kb":
        cells = n**3 if grid_values is None else grid_values
        return cells * 8 + npoints * per_point
    if name == "usfft_scatter_kb":
        return n**3 * 8 + npoints * per_point
    raise ValueError(f"no such kernel: {name!r}")


def flops(npoints: int, m: int) -> int:
    """The float32 operations of a KB gather or scatter: per point, 6m
    weights (about 20 operations each with the Bessel series) and, per 3-D
    tap, two products of weights and a complex times real multiply-add."""
    return npoints * (6 * m * 20 + (2 * m) ** 3 * 6)
