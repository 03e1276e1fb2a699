"""Laminography operator: 3D USFFT onto tilted projection planes (PyTorch).

Counterpart of :mod:`tike_tpu.ops.lamino`. The forward transform maps a
cubic volume u (n,n,n) to complex projections (ntheta, n, n): the volume's
3D Fourier transform is evaluated on planes tilted by ``tilt`` and rotated
by each theta (Fourier slice theorem), then each plane is inverse 2D FFTed.
The non-uniform interpolation runs the KB kernels of ``csrc/usfft.cu`` on
CUDA tensors (:mod:`.usfft`); the FFTs are ``torch.fft`` (cuFFT on the
card).

The tilted planes' frequencies depend on the angles alone, so a caller
that transforms many volumes at one set of angles (a reconstruction)
builds a :class:`LaminoPlan` once and hands it to every function here as
``plan=``: the frequencies, the KB kernels' geometry plans and the
deapodization then stay on the device between calls. Without one, each
call builds what it needs.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .. import linalg
from .usfft import _parameters, deapodization, eq2us, gather_tile, kb_plan, spread, us2eq


@dataclasses.dataclass(frozen=True)
class LaminoConfig:
    """Static configuration of the laminography operator."""

    n: int
    tilt: float
    eps: float = 1e-3
    upsample: float = 1.0
    # Spreading window: "kb" (Kaiser-Bessel) or "gaussian" (the reference's
    # window, kept as a cross-check).
    kernel: str = "kb"


def _trig32(angle: torch.Tensor):
    """(cos, sin) of float32 angles, each the float32 nearest the true
    value: computed in float64 and rounded, so the CPU and the card give
    the same bits. ``tike_tpu``'s float32 trig agrees on all but a few
    angles, by one ulp (``tests/test_torch_lamino.py`` counts them)."""
    a = angle.to(torch.float64)
    return torch.cos(a).to(torch.float32), torch.sin(a).to(torch.float32)


def make_grids(theta: torch.Tensor, n: int, tilt: float) -> torch.Tensor:
    """Return (ntheta * n * n, 3) tilted-plane frequencies for the USFFT.

    For each rotation theta, an (n, n) grid of planar frequencies (ku, kv)
    in [-0.5, 0.5) maps to 3D as
    f = (kv sin(tilt), -ku sin(th) + kv cos(th) cos(tilt),
         ku cos(th) + kv sin(th) cos(tilt)),
    in float32 as ``tike_tpu`` computes it (float32 theta and tilt).
    """
    theta = theta.to(torch.float32)
    device = theta.device
    k = (torch.arange(n, device=device) - n // 2).to(torch.float32) / n
    ku = k[None, :]  # x varies along the last axis
    kv = k[:, None]
    ctilt, stilt = _trig32(torch.tensor(tilt, dtype=torch.float32, device=device))
    ctheta, stheta = _trig32(theta)
    ctheta = ctheta[:, None, None]
    stheta = stheta[:, None, None]
    f0 = (kv * stilt).expand(theta.shape[0], n, n)
    f1 = -ku * stheta + kv * ctheta * ctilt
    f2 = ku * ctheta + kv * stheta * ctilt
    return torch.stack([f0, f1, f2], dim=-1).reshape(-1, 3)


def _rows(theta, n: int, tilt: float):
    """The grids as (ntheta * n, n, 3) rows: each (theta, detector row)
    line of points shares its axis-0 frequency."""
    return make_grids(theta, n, tilt).reshape(theta.shape[0] * n, n, 3)


class LaminoPlan:
    """What the transforms of one geometry (``cfg``, ``theta``) share, each
    part built at its first use and kept on theta's device: the rows of
    frequencies at +x (forward, exact adjoint) and -x (:func:`lamino_adj`),
    the KB kernels' plans for them (on CUDA tensors with the KB window;
    ``None`` otherwise) and the deapodization array."""

    def __init__(self, cfg: LaminoConfig, theta: torch.Tensor):
        self.cfg = cfg
        self.theta = theta

    def _kb_plan(self, x, tile=None):
        if self.cfg.kernel != "kb" or not x.is_cuda:
            return None
        upsampled, _, m, beta = _parameters(
            self.cfg.n, self.cfg.eps, self.cfg.upsample, self.cfg.kernel
        )
        return kb_plan(x.reshape(-1, 3), upsampled, m, beta, tile)

    @functools.cached_property
    def rows(self):
        """(ntheta n, n, 3) frequencies at +x."""
        return _rows(self.theta, self.cfg.n, self.cfg.tilt)

    @functools.cached_property
    def rows_negated(self):
        return -self.rows

    @functools.cached_property
    def scatter(self):
        """The KB plan of the scatter at +x (:func:`lamino_adj_exact`)."""
        return self._kb_plan(self.rows)

    @functools.cached_property
    def scatter_negated(self):
        """The KB plan of the scatter at -x (:func:`lamino_adj`)."""
        return self._kb_plan(self.rows_negated)

    @functools.cached_property
    def gather(self):
        """The KB plan of the gather at +x (:func:`lamino_fwd`): the
        scatter's where the gather takes bin order too."""
        _, _, m, _ = _parameters(self.cfg.n, self.cfg.eps, self.cfg.upsample, self.cfg.kernel)
        tile = gather_tile(m)
        return self.scatter if tile is None else self._kb_plan(self.rows, tile)

    @functools.cached_property
    def deapod(self):
        c = self.cfg
        return deapodization(c.n, c.eps, c.upsample, c.kernel, torch.float32, self.theta.device)


def _plan(plan, cfg: LaminoConfig, theta) -> LaminoPlan:
    """``plan`` if it is for this geometry, else a new one for the call."""
    if plan is None:
        return LaminoPlan(cfg, theta)
    if plan.cfg != cfg or plan.theta.shape != theta.shape:
        raise ValueError(
            f"the plan is for {plan.cfg} and {tuple(plan.theta.shape)} angles; "
            f"the call has {cfg} and {tuple(theta.shape)}"
        )
    return plan


def _centered_ifft2(F):
    """Zero-centered inverse 2D FFT (the reference's checkerboard pair)."""
    return torch.fft.fftshift(
        torch.fft.ifft2(torch.fft.ifftshift(F, dim=(-2, -1)), dim=(-2, -1)),
        dim=(-2, -1),
    )


def _centered_fft2(d):
    return torch.fft.fftshift(
        torch.fft.fft2(torch.fft.ifftshift(d, dim=(-2, -1)), dim=(-2, -1)),
        dim=(-2, -1),
    )


def lamino_fwd(cfg: LaminoConfig, u, theta, plan=None):
    """Forward laminography: volume (n,n,n) -> projections (ntheta, n, n)."""
    n = cfg.n
    plan = _plan(plan, cfg, theta)
    F = eq2us(u, plan.rows, n, cfg.eps, cfg.upsample, cfg.kernel, plan.gather, plan.deapod)
    return _centered_ifft2(F.reshape(theta.shape[0], n, n))


def lamino_adj(cfg: LaminoConfig, data, theta, plan=None):
    """Adjoint laminography as the reference computes it: us2eq at the
    negated frequencies, scaled by 1/n^2. About 20% off the true adjoint at
    ``upsample=1`` (Nyquist-row aliasing); see :func:`lamino_adj_exact`."""
    n = cfg.n
    plan = _plan(plan, cfg, theta)
    F = _centered_fft2(data).reshape(theta.shape[0] * n, n)
    u = us2eq(
        F, plan.rows_negated, n, cfg.eps, cfg.upsample, cfg.kernel,
        plan.scatter_negated, plan.deapod,
    )
    return u / n**2


def lamino_adj_exact(cfg: LaminoConfig, data, theta, plan=None):
    """The exact adjoint of :func:`lamino_fwd` (any eps/upsample): scatter
    at +xi, true inverse 3D FFT, crop, deapodize. CGLS requires it."""
    n = cfg.n
    plan = _plan(plan, cfg, theta)
    upsampled, pad, _, _ = _parameters(n, cfg.eps, cfg.upsample, cfg.kernel)
    # Adjoint of the trailing centered ifft2 (normalized 1/n^2): fft2 / n^2.
    F = _centered_fft2(data).reshape(theta.shape[0] * n, n) / (n * n)
    G = spread(F, plan.rows, n, cfg.eps, cfg.upsample, cfg.kernel, plan.scatter)
    # Adjoint of the centered unnormalized fftn: upsampled^3 * ifftn.
    fe = torch.fft.fftshift(torch.fft.ifftn(torch.fft.ifftshift(G))) * (upsampled**3)
    end = pad + n
    return fe[pad:end, pad:end, pad:end] / plan.deapod


def lamino_cost(cfg: LaminoConfig, data, theta, obj, plan=None):
    """Least-squares cost: a 0-d float32 tensor."""
    diff = lamino_fwd(cfg, obj, theta, plan) - data
    return torch.sum((diff * torch.conj(diff)).real)


def lamino_grad(cfg: LaminoConfig, data, theta, obj, plan=None):
    """Least-squares gradient through :func:`lamino_adj`."""
    plan = _plan(plan, cfg, theta)
    out = lamino_adj(cfg, lamino_fwd(cfg, obj, theta, plan) - data, theta, plan)
    return out / (data.shape[-3] * cfg.n**3)


def lamino_step_scale(cfg: LaminoConfig, obj, theta, plan=None):
    """CG step-length scale 2|A*A u| / |u|, a 0-d tensor."""
    plan = _plan(plan, cfg, theta)
    outnback = lamino_adj(cfg, lamino_fwd(cfg, obj, theta, plan), theta, plan)
    return 2 * linalg.norm(outnback) / (linalg.norm(obj) + 1e-32)
