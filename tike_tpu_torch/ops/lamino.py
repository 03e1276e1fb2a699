"""Laminography operator: 3D USFFT onto tilted projection planes (PyTorch).

Counterpart of :mod:`tike_tpu.ops.lamino`. The forward transform maps a
cubic volume u (n,n,n) to complex projections (ntheta, n, n): the volume's
3D Fourier transform is evaluated on planes tilted by ``tilt`` and rotated
by each theta (Fourier slice theorem), then each plane is inverse 2D FFTed.
The non-uniform interpolation runs hand-written kernels on CUDA tensors
with either window, Kaiser-Bessel (``csrc/usfft.cu``) or Gaussian
(``csrc/usfft_gaussian.cu``; :mod:`.usfft`); the FFTs are ``torch.fft``
(cuFFT on the card).

The tilted planes' frequencies depend on the angles alone, so a caller
that transforms many volumes at one set of angles (a reconstruction)
builds a :class:`LaminoPlan` once and hands it to every function here as
``plan=``: the frequencies, the kernels' geometry plans and the
deapodization then stay on the device between calls. Without one, each
call builds what it needs.

A :class:`MeshLaminoPlan` splits the angles over the shards of a mesh (the
JAX package's ``mesh=``, theta sharded): one :class:`LaminoPlan` a shard at
its angles, on its device. Given one, the forward joins the shards'
projections in mesh order, the adjoints sum the shards' volumes
(``parallel.all_reduce``) and the cost sums the shards' parts, so that the
gradient and the solvers above them run unchanged. On a mesh across
processes each process holds its own contiguous run of the angles and of
the projections (the original tike's ``MPIio_lamino``): the forward gives
this process's projections, and the sums take in every process's shards.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .. import linalg
from ..parallel import Mesh, all_reduce, batch_sharding, put_process_local
from ..parallel._mesh import gather_objects
from .usfft import (
    _parameters, deapodization, eq2us, gather_tile, geometry_plan, spread, us2eq,
)


@dataclasses.dataclass(frozen=True)
class LaminoConfig:
    """Static configuration of the laminography operator."""

    n: int
    tilt: float
    eps: float = 1e-3
    upsample: float = 1.0
    # Spreading window: "kb" (Kaiser-Bessel) or "gaussian" (the original
    # tike's window, which needs more taps at the same eps).
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
    the kernels' geometry plans for them in ``cfg.kernel``'s window (on
    CUDA tensors; ``None`` on the CPU, whose plain versions read none) and
    the deapodization array. ``LaminoPlan.built``
    counts the plans made, so that a caller can show it kept one."""

    built = 0

    def __init__(self, cfg: LaminoConfig, theta: torch.Tensor):
        LaminoPlan.built += 1
        self.cfg = cfg
        self.theta = theta

    def _geometry_plan(self, x, tile=None):
        """The geometry plan of the points x in the window of ``cfg``."""
        if not x.is_cuda:
            return None
        c = self.cfg
        upsampled, _, m, param = _parameters(c.n, c.eps, c.upsample, c.kernel)
        return geometry_plan(x.reshape(-1, 3), upsampled, m, param, tile, c.kernel)

    @functools.cached_property
    def rows(self):
        """(ntheta n, n, 3) frequencies at +x."""
        return _rows(self.theta, self.cfg.n, self.cfg.tilt)

    @functools.cached_property
    def rows_negated(self):
        return -self.rows

    @functools.cached_property
    def scatter(self):
        """The plan of the scatter at +x (:func:`lamino_adj_exact`)."""
        return self._geometry_plan(self.rows)

    @functools.cached_property
    def scatter_negated(self):
        """The plan of the scatter at -x (:func:`lamino_adj`)."""
        return self._geometry_plan(self.rows_negated)

    @functools.cached_property
    def gather(self):
        """The plan of the gather at +x (:func:`lamino_fwd`): the
        scatter's where the gather takes bin order too."""
        _, _, m, _ = _parameters(self.cfg.n, self.cfg.eps, self.cfg.upsample, self.cfg.kernel)
        tile = gather_tile(m)
        return self.scatter if tile is None else self._geometry_plan(self.rows, tile)

    @functools.cached_property
    def deapod(self):
        c = self.cfg
        return deapodization(c.n, c.eps, c.upsample, c.kernel, torch.float32, self.theta.device)


class MeshLaminoPlan:
    """The angles ``theta`` split over the shards of ``mesh`` in equal
    runs, in mesh order, with a :class:`LaminoPlan` of each shard's angles
    on its device. Results come back on theta's device. On a mesh across
    processes ``theta`` is this process's run of the angles (each process
    holds as many), split over its shards; ``angles`` counts them all."""

    def __init__(self, cfg: LaminoConfig, theta: torch.Tensor, mesh: Mesh):
        count = theta.shape[0]
        if mesh.process_count > 1:
            counts = gather_objects(int(count))
            if len(set(counts)) != 1:
                raise ValueError(
                    f"every process must hold as many angles; they hold {counts}"
                )
            count = sum(counts)
        if count % mesh.size:
            raise ValueError(
                f"the mesh's {mesh.size} shards must divide the {count} angles"
            )
        self.cfg, self.theta, self.mesh, self.angles = cfg, theta, mesh, count
        self.group = mesh.flat
        self.devices = mesh.local_devices
        self.plans = [
            LaminoPlan(cfg, t)
            for t in put_process_local(theta, batch_sharding(mesh), count)
        ]

    def fwd(self, u) -> torch.Tensor:
        """:func:`lamino_fwd` of each shard's angles, joined."""
        parts = [lamino_fwd(self.cfg, u.to(d), p.theta, p) for d, p in zip(self.devices, self.plans)]
        return torch.cat([x.to(self.theta.device) for x in parts])

    def _split(self, data):
        return zip(torch.split(data, len(self.plans[0].theta)), self.devices, self.plans)

    def adj(self, fn, data) -> torch.Tensor:
        """``fn`` (an adjoint) of each shard's projections, summed."""
        parts = [fn(self.cfg, x.to(d), p.theta, p) for x, d, p in self._split(data)]
        return all_reduce(parts, self.group)[0].to(self.theta.device)

    def sum_squares(self, data) -> torch.Tensor:
        """The sum of ``|data|^2`` over every shard's projections: each
        shard's part, the parts added in mesh order."""
        parts = [torch.sum((x * torch.conj(x)).real.to(d)) for x, d, _ in self._split(data)]
        return all_reduce(parts, self.group)[0].to(self.theta.device)


def _plan(plan, cfg: LaminoConfig, theta):
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
    if isinstance(plan, MeshLaminoPlan):
        return plan.fwd(u)
    F = eq2us(u, plan.rows, n, cfg.eps, cfg.upsample, cfg.kernel, plan.gather, plan.deapod)
    return _centered_ifft2(F.reshape(theta.shape[0], n, n))


def lamino_adj(cfg: LaminoConfig, data, theta, plan=None):
    """Adjoint laminography as the reference computes it: us2eq at the
    negated frequencies, scaled by 1/n^2. About 20% off the true adjoint at
    ``upsample=1`` (Nyquist-row aliasing); see :func:`lamino_adj_exact`."""
    n = cfg.n
    plan = _plan(plan, cfg, theta)
    if isinstance(plan, MeshLaminoPlan):
        return plan.adj(lamino_adj, data)
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
    if isinstance(plan, MeshLaminoPlan):
        return plan.adj(lamino_adj_exact, data)
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
    if isinstance(plan, MeshLaminoPlan):
        return plan.sum_squares(diff)
    return torch.sum((diff * torch.conj(diff)).real)


def lamino_grad(cfg: LaminoConfig, data, theta, obj, plan=None):
    """Least-squares gradient through :func:`lamino_adj`."""
    plan = _plan(plan, cfg, theta)
    out = lamino_adj(cfg, lamino_fwd(cfg, obj, theta, plan) - data, theta, plan)
    angles = plan.angles if isinstance(plan, MeshLaminoPlan) else data.shape[-3]
    return out / (angles * cfg.n**3)


def lamino_step_scale(cfg: LaminoConfig, obj, theta, plan=None):
    """CG step-length scale 2|A*A u| / |u|, a 0-d tensor."""
    plan = _plan(plan, cfg, theta)
    outnback = lamino_adj(cfg, lamino_fwd(cfg, obj, theta, plan), theta, plan)
    return 2 * linalg.norm(outnback) / (linalg.norm(obj) + 1e-32)
