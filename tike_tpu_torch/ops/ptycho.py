"""The ptychography forward model and its adjoint (PyTorch).

Counterpart of :mod:`tike_tpu.ops.ptycho`, with the same array layouts:

- psi : (D, H, W) complex64 object transmission, D slices;
- scan : (B, 2) float32 (y, x) min-corner probe positions;
- probe : (B or 1, M, P, P) complex64, M incoherent modes;
- farplane : (B, M, DET, DET) complex64;
- data : (B, DET, DET) float32 measured intensities.

The exit wave is zero-padded (never cropped) from P up to the detector
width DET before the far-field FFT. With D > 1 slices the probe passes
through each slice in turn and is carried to the next one by Fresnel
propagation at P x P (``multislice_fwd``), as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import objective
from .patch import patch_adj, patch_fwd
from .propagation import (
    cached_propagator,
    fresnel_adj,
    fresnel_fwd,
    propagation_adj,
    propagation_fwd,
)


@dataclasses.dataclass(frozen=True)
class PtychoConfig:
    """Static configuration of the ptychography forward model."""

    probe_shape: int
    detector_shape: int
    nz: int
    n: int
    nslices: int = 1
    probe_wavelength: float = 1e-9
    probe_FOV_lengths: tuple = (1e-6, 1e-6)
    multislice_propagation_distance: float = 1e-6

    def __post_init__(self):
        if self.detector_shape < self.probe_shape:
            raise ValueError(
                f"detector_shape ({self.detector_shape}) must be >= "
                f"probe_shape ({self.probe_shape}); the exit wave is "
                "zero-padded (never cropped) up to the detector."
            )

    @property
    def pad(self) -> int:
        return (self.detector_shape - self.probe_shape) // 2

    def propagator(self, device) -> torch.Tensor | None:
        """The inter-slice Fresnel transfer function on ``device`` (built
        once per geometry and device), or None for one slice."""
        if self.nslices == 1:
            return None
        return cached_propagator(
            (self.probe_shape, self.probe_shape),
            tuple(self.probe_FOV_lengths),
            self.multislice_propagation_distance,
            self.probe_wavelength,
            torch.device(device),
        )


def _pad_to_detector(nearplane: torch.Tensor, cfg: PtychoConfig):
    p = cfg.pad
    extra = cfg.detector_shape - cfg.probe_shape - p
    if p == 0 and extra == 0:
        return nearplane
    return F.pad(nearplane, (p, extra, p, extra))


def _crop_from_detector(farplane: torch.Tensor, cfg: PtychoConfig):
    p = cfg.pad
    if p == 0 and cfg.detector_shape == cfg.probe_shape:
        return farplane
    end = p + cfg.probe_shape
    return farplane[..., p:end, p:end]


def multislice_fwd(
    cfg: PtychoConfig,
    psi: torch.Tensor,
    scan: torch.Tensor,
    probe: torch.Tensor,
):
    """Propagate the probe through all object slices.

    Returns ``(exitwave (B, M, P, P), slice_probes (D, B, M, P, P))``:
    ``slice_probes[t]`` is the illumination incident on slice t, which the
    solvers reuse. One slice gathers its windows once; D slices gather D
    times and Fresnel-propagate D - 1 times.
    """
    b = scan.shape[0]
    m = probe.shape[-3]
    p = cfg.probe_shape
    carry = probe.expand(b, m, p, p)
    prop = cfg.propagator(psi.device)
    probes = []
    for t in range(cfg.nslices):
        exitwave = patch_fwd(psi[t], scan, p)[:, None, :, :] * carry
        probes.append(carry)
        if t + 1 < cfg.nslices:
            carry = fresnel_fwd(exitwave, prop)
    return exitwave, torch.stack(probes) if cfg.nslices > 1 else probes[0][None]


def ptycho_fwd(
    cfg: PtychoConfig,
    psi: torch.Tensor,
    scan: torch.Tensor,
    probe: torch.Tensor,
) -> torch.Tensor:
    """Object interaction then far-field propagation.

    probe: (B or 1, M, P, P); returns farplane (B, M, DET, DET).
    """
    exitwave, _ = multislice_fwd(cfg, psi, scan, probe)
    return propagation_fwd(_pad_to_detector(exitwave, cfg))


def ptycho_fwd_with_probes(cfg, psi, scan, probe):
    """:func:`ptycho_fwd` that also returns the per-slice incident probes
    ``(D, B, M, P, P)`` for the solvers."""
    exitwave, slice_probes = multislice_fwd(cfg, psi, scan, probe)
    return propagation_fwd(_pad_to_detector(exitwave, cfg)), slice_probes


def intensity_from_farplane(farplane: torch.Tensor) -> torch.Tensor:
    """Detector intensity: sum of |farplane|^2 over all mode axes."""
    return torch.sum(
        (farplane * farplane.conj()).real,
        dim=tuple(range(1, farplane.dim() - 2)),
    )


def ptycho_adj(
    cfg: PtychoConfig,
    farplane: torch.Tensor,
    probe: torch.Tensor,
    scan: torch.Tensor,
    psi: torch.Tensor,
):
    """Adjoint of the linearized forward model.

    Returns ``(psi_adj (D, H, W), probe_adj (1 or B, M, P, P))``: the
    gradients with respect to the object (probe fixed) and to the probe
    (object fixed). With D > 1 slices the carried gradient is propagated
    back through the earlier slices and the object gradient is divided by
    D, as the JAX package (and the original tike) normalize it.
    """
    p = cfg.probe_shape
    shape = (cfg.nz, cfg.n)
    diff = _crop_from_detector(propagation_adj(farplane), cfg)  # (B, M, P, P)
    _, slice_probes = multislice_fwd(cfg, psi, scan, probe)
    prop = cfg.propagator(psi.device)
    psi_adj = []
    probe_g = diff
    for t in range(cfg.nslices - 1, -1, -1):
        if t < cfg.nslices - 1:
            probe_g = fresnel_adj(probe_g, prop)
        psi_adj.append(
            patch_adj(torch.sum(torch.conj(slice_probes[t]) * probe_g, dim=1), scan, shape)
        )
        probe_g = torch.conj(patch_fwd(psi[t], scan, p))[:, None] * probe_g
    psi_adj = torch.stack(psi_adj[::-1])
    if cfg.nslices > 1:
        psi_adj = psi_adj / cfg.nslices
    if probe.shape[0] == 1:
        probe_g = torch.sum(probe_g, dim=0, keepdim=True)
    return psi_adj, probe_g


def ptycho_cost(
    cfg: PtychoConfig,
    data: torch.Tensor,
    psi: torch.Tensor,
    scan: torch.Tensor,
    probe: torch.Tensor,
    model: str = "gaussian",
) -> torch.Tensor:
    """Mean noise-model cost of the forward model against ``data``."""
    intensity = intensity_from_farplane(ptycho_fwd(cfg, psi, scan, probe))
    return objective.COST[model](data, intensity)


def simulate_intensity(
    cfg: PtychoConfig,
    psi: torch.Tensor,
    scan: torch.Tensor,
    probe: torch.Tensor,
) -> torch.Tensor:
    """Simulate noise-free detector intensities (B, DET, DET)."""
    return intensity_from_farplane(ptycho_fwd(cfg, psi, scan, probe))
