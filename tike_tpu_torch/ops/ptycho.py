"""The single-slice ptychography forward model (PyTorch).

Counterpart of :mod:`tike_tpu.ops.ptycho`, with the same array layouts:

- psi : (D, H, W) complex64 object transmission (D = 1 slice here);
- scan : (B, 2) float32 (y, x) min-corner probe positions;
- probe : (B or 1, M, P, P) complex64, M incoherent modes;
- farplane : (B, M, DET, DET) complex64;
- data : (B, DET, DET) float32 measured intensities.

The exit wave is zero-padded (never cropped) from P up to the detector
width DET before the far-field FFT. Multislice objects are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import objective
from .patch import patch_fwd
from .propagation import propagation_fwd


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


def _require_single_slice(cfg: PtychoConfig) -> None:
    if cfg.nslices != 1:
        raise NotImplementedError(
            "multislice objects are not ported yet (nslices="
            f"{cfg.nslices})"
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


def ptycho_fwd(
    cfg: PtychoConfig,
    psi: torch.Tensor,
    scan: torch.Tensor,
    probe: torch.Tensor,
) -> torch.Tensor:
    """Object interaction then far-field propagation.

    probe: (B or 1, M, P, P); returns farplane (B, M, DET, DET).
    """
    _require_single_slice(cfg)
    patches = patch_fwd(psi[0], scan, cfg.probe_shape)
    exitwave = patches[:, None, :, :] * probe
    return propagation_fwd(_pad_to_detector(exitwave, cfg))


def intensity_from_farplane(farplane: torch.Tensor) -> torch.Tensor:
    """Detector intensity: sum of |farplane|^2 over all mode axes."""
    return torch.sum(
        (farplane * farplane.conj()).real,
        dim=tuple(range(1, farplane.dim() - 2)),
    )


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
