"""Exitwave update options and the Poisson step-length solvers.

Counterpart of :mod:`tike_tpu.ptycho.exitwave`: the measured-pixel mask
enters every sum as a multiplied weight, so shapes stay fixed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import numpy.typing as npt
import torch

from ..precision import as_tensor, to_numpy


@dataclasses.dataclass
class ExitWaveOptions:
    """Manage data and settings related to exitwave updates."""

    measured_pixels: npt.NDArray[np.bool_]
    """Boolean detector mask: True for good pixels, False for bad ones."""

    noise_model: str = "gaussian"
    """'gaussian' OR 'poisson' noise model for the exitwave updates."""

    step_length_weight: float = 0.5
    """Weighted-average weight between previous and current step length."""

    step_length_usemodes: str = "all_modes"
    """'dominant_mode' or 'all_modes' Poisson step-length strategy."""

    step_length_start: float = 0.5
    """Initialization for the iterative step-length solver."""

    unmeasured_pixels_scaling: float = 1.00
    """Scaling of unmeasured detector regions in the exitwave update."""

    propagation_normalization: str = "ortho"
    """FFT normalization of the forward model: ortho, forward, or backward."""

    def copy_to_device(self, device) -> "ExitWaveOptions":
        return dataclasses.replace(
            self,
            measured_pixels=as_tensor(self.measured_pixels, torch.bool, device),
        )

    def copy_to_host(self) -> "ExitWaveOptions":
        return dataclasses.replace(
            self,
            measured_pixels=to_numpy(self.measured_pixels).astype(bool),
        )

    def resample(self, factor: float) -> "ExitWaveOptions":
        """A host copy whose mask keeps the lowest frequencies of a
        detector ``factor`` times as wide (``crop_fourier_space``; for
        ``factor > 1`` it repeats rows, as the JAX package's does)."""
        mask = to_numpy(self.measured_pixels)
        return dataclasses.replace(
            self,
            measured_pixels=crop_fourier_space(mask, int(mask.shape[-1] * factor)),
        )


def poisson_steplength_all_modes(
    xi,
    abs2_Psi,
    I_e,
    I_m,
    measured_pixels,
    step_length,
    weight_avg,
    num_iter: int = 2,
):
    """Optimal Poisson step length, one per exitwave mode.

    xi (B, 1, 1, W, H); abs2_Psi (B, 1, M, W, H); I_m and I_e (B, W, H);
    measured_pixels (W, H) bool; step_length (B, 1, M, 1, 1).
    """
    mask = measured_pixels.to(xi.dtype)
    I_e = I_e[:, None, None, :, :]
    I_m = I_m[:, None, None, :, :]
    xi_abs_Psi2 = xi * abs2_Psi
    denom_final = torch.sum(xi * xi_abs_Psi2 * mask, dim=(-2, -1), keepdim=True)
    for _ in range(num_iter):
        xi_alpha_minus_one = xi * step_length - 1
        denom = abs2_Psi * torch.square(xi_alpha_minus_one) + I_e - abs2_Psi
        numer = torch.sum(
            xi_abs_Psi2 * (1 + (I_m * xi_alpha_minus_one) / denom) * mask,
            dim=(-2, -1),
            keepdim=True,
        )
        step_length = (
            step_length * (1 - weight_avg) + (numer / denom_final) * weight_avg
        )
    return step_length


def poisson_steplength_dominant_mode(
    xi,
    I_e,
    I_m,
    measured_pixels,
    step_length,
    weight_avg,
    num_iter: int = 2,
):
    """Optimal Poisson step length from the dominant mode only; shapes as
    :func:`poisson_steplength_all_modes`."""
    mask = measured_pixels.to(xi.dtype)
    I_e = I_e[:, None, None, :, :]
    I_m = I_m[:, None, None, :, :]
    sum_denom = torch.sum(torch.square(xi) * I_e * mask, dim=(-2, -1), keepdim=True)
    for _ in range(num_iter):
        numer = xi * (I_e - I_m / (1 - step_length * xi))
        numer_over_denom = (
            torch.sum(numer * mask, dim=(-2, -1), keepdim=True) / sum_denom
        )
        step_length = (
            (1 - weight_avg) * step_length + weight_avg * numer_over_denom
        )
    return step_length


def _fourier_rows(size: int, w: int) -> np.ndarray:
    """The indices of the w lowest frequencies of a length-``size`` axis
    with zero frequency in the corner."""
    half1 = w // 2
    half0 = w - half1
    return np.r_[0:half0, (size - half1) : size]


def crop_fourier_space(x, w: int):
    """Crop x assuming 2D frequency space with zero frequency in corner.

    ``x`` is a numpy array or a tensor (which stays on its device)."""
    assert x.shape[-2] == x.shape[-1], "Only works on square arrays right now."
    cols = _fourier_rows(x.shape[-1], w)
    rows = _fourier_rows(x.shape[-2], w)
    if isinstance(x, torch.Tensor):
        cols = torch.as_tensor(cols, device=x.device)
        rows = torch.as_tensor(rows, device=x.device)
    return x[..., rows, :][..., :, cols]
