"""Exitwave update options.

Counterpart of :class:`tike_tpu.ptycho.exitwave.ExitWaveOptions`. The
Poisson step-length solvers are not ported yet; ``Reconstruction`` raises
``NotImplementedError`` for the Poisson noise model.
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
