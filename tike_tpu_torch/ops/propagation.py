"""Far-field wave propagation (PyTorch).

Counterpart of ``propagation_fwd``/``propagation_adj`` in
:mod:`tike_tpu.ops.propagation`: an ortho-normalized 2D FFT over the last
two axes, which runs on cuFFT for CUDA tensors. The Fresnel (multislice)
propagators are not ported yet.
"""

from __future__ import annotations

import torch


def propagation_fwd(nearplane: torch.Tensor) -> torch.Tensor:
    """Far-field propagation: batched ortho 2D FFT of the last two axes."""
    return torch.fft.fft2(nearplane, dim=(-2, -1), norm="ortho")


def propagation_adj(farplane: torch.Tensor) -> torch.Tensor:
    """Adjoint far-field propagation: batched ortho 2D IFFT."""
    return torch.fft.ifft2(farplane, dim=(-2, -1), norm="ortho")
