"""Sub-pixel shift of image stacks by a Fourier phase ramp.

Counterpart of :mod:`tike_tpu.ops.shift`: a non-normalized FFT, the ramp
exp(-2 pi i (fy dy + fx dx)), and the inverse FFT, on cuFFT for CUDA
tensors.
"""

from __future__ import annotations

import math

import torch


def fftfreq(n: int, d: float = 1.0, *, dtype=torch.float32, device=None) -> torch.Tensor:
    """``jnp.fft.fftfreq(n, d)``: the signed integers over ``n d``, by a
    division (``torch.fft.fftfreq`` multiplies by the reciprocal, which
    rounds some of them otherwise)."""
    i = torch.arange(n, dtype=dtype, device=device)
    k = torch.remainder(i + n // 2, n) - n // 2
    return k / torch.tensor(d * n, dtype=dtype, device=device)


def shift_fwd(a: torch.Tensor, shift: torch.Tensor | None) -> torch.Tensor:
    """Shift the last two axes of ``a`` (..., H, W) complex by ``shift``
    (..., 2) float (dy, dx), broadcast against the leading axes."""
    if shift is None:
        return a
    f = torch.fft.fft2(a, dim=(-2, -1))
    fy = fftfreq(a.shape[-2], dtype=shift.dtype, device=a.device)
    fx = fftfreq(a.shape[-1], dtype=shift.dtype, device=a.device)
    ramp = torch.exp(
        -2j * math.pi
        * (
            fy[:, None] * shift[..., 0, None, None]
            + fx[None, :] * shift[..., 1, None, None]
        )
    )
    return torch.fft.ifft2(f * ramp, dim=(-2, -1))


def shift_adj(a: torch.Tensor, shift: torch.Tensor | None) -> torch.Tensor:
    """Adjoint (the inverse) shift: the negated shifts."""
    if shift is None:
        return a
    return shift_fwd(a, -shift)


shift_inv = shift_adj
