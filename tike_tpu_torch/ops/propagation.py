"""Far-field and Fresnel-spectrum wave propagation (PyTorch).

Counterpart of :mod:`tike_tpu.ops.propagation`: the far field is an
ortho-normalized 2D FFT over the last two axes, and multislice objects
propagate the wave between slices by the Fresnel spectrum transfer function
H(Kx, Ky) (``fresnel_fwd``/``fresnel_adj``). Both run on cuFFT for CUDA
tensors; no hand-written kernel is involved.
"""

from __future__ import annotations

import functools
import math

import torch


def propagation_fwd(nearplane: torch.Tensor) -> torch.Tensor:
    """Far-field propagation: batched ortho 2D FFT of the last two axes."""
    return torch.fft.fft2(nearplane, dim=(-2, -1), norm="ortho")


def propagation_adj(farplane: torch.Tensor) -> torch.Tensor:
    """Adjoint far-field propagation: batched ortho 2D IFFT."""
    return torch.fft.ifft2(farplane, dim=(-2, -1), norm="ortho")


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _linspace_f32(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in float32, by its operations:
    ``start * (1 - s) + stop * s`` with ``s = arange(num - 1) / (num - 1)``,
    then ``stop`` appended."""
    if num == 1:
        return _f32([start], device)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / _f32(div, device)
    out = _f32(start, device) * (1 - step) + _f32(stop, device) * step
    return torch.cat([out, _f32([stop], device)])


def fresnel_spectrum_propagator(
    shape,
    probe_FOV=(1e-6, 1e-6),
    distance: float = 1e-6,
    wavelength: float = 1e-9,
    *,
    device,
) -> torch.Tensor:
    """The Fresnel spectrum transfer function H(Kx, Ky) on ``device``, which
    the caller names (a multislice path passes its object's device).

    H = exp(i d sqrt((2 pi / lambda)^2 - Kx^2 - Ky^2)), fftshifted so that
    it multiplies an unshifted FFT. Built with the JAX package's float32
    operations in its order (its linspace grid, the complex64 square root,
    the exponential, then the shift): the phase d sqrt(...) is hundreds to
    thousands of radians, so one float32 rounding of it is 1e-4 to 1e-3
    rad, and another order of operations would move H by that much.
    """
    n0, n1 = (int(s) for s in shape)
    xgrid = (0.5 + _linspace_f32(-0.5 * n1, 0.5 * n1 - 1, n1, device)) / n1
    ygrid = (0.5 + _linspace_f32(-0.5 * n0, 0.5 * n0 - 1, n0, device)) / n0
    kx = _f32(2 * math.pi * n1, device) * xgrid / _f32(probe_FOV[1], device)
    ky = _f32(2 * math.pi * n0, device) * ygrid / _f32(probe_FOV[0], device)
    Ky, Kx = torch.meshgrid(ky, kx, indexing="ij")
    k = _f32(2 * math.pi, device) / _f32(wavelength, device)
    arg = k * k - Kx * Kx - Ky * Ky
    # Evanescent waves (a negative argument) decay through the complex root.
    root = torch.sqrt(arg.to(torch.complex64))
    h = torch.exp((1j * _f32(distance, device)) * root)
    return torch.fft.fftshift(h).to(torch.complex64)


@functools.lru_cache(maxsize=16)
def cached_propagator(shape, probe_FOV, distance, wavelength, device) -> torch.Tensor:
    """:func:`fresnel_spectrum_propagator`, built once per geometry and
    device: every batch of a multislice epoch multiplies by the same H."""
    return fresnel_spectrum_propagator(
        shape, probe_FOV, distance, wavelength, device=device
    )


def fresnel_fwd(nearplane: torch.Tensor, propagator: torch.Tensor) -> torch.Tensor:
    """Short-range Fresnel propagation: IFFT(H * FFT(x)), ortho norm."""
    f = torch.fft.fft2(nearplane, dim=(-2, -1), norm="ortho")
    return torch.fft.ifft2(f * propagator, dim=(-2, -1), norm="ortho")


def fresnel_adj(farplane: torch.Tensor, propagator: torch.Tensor) -> torch.Tensor:
    """Adjoint Fresnel propagation: IFFT(conj(H) * FFT(x))."""
    f = torch.fft.fft2(farplane, dim=(-2, -1), norm="ortho")
    return torch.fft.ifft2(f * torch.conj(propagator), dim=(-2, -1), norm="ortho")
