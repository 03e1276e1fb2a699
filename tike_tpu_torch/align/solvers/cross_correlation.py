"""Subpixel phase cross-correlation image registration.

Counterpart of :mod:`tike_tpu.align.solvers.cross_correlation` (after
skimage's phase_cross_correlation and Guizar-Sicairos et al. 2008): the
coarse shift is the peak of the FFT cross-correlation, refined by a
matrix-multiply DFT upsampled around it. On CUDA tensors it runs on cuFFT
and cuBLAS; no hand-written kernel is involved.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...ops.shift import fftfreq
from ...precision import as_tensor, to_numpy
from ...ptycho.ptycho import _resolve_device


def _triangle(n: int, device) -> torch.Tensor:
    """1 - |x - 0.5| at the centers of n cells of [0, 1)."""
    x = torch.arange(n, dtype=torch.float32, device=device) / torch.tensor(
        float(n), device=device
    ) + 0.5 / n
    return 1 - torch.abs(x - 0.5)


def _area_overlap(shape, device) -> torch.Tensor:
    """Overlapping-area weight that prefers small shifts."""
    return _triangle(shape[-2], device)[:, None] * _triangle(shape[-1], device)[None, :]


def _upsampled_dft(data, ups: int, upsample_factor: int, axis_offsets):
    """Batched matrix-multiply DFT of ``data`` (I, H, W) on an ups x ups
    grid around ``axis_offsets`` (I, 2)."""
    im2pi = -2j * np.pi
    shape = data.shape
    device = data.device
    span = torch.arange(ups, device=device)
    kernel = (span - axis_offsets[:, 1:2])[:, :, None] * fftfreq(
        shape[2], upsample_factor, device=device
    )
    data = torch.einsum("ijk,ipk->ijp", torch.exp(im2pi * kernel), data)
    kernel = (span - axis_offsets[:, 0:1])[:, :, None] * fftfreq(
        shape[1], upsample_factor, device=device
    )
    return torch.einsum("ijk,ipk->ijp", torch.exp(im2pi * kernel), data)


def _peaks(A: torch.Tensor) -> torch.Tensor:
    """(row, column) of each image's first maximum, as float32 (I, 2)."""
    flat = torch.argmax(A.reshape(A.shape[0], -1), dim=1)
    w = A.shape[-1]
    return torch.stack([flat // w, flat % w], dim=-1).to(torch.float32)


def _shifts(original, unaligned, upsample_factor: int, space: str, reg_weight: float):
    if space == "fourier":
        src_freq, target_freq = unaligned, original
    elif space == "real":
        src_freq = torch.fft.fft2(unaligned)
        target_freq = torch.fft.fft2(original)
    else:
        raise ValueError(f"space must be 'fourier' or 'real' not '{space}'.")
    device = src_freq.device
    shape = src_freq.shape
    image_product = src_freq * target_freq.conj()
    cc = torch.fft.ifft2(image_product)
    A = torch.abs(cc)
    if reg_weight > 0:
        A = A + torch.fft.fftshift(_area_overlap(cc.shape, device)) * reg_weight
    shifts = _peaks(A)
    midpoints = torch.tensor([shape[1] // 2, shape[2] // 2], dtype=torch.float32, device=device)
    dims = torch.tensor([shape[1], shape[2]], dtype=torch.float32, device=device)
    shifts = torch.where(shifts > midpoints, shifts - dims, shifts)
    if upsample_factor > 1:
        shifts = torch.round(shifts * upsample_factor) / upsample_factor
        region = int(math.ceil(upsample_factor * 1.5))
        dftshift = float(np.fix(region / 2.0))
        normalization = src_freq[0].numel() * upsample_factor**2
        offset = dftshift - shifts * upsample_factor
        cc = _upsampled_dft(image_product.conj(), region, upsample_factor, offset).conj()
        cc = cc / normalization
        shifts = shifts + (_peaks(torch.abs(cc)) - dftshift) / upsample_factor
    return shifts


def cross_correlation(
    op,
    original,
    unaligned,
    upsample_factor=1,
    space="real",
    num_iter=None,
    reg_weight=1e-9,
    *,
    device="cuda",
    **kwargs,
):
    """Subpixel translation alignment by cross-correlation on ``device``.

    original, unaligned (N, H, W) complex arrays (or tensors). Returns
    {'shift': (N, 2) float32 numpy, the shift that maps original onto
    unaligned, 'cost': -1}.
    """
    device = _resolve_device(
        device,
        **{k: v for k, v in (("original", original), ("unaligned", unaligned))
           if isinstance(v, torch.Tensor)},
    )
    shifts = _shifts(
        as_tensor(original, torch.complex64, device),
        as_tensor(unaligned, torch.complex64, device),
        int(upsample_factor),
        str(space).lower(),
        float(reg_weight),
    )
    return {"shift": to_numpy(shifts).astype(np.float32), "cost": -1}
