"""Rotation of 2D image stacks by Lanczos remap on a rotated grid.

Counterpart of :mod:`tike_tpu.ops.rotate`: one set of rotated points,
shared by every image, sampled with half-width m = 2; on CUDA tensors one
launch of ``csrc/interp.cu``'s kernel rotates the whole stack.
"""

from __future__ import annotations

import torch

from .interp import remap_lanczos_adj, remap_lanczos_fwd


def _rotated_grid(shape, angle, device, dtype=torch.float32) -> torch.Tensor:
    """The rotated sample coordinates (H*W, 2) about the frame's center."""
    h, w = shape[-2:]
    angle = torch.as_tensor(angle, dtype=dtype, device=device)
    cos, sin = torch.cos(angle), torch.sin(angle)
    shifti = (h - 1) / 2.0
    shiftj = (w - 1) / 2.0
    i, j = torch.meshgrid(
        torch.arange(h, dtype=dtype, device=device),
        torch.arange(w, dtype=dtype, device=device),
        indexing="ij",
    )
    i = i - shifti
    j = j - shiftj
    i1 = (cos * i + sin * j) + shifti
    j1 = (-sin * i + cos * j) + shiftj
    return torch.stack([i1.reshape(-1), j1.reshape(-1)], dim=-1)


def rotate_fwd(unrotated: torch.Tensor, angle, cval=0.0) -> torch.Tensor:
    """Rotate each image of (..., H, W) by ``angle`` radians."""
    if angle is None:
        return unrotated
    h, w = unrotated.shape[-2:]
    coords = _rotated_grid(unrotated.shape, angle, unrotated.device)
    out = remap_lanczos_fwd(unrotated.reshape(-1, h, w), coords, 2, cval)
    return out.reshape(unrotated.shape)


def rotate_adj(rotated: torch.Tensor, angle, cval=0.0) -> torch.Tensor:
    """Adjoint of :func:`rotate_fwd` (with cval 0)."""
    if angle is None:
        return rotated
    h, w = rotated.shape[-2:]
    coords = _rotated_grid(rotated.shape, angle, rotated.device)
    out = remap_lanczos_adj(rotated.reshape(-1, h * w), coords, 2, (h, w))
    return out.reshape(rotated.shape)


def rotate_inv(rotated: torch.Tensor, angle, cval=0.0) -> torch.Tensor:
    """Approximate inverse: rotate by the negated angle."""
    return rotate_fwd(rotated, None if angle is None else -angle, cval)
