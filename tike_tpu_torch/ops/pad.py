"""Per-image padding and cropping at per-image corners.

Counterpart of :mod:`tike_tpu.ops.pad`, whose vmapped dynamic slices
become indexing here. As there, a corner is clamped so that the image
lies inside the frame (``lax.dynamic_update_slice``'s rule).
"""

from __future__ import annotations

import torch


def _windows(n, h, w, H, W, corner, device):
    """Index arrays of each image's (h, w) window in the (H, W) frames."""
    if corner is None:
        corner = torch.tensor([(H - h) // 2, (W - w) // 2], device=device).expand(n, 2)
    corner = torch.as_tensor(corner, device=device).to(torch.int64)
    r0 = corner[:, 0].clamp(0, H - h)
    c0 = corner[:, 1].clamp(0, W - w)
    rows = r0[:, None] + torch.arange(h, device=device)
    cols = c0[:, None] + torch.arange(w, device=device)
    images = torch.arange(n, device=device)
    return images[:, None, None], rows[:, :, None], cols[:, None, :]


def pad_fwd(unpadded: torch.Tensor, corner=None, padded_shape=None, cval=0.0) -> torch.Tensor:
    """Pad a stack of images (N, h, w) into (N, H, W) frames filled with
    ``cval``, each at its corner (N, 2), or centered when ``corner`` is
    None."""
    if padded_shape is None:
        padded_shape = unpadded.shape
    n, h, w = unpadded.shape
    H, W = (int(s) for s in padded_shape[-2:])
    out = torch.full((n, H, W), cval, dtype=unpadded.dtype, device=unpadded.device)
    out[_windows(n, h, w, H, W, corner, unpadded.device)] = unpadded
    return out


def pad_adj(padded: torch.Tensor, corner=None, unpadded_shape=None) -> torch.Tensor:
    """Crop each image's region back out (the adjoint of :func:`pad_fwd`)."""
    if unpadded_shape is None:
        unpadded_shape = padded.shape
    n, H, W = padded.shape
    h, w = (int(s) for s in unpadded_shape[-2:])
    return padded[_windows(n, h, w, H, W, corner, padded.device)]


pad_inv = pad_adj
