"""Gaussian and median filters, center of mass and integer shifts (PyTorch).

Counterpart of :mod:`tike_tpu.utils.ndimage`: the probe constraints'
replacements for ``scipy.ndimage``. Each works on the last two axes of a
tensor on any device and never reads a value back to the host.
"""

from __future__ import annotations

import numpy as np
import torch


def _gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = max(int(truncate * sigma + 0.5), 1)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _padded_index(n: int, r: int, mode: str, device) -> torch.Tensor:
    """Source index of each of the ``n + 2r`` padded positions: wrapped
    for ``wrap``, clamped to the edge for ``nearest``; out-of-range ones
    are -1 for ``constant``."""
    idx = torch.arange(-r, n + r, device=device)
    if mode == "wrap":
        return torch.remainder(idx, n)
    if mode == "nearest":
        return torch.clamp(idx, 0, n - 1)
    return torch.where((idx >= 0) & (idx < n), idx, -1)


def _pad_axis(x: torch.Tensor, axis: int, r: int, mode: str) -> torch.Tensor:
    idx = _padded_index(x.shape[axis], r, mode, x.device)
    xp = torch.index_select(x, axis, torch.clamp(idx, min=0))
    if mode != "constant":
        return xp
    shape = [1] * x.dim()
    shape[axis] = idx.shape[0]
    return torch.where((idx >= 0).reshape(shape), xp, torch.zeros_like(xp))


def gaussian_filter2d(
    x: torch.Tensor,
    sigma,
    mode: str = "constant",
    truncate: float = 4.0,
) -> torch.Tensor:
    """Separable 2D gaussian blur of the last two axes.

    mode: 'constant' (zero), 'wrap', or 'nearest' boundary handling. The
    taps are the JAX package's; each axis is one product of the padded
    windows with the taps.
    """
    if np.isscalar(sigma):
        sigma = (float(sigma), float(sigma))
    if mode not in ("constant", "wrap", "nearest"):
        raise ValueError(f"mode must be constant, wrap or nearest, not {mode!r}")
    out = x
    for axis, s in zip((-2, -1), sigma):
        if s <= 0:
            continue
        k = torch.as_tensor(_gaussian_kernel1d(s, truncate), device=x.device)
        r = (k.shape[0] - 1) // 2
        axis = out.dim() + axis
        xp = _pad_axis(out, axis, r, mode)
        # Sliding windows along `axis` (taps last), then one product.
        windows = xp.unfold(axis, k.shape[0], 1)
        out = torch.sum(windows * k.to(out.dtype), dim=-1)
    return out


def median_filter2d(x: torch.Tensor, size) -> torch.Tensor:
    """Median filter of the last two axes, zero-padded.

    An even window takes the mean of its two middle values, as
    ``jnp.median`` does (``torch.median`` would return the lower one).
    """
    sy, sx = (int(size), int(size)) if np.isscalar(size) else (
        int(size[0]), int(size[1]))
    sy, sx = max(sy, 1), max(sx, 1)
    ry, rx = sy // 2, sx // 2
    xp = torch.nn.functional.pad(x, (rx, sx - 1 - rx, ry, sy - 1 - ry))
    h, w = x.shape[-2], x.shape[-1]
    windows = torch.stack(
        [xp[..., i : i + h, j : j + w] for i in range(sy) for j in range(sx)],
        dim=0,
    )
    s = torch.sort(windows, dim=0).values
    k = s.shape[0]
    if k % 2:
        return s[k // 2]
    return (s[k // 2 - 1] + s[k // 2]) / 2


def center_of_mass2d(x: torch.Tensor):
    """Center of mass (row, column) of a 2D non-negative tensor, as 0-d
    tensors."""
    h, w = x.shape
    total = torch.sum(x) + 1e-32
    rows = torch.sum(x * torch.arange(h, device=x.device)[:, None]) / total
    cols = torch.sum(x * torch.arange(w, device=x.device)[None, :]) / total
    return rows, cols


def integer_shift2d(x: torch.Tensor, shift, fill=0.0) -> torch.Tensor:
    """Shift the last two axes by integer offsets, filling with a constant.

    The offsets may be ints or integer tensors on ``x``'s device: the shift
    is an index gather, so a tensor offset is never read back to the host.
    """
    h, w = x.shape[-2], x.shape[-1]
    dy, dx = (torch.as_tensor(s, device=x.device) for s in shift)
    rows = torch.arange(h, device=x.device) - dy
    cols = torch.arange(w, device=x.device) - dx
    row_ok = (rows >= 0) & (rows < h)
    col_ok = (cols >= 0) & (cols < w)
    out = torch.index_select(x, -2, torch.clamp(rows, 0, h - 1))
    out = torch.index_select(out, -1, torch.clamp(cols, 0, w - 1))
    valid = row_ok[:, None] & col_ok[None, :]
    return torch.where(valid, out, torch.full_like(out, fill))
