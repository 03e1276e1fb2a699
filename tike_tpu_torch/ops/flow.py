"""Non-rigid dense warps (optical-flow remap) by Lanczos interpolation.

Counterpart of :mod:`tike_tpu.ops.flow`: each image is sampled at its own
points, pixel (i, j) at (i, j) less its displacement, by
:func:`~.interp.remap_lanczos_fwd` with half-width ``max(1, filter_size //
2)``; on CUDA tensors one launch of ``csrc/interp.cu``'s kernel warps the
whole stack.
"""

from __future__ import annotations

import torch

from .interp import remap_lanczos_adj, remap_lanczos_fwd


def _flow_coords(flow: torch.Tensor) -> torch.Tensor:
    """Displacements (..., H, W, 2) to sample coordinates (..., H*W, 2)."""
    h, w = flow.shape[-3:-1]
    coords = -flow
    coords[..., 0] += torch.arange(h, dtype=flow.dtype, device=flow.device)[:, None]
    coords[..., 1] += torch.arange(w, dtype=flow.dtype, device=flow.device)[None, :]
    return coords.reshape(*flow.shape[:-3], h * w, 2)


def flow_fwd(f: torch.Tensor, flow: torch.Tensor | None, filter_size: int = 5, cval=0.0):
    """Remap each image of f (..., H, W) by its displacements flow (..., H,
    W, 2) float32."""
    if flow is None:
        return f
    h, w = f.shape[-2:]
    coords = _flow_coords(flow).reshape(-1, h * w, 2)
    a = max(1, filter_size // 2)
    out = remap_lanczos_fwd(f.reshape(-1, h, w), coords, a, cval)
    return out.reshape(f.shape)


def flow_adj(g: torch.Tensor, flow: torch.Tensor | None, filter_size: int = 5, cval=0.0):
    """Adjoint remap: spread each warped image back onto its source grid."""
    if flow is None:
        return g
    h, w = g.shape[-2:]
    coords = _flow_coords(flow).reshape(-1, h * w, 2)
    a = max(1, filter_size // 2)
    out = remap_lanczos_adj(g.reshape(-1, h * w), coords, a, (h, w))
    return out.reshape(g.shape)


def flow_inv(g: torch.Tensor, flow: torch.Tensor | None, filter_size: int = 5, cval=0.0):
    """Approximate inverse: warp by the negated flow."""
    return flow_fwd(g, None if flow is None else -flow, filter_size, cval)
