"""Helpers for generating ptychographic deep-learning training data.

Counterpart of :mod:`tike_tpu.ptycho.learn`.
"""

from __future__ import annotations

import torch

from ..ops.patch import patch_fwd
from ..precision import as_tensor, to_numpy
from .position import check_allowed_positions

__all__ = ["extract_patches"]


def extract_patches(psi, scan, patch_width: int, *, device="cuda"):
    """Extract patches of psi at the given scan positions.

    psi (H, W) complex; scan (POSI, 2) float32 min-corners; returns
    (POSI, patch_width, patch_width) complex64. The positions are checked
    on the host with :func:`check_allowed_positions`, and the patches are
    gathered by :func:`~tike_tpu_torch.ops.patch.patch_fwd`, the CUDA
    kernel on the card. A tensor ``psi`` gives a tensor on its device; a
    numpy ``psi`` is gathered on ``device`` and given back as numpy.
    """
    check_allowed_positions(to_numpy(scan), psi, (patch_width, patch_width))
    tensor = isinstance(psi, torch.Tensor)
    device = psi.device if tensor else torch.device(device)
    patches = patch_fwd(
        as_tensor(psi, torch.complex64, device),
        as_tensor(scan, torch.float32, device),
        patch_width,
    )
    return patches if tensor else to_numpy(patches)
