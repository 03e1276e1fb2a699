"""Complex linear algebra helpers (PyTorch).

Counterpart of :mod:`tike_tpu.linalg`; only what the LSQML path uses.
"""

from __future__ import annotations

import torch


def mnorm(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """Return the root-mean-square magnitude (norm normalized by count)."""
    sq = (x * x.conj()).real if x.is_complex() else x * x
    if dim is None:
        return torch.sqrt(torch.mean(sq))
    return torch.sqrt(torch.mean(sq, dim=dim, keepdim=keepdim))
