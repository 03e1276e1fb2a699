"""Complex linear algebra helpers (PyTorch).

Counterpart of :mod:`tike_tpu.linalg`; only what the solvers use.
"""

from __future__ import annotations

import torch


def mnorm(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """Return the root-mean-square magnitude (norm normalized by count)."""
    sq = (x * x.conj()).real if x.is_complex() else x * x
    if dim is None:
        return torch.sqrt(torch.mean(sq))
    return torch.sqrt(torch.mean(sq, dim=dim, keepdim=keepdim))


def norm(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """Return the complex vector 2-norm: sqrt(sum(|x|^2))."""
    sq = (x * x.conj()).real if x.is_complex() else x * x
    if dim is None:
        return torch.sqrt(torch.sum(sq))
    return torch.sqrt(torch.sum(sq, dim=dim, keepdim=keepdim))


def inner(x: torch.Tensor, y: torch.Tensor, dim=None, keepdim: bool = False):
    """Return the complex inner product <x|y> = sum(conj(x) * y)."""
    prod = torch.conj(x) * y
    if dim is None:
        return torch.sum(prod)
    return torch.sum(prod, dim=dim, keepdim=keepdim)


def projection(a: torch.Tensor, b: torch.Tensor, dim=None) -> torch.Tensor:
    """Return the vector projection of a onto b."""
    return inner(b, a, dim=dim, keepdim=True) / inner(b, b, dim=dim, keepdim=True) * b
