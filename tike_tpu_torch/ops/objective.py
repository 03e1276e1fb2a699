"""Noise-model cost functions and gradients for ptychography (PyTorch).

Counterpart of :mod:`tike_tpu.ops.objective`. Costs are means (not sums)
so values are comparable across mini-batch sizes.
"""

from __future__ import annotations

import torch


def _broadcast_scale(scale: torch.Tensor, farplane: torch.Tensor):
    """Reshape a (N, M, M) detector scale to multiply (N, ..., M, M)."""
    extra = farplane.dim() - scale.dim()
    return scale.reshape(scale.shape[0], *([1] * extra), *scale.shape[-2:])


# --- Gaussian (amplitude least-squares) model ---


def _gaussian_elem(data, intensity):
    diff = torch.sqrt(intensity) - torch.sqrt(data)
    return diff * diff


def gaussian(data, intensity):
    """Mean Gaussian-model objective over all pixels."""
    return torch.mean(_gaussian_elem(data, intensity))


def gaussian_each_pattern(data, intensity):
    """Per-pattern mean Gaussian objective. data/intensity: (N, M, M)."""
    return torch.mean(_gaussian_elem(data, intensity), dim=(-2, -1))


def gaussian_grad(data, farplane, intensity):
    """Wirtinger gradient of the Gaussian objective wrt the farplane."""
    scale = 1 - torch.sqrt(data) / (torch.sqrt(intensity) + 1e-9)
    return farplane * _broadcast_scale(scale, farplane)


# --- Poisson model ---


def _poisson_elem(data, intensity):
    return intensity - data * torch.log(intensity + 1e-9)


def poisson(data, intensity):
    """Mean Poisson-model objective over all pixels."""
    return torch.mean(_poisson_elem(data, intensity))


def poisson_each_pattern(data, intensity):
    """Per-pattern mean Poisson objective."""
    return torch.mean(_poisson_elem(data, intensity), dim=(-2, -1))


def poisson_grad(data, farplane, intensity):
    """Wirtinger gradient of the Poisson objective wrt the farplane."""
    scale = 1 - data / (intensity + 1e-9)
    return farplane * _broadcast_scale(scale, farplane)


EACH_PATTERN = {
    "gaussian": gaussian_each_pattern,
    "poisson": poisson_each_pattern,
}
ELEMENTWISE = {"gaussian": _gaussian_elem, "poisson": _poisson_elem}
GRAD = {"gaussian": gaussian_grad, "poisson": poisson_grad}
COST = {"gaussian": gaussian, "poisson": poisson}
