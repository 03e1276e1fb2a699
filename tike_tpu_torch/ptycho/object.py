"""Object (psi) options and helpers.

Counterpart of :mod:`tike_tpu.ptycho.object`, with the per-epoch object
constraints (positivity, smoothness, magnitude clipping) on tensors.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from ..precision import cfloating, floating, integer


@dataclasses.dataclass
class ObjectOptions:
    """Manage data and settings related to object correction."""

    convergence_tolerance: float = 0
    """Terminate early when the mnorm of the object update drops below this."""

    update_mnorm: typing.List[float] = dataclasses.field(
        init=False, default_factory=list
    )
    """A record of the previous mnorms of the object update."""

    positivity_constraint: float = 0
    """Weight of the positivity constraint, in [0, 1]."""

    smoothness_constraint: float = 0
    """Weight of the smoothness constraint, in [0, 1/8)."""

    use_adaptive_moment: bool = False
    """Whether or not to use adaptive moment."""

    vdecay: float = 0.999
    """Second-moment decay for adaptive moment."""

    mdecay: float = 0.9
    """First-moment decay for adaptive moment."""

    v: typing.Any = dataclasses.field(init=False, default=None)
    """The second moment for adaptive moment."""

    m: typing.Any = dataclasses.field(init=False, default=None)
    """The first moment for adaptive moment."""

    preconditioner: typing.Any = dataclasses.field(init=False, default=None)
    """Magnitude of the illumination used to condition object updates."""

    clip_magnitude: bool = False
    """Whether to force the object magnitude to remain <= 1."""

    multislice_propagation_distance: float = 1.0e-9
    """Slice-to-slice propagation distance (meters) for multislice."""


def get_padded_object(scan, probe, extra: int = 0):
    """Return a 0.5-initialized object sized to cover the scan, and new scan.

    Host (numpy) helper, as :func:`tike_tpu.ptycho.object.get_padded_object`.
    """
    scan = np.asarray(scan)
    int_scan = scan // 1
    min_corner = np.min(int_scan, axis=-2)
    max_corner = np.max(int_scan, axis=-2)
    span = (max_corner - min_corner + probe.shape[-1] + 2 + 2 * extra).astype(
        integer
    )
    psi = np.full(tuple(span), 0.5 + 0j, dtype=cfloating)
    return psi, (scan + 1 - min_corner + extra).astype(floating)


def positivity_constraint(x: torch.Tensor, r: float) -> torch.Tensor:
    """Blend x toward its own magnitude: ``r * |x| + (1 - r) * x``."""
    if r > 0:
        if r > 1:
            raise ValueError(
                f"Positivity constraint must be in the range [0, 1] not {r}."
            )
        return r * torch.abs(x) + (1 - r) * x
    return x


def smoothness_constraint(x: torch.Tensor, a: float) -> torch.Tensor:
    """Convolve the last two axes with the 3x3 kernel
    [[a, a, a], [a, 1 - 8a, a], [a, a, a]], edges replicated."""
    if not (0 <= a < 1.0 / 8.0):
        raise ValueError(
            f"Smoothness constraint must be in range [0, 1/8) not {a}."
        )
    h, w = x.shape[-2], x.shape[-1]
    rows = torch.clamp(torch.arange(-1, h + 1, device=x.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-1, w + 1, device=x.device), 0, w - 1)
    xp = torch.index_select(torch.index_select(x, -2, rows), -1, cols)
    neighborhood = (
        xp[..., :-2, :-2] + xp[..., :-2, 1:-1] + xp[..., :-2, 2:]
        + xp[..., 1:-1, :-2] + xp[..., 1:-1, 2:]
        + xp[..., 2:, :-2] + xp[..., 2:, 1:-1] + xp[..., 2:, 2:]
    )
    return a * neighborhood + (1.0 - 8.0 * a) * x


def clip_magnitude(x: torch.Tensor, a_max: float = 1.0) -> torch.Tensor:
    """Clip the complex magnitude to ``a_max`` without changing the phase."""
    magnitude = torch.abs(x)
    scale = torch.where(
        magnitude > a_max, a_max / magnitude, torch.ones_like(magnitude)
    )
    return x * scale
