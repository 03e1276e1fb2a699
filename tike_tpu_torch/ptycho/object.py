"""Object (psi) options and helpers.

Counterpart of :mod:`tike_tpu.ptycho.object`, with the per-epoch object
constraints (positivity, smoothness, magnitude clipping) and the removal of
the probe-object scaling ambiguity on tensors, and the host helpers
``get_padded_object`` and ``get_absorbtion_image`` in numpy.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from .. import linalg
from ..precision import cfloating, floating, integer, to_numpy


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

    def resample(self, factor: float, interp=None) -> "ObjectOptions":
        """A copy for a grid of another scale: the moments and the
        preconditioner reset, the update history kept."""
        out = dataclasses.replace(self)
        out.update_mnorm = list(self.update_mnorm)
        return out


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


def remove_object_ambiguity(psi: torch.Tensor, probe: torch.Tensor, preconditioner):
    """Remove the scaling ambiguity between probe and psi: rescale both so
    that the mean |psi|^2 weighted by the illumination ``preconditioner``
    (normalized to a root mean square of 1) is 1/4, psi divided by the
    factor and the probe multiplied. Returns ``(psi, probe)``."""
    W = preconditioner.real
    W = W / linalg.mnorm(W)
    object_norm = 2 * torch.sqrt(torch.mean(torch.square(torch.abs(psi)) * W))
    return psi / object_norm, probe * object_norm


def get_absorbtion_image(data, scan, *, rescale=1.0, method="cubic"):
    """Approximate a scanning-transmission image from diffraction patterns.

    Host numpy and scipy, as in the JAX package: the total intensity of
    each pattern becomes one sample of an absorption map at its
    (rescaled) scan position, resampled onto an integer grid with
    ``scipy.interpolate.griddata``. Points outside the convex hull are
    filled with the maximum intensity (fully transmitting). Tensors are
    copied to the host.
    """
    import scipy.interpolate

    data = to_numpy(data)
    scan = to_numpy(scan)
    rescaled = scan * rescale

    def span(x):
        return np.arange(np.floor(x.min()), np.ceil(x.max()))

    coord0, coord1 = np.meshgrid(
        span(rescaled[:, 0]), span(rescaled[:, 1]), indexing="ij"
    )
    values = np.sum(np.square(np.abs(data)), axis=(-2, -1))
    image = scipy.interpolate.griddata(
        points=rescaled,
        values=values,
        xi=(coord0.flatten(), coord1.flatten()),
        method=method,
        fill_value=np.amax(values),
    )
    return np.reshape(image, coord0.shape)
