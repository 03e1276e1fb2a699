"""Object (psi) options and helpers.

Counterpart of :mod:`tike_tpu.ptycho.object`. The object constraints
(positivity, smoothness, magnitude clipping) are not ported yet;
``Reconstruction`` raises ``NotImplementedError`` when an option asks for
one.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np

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
    """Weight of the positivity constraint (not ported yet)."""

    smoothness_constraint: float = 0
    """Weight of the smoothness constraint (not ported yet)."""

    use_adaptive_moment: bool = False
    """Whether or not to use adaptive moment (not ported yet)."""

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
    """Whether to force the object magnitude to remain <= 1 (not ported)."""

    multislice_propagation_distance: float = 1.0e-9
    """Slice-to-slice propagation distance (meters) for multislice."""

    def unsupported(self) -> typing.List[str]:
        """Names of the set options that the port does not run yet."""
        out = []
        if self.positivity_constraint:
            out.append("object_options.positivity_constraint")
        if self.smoothness_constraint:
            out.append("object_options.smoothness_constraint")
        if self.clip_magnitude:
            out.append("object_options.clip_magnitude")
        if self.use_adaptive_moment:
            out.append("object_options.use_adaptive_moment")
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
