"""Scan-position options and checks.

Counterpart of :mod:`tike_tpu.ptycho.position`. Position correction is not
ported yet: :class:`PositionOptions` holds the settings (without the
affine-transform model), and ``Reconstruction`` raises
``NotImplementedError`` when one is given.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import numpy.typing as npt

from ..precision import floating


@dataclasses.dataclass
class PositionOptions:
    """Manage data and settings related to position correction."""

    initial_scan: np.ndarray
    """The original scan positions before position correction."""

    use_adaptive_moment: bool = False
    """Whether AdaM is used to accelerate position correction updates."""

    vdecay: float = 0.999
    """Second-moment decay."""

    mdecay: float = 0.9
    """First-moment decay."""

    use_position_regularization: bool = False
    """Whether positions are constrained to an affine + random error model."""

    update_magnitude_limit: float = 0
    """Clip per-epoch position update magnitudes to this value if > 0."""

    origin: npt.NDArray = dataclasses.field(
        default_factory=lambda: np.zeros(2)
    )
    """Rotation center applied before fitting the global transformation."""

    confidence: np.ndarray = dataclasses.field(default_factory=lambda: None)
    """A rating of the confidence of position information at each position."""

    update_start: int = 0
    """Start position updates at this epoch."""

    def __post_init__(self):
        self.initial_scan = np.asarray(self.initial_scan).astype(floating)
        if self.confidence is None:
            self.confidence = np.ones(
                shape=self.initial_scan.shape, dtype=floating
            )


def check_allowed_positions(scan, psi, probe_shape):
    """Check that all positions are within the field of view.

    Positions must be >= 1 and positions + 1 + probe.shape <= psi.shape.
    """
    int_scan = np.asarray(scan) // 1
    min_corner = np.min(int_scan, axis=-2)
    max_corner = np.max(int_scan, axis=-2)
    valid_min = (1, 1)
    valid_max = (
        psi.shape[-2] - probe_shape[-2] - 1,
        psi.shape[-1] - probe_shape[-1] - 1,
    )
    if (
        min_corner[0] < valid_min[0]
        or min_corner[1] < valid_min[1]
        or max_corner[0] > valid_max[0]
        or max_corner[1] > valid_max[1]
    ):
        raise ValueError(
            "Scan positions must be >= 1 and "
            "scan positions + 1 + probe.shape must be <= psi.shape. "
            "psi may be too small or the scan positions may be scaled wrong. "
            f"The span of scan is {min_corner} to {max_corner}, and "
            f"the shape of psi is {psi.shape}."
        )
