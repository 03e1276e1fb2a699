"""Probe options and helpers.

Counterpart of :mod:`tike_tpu.ptycho.probe`. Probes are (1, 1, SHARED, W, H)
complex64. Eigen (variable) probes and the per-epoch probe constraints are
not ported yet: :meth:`ProbeOptions.unsupported` names the options that ask
for them, and ``Reconstruction`` raises ``NotImplementedError`` for each.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np

from ..precision import floating


@dataclasses.dataclass
class ProbeOptions:
    """Manage data and settings related to probe correction."""

    update_start: int = 0
    """Start probe updates at this epoch."""

    update_period: int = 1
    """The number of epochs between probe updates."""

    init_rescale_from_measurements: bool = True
    """Initial rescaling of probe using measured intensity."""

    probe_photons: float = np.nan
    """The shared probe mode intensity must add up to this number."""

    probe_wavelength: float = np.nan
    """Wavelength (meters) of the probing wavefield."""

    probe_FOV_lengths: typing.Tuple[float, float] = (np.nan, np.nan)
    """Transverse field of view of the probe (meters): (vertical, horizontal)."""

    force_orthogonality: bool = False
    """Forces probes to be orthogonal each iteration."""

    force_centered_intensity: bool = False
    """Forces the probe intensity to be centered."""

    force_sparsity: float = 0.0
    """Forces this proportion of zero elements."""

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

    probe_support: float = 0.0
    """Weight of the finite probe support constraint; zero or greater."""

    probe_support_radius: float = 0.5 * 0.7
    """Radius of finite probe support as fraction of probe grid. [0.0, 0.5]."""

    probe_support_degree: float = 2.5
    """Degree of the supergaussian defining the probe support."""

    additional_probe_penalty: float = 0.0
    """Penalty applied linearly-increasing across modes to prefer low modes."""

    median_filter_abs_probe: bool = False
    """Whether to median filter the magnitude of each shared probe mode."""

    median_filter_abs_probe_px: typing.Tuple[float, float] = (1.0, 1.0)
    """Median filter pixel widths along each dimension."""

    preconditioner: typing.Any = dataclasses.field(init=False, default=None)

    power: typing.List[typing.Any] = dataclasses.field(
        init=False, default_factory=list
    )
    """The power of the primary probe modes at each iteration."""

    def unsupported(self) -> typing.List[str]:
        """Names of the set options that the port does not run yet."""
        checks = {
            "probe_support": self.probe_support > 0,
            "additional_probe_penalty": self.additional_probe_penalty > 0,
            "median_filter_abs_probe": self.median_filter_abs_probe,
            "force_centered_intensity": self.force_centered_intensity,
            # A zero fraction is a no-op in the JAX package as well.
            "force_sparsity": self.force_sparsity != 0,
            "force_orthogonality": self.force_orthogonality,
            "use_adaptive_moment": self.use_adaptive_moment,
        }
        return [f"probe_options.{k}" for k, on in checks.items() if on]


def get_varying_probe(shared_probe, eigen_probe=None, weights=None):
    """Per-position probes: the shared probe when there are no eigen probes.

    The eigen-probe (OPR) blend is not ported yet.
    """
    if weights is not None or eigen_probe is not None:
        raise NotImplementedError("eigen probes are not ported yet")
    return shared_probe


def gaussian(size, rin=0.8, rout=1.0):
    """A real circular probe amplitude with soft edges (numpy)."""
    r, c = np.mgrid[:size, :size] + 0.5
    rs = np.sqrt((r - size / 2) ** 2 + (c - size / 2) ** 2)
    rmax = np.sqrt(2) * 0.5 * rout * rs.max() + 1.0
    rmin = np.sqrt(2) * 0.5 * rin * rs.max()
    img = np.zeros((size, size), dtype=floating)
    img[rs < rmin] = 1.0
    img[rs > rmax] = 0.0
    zone = np.logical_and(rs > rmin, rs < rmax)
    img[zone] = np.divide(rmax - rs[zone], rmax - rmin)
    return img
