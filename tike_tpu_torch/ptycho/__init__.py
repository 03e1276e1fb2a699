"""Ptychography: the rPIE and LSQML solvers, parameter model and options.

Public API mirrors :mod:`tike_tpu.ptycho` for what is ported.
"""

from .exitwave import ExitWaveOptions
from .object import ObjectOptions, get_padded_object
from .position import (
    AffineTransform,
    PositionOptions,
    affine_position_regularization,
    check_allowed_positions,
)
from .probe import (
    ProbeOptions,
    add_modes_cartesian_hermite,
    add_modes_random_phase,
    gaussian,
    get_varying_probe,
    init_varying_probe,
)
from .ptycho import Reconstruction, reconstruct, simulate, simulate_device
from .solvers import IterativeOptions, LstsqOptions, PtychoParameters, RpieOptions

__all__ = [
    "AffineTransform",
    "ExitWaveOptions",
    "IterativeOptions",
    "LstsqOptions",
    "ObjectOptions",
    "PositionOptions",
    "ProbeOptions",
    "PtychoParameters",
    "Reconstruction",
    "RpieOptions",
    "add_modes_cartesian_hermite",
    "add_modes_random_phase",
    "affine_position_regularization",
    "check_allowed_positions",
    "gaussian",
    "get_padded_object",
    "get_varying_probe",
    "init_varying_probe",
    "reconstruct",
    "simulate",
    "simulate_device",
]
