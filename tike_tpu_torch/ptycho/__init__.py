"""Ptychography: the LSQML solver, parameter model and options.

Public API mirrors :mod:`tike_tpu.ptycho` for what is ported.
"""

from .exitwave import ExitWaveOptions
from .object import ObjectOptions, get_padded_object
from .position import PositionOptions, check_allowed_positions
from .probe import ProbeOptions, gaussian
from .ptycho import Reconstruction, reconstruct, simulate, simulate_device
from .solvers import IterativeOptions, LstsqOptions, PtychoParameters, RpieOptions

__all__ = [
    "ExitWaveOptions",
    "IterativeOptions",
    "LstsqOptions",
    "ObjectOptions",
    "PositionOptions",
    "ProbeOptions",
    "PtychoParameters",
    "Reconstruction",
    "RpieOptions",
    "check_allowed_positions",
    "gaussian",
    "get_padded_object",
    "reconstruct",
    "simulate",
    "simulate_device",
]
