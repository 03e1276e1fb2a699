"""Ptychography solvers and the parameter model."""

from .options import (
    IterativeOptions,
    LstsqOptions,
    PtychoParameters,
    RpieOptions,
    crop_fourier_space,
    pad_fourier_space,
)

__all__ = [
    "IterativeOptions",
    "LstsqOptions",
    "PtychoParameters",
    "RpieOptions",
    "crop_fourier_space",
    "pad_fourier_space",
]
