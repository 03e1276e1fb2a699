"""Ptychography solvers and the parameter model."""

from .options import (
    IterativeOptions,
    LstsqOptions,
    PtychoParameters,
    RpieOptions,
)

__all__ = [
    "IterativeOptions",
    "LstsqOptions",
    "PtychoParameters",
    "RpieOptions",
]
