"""Ptychography solvers and the parameter model.

``rpie`` and ``lstsq_grad`` are the per-epoch solver functions (one epoch
each, after ``update_preconditioners``), as in :mod:`tike_tpu.ptycho.solvers`;
they shadow the modules of the same names, which
``importlib.import_module`` still reaches.
"""

from .options import (
    IterativeOptions,
    LstsqOptions,
    PtychoParameters,
    RpieOptions,
    crop_fourier_space,
    pad_fourier_space,
)
from ._preconditioner import update_preconditioners
from .lstsq import lstsq_grad
from .rpie import rpie

__all__ = [
    "IterativeOptions",
    "LstsqOptions",
    "PtychoParameters",
    "RpieOptions",
    "crop_fourier_space",
    "lstsq_grad",
    "pad_fourier_space",
    "rpie",
    "update_preconditioners",
]
