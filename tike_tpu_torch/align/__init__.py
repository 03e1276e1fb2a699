"""Alignment: rigid and non-rigid image registration (PyTorch).

Counterpart of :mod:`tike_tpu.align`. ``simulate``, ``invert`` and
``reconstruct`` take and return numpy arrays and run on ``device``, the
CUDA card unless the caller asks for another (``device="cpu"``).
"""

from .align import invert, reconstruct, simulate
from .solvers.cross_correlation import cross_correlation
from .solvers.farneback import farneback
from . import solvers
