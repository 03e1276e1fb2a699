"""Laminography on PyTorch: simulate and reconstruct (cgrad, CGLS), and the
Bucket operator's drivers in :mod:`.bucket`."""

from . import bucket
from . import solvers
from .lamino import reconstruct, simulate
from .solvers.cgrad import cgrad

__all__ = ["bucket", "cgrad", "reconstruct", "simulate", "solvers"]
