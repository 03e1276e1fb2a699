"""Laminography on PyTorch: simulate and reconstruct (cgrad, CGLS), and the
Bucket operator's drivers in :mod:`.bucket`."""

from . import bucket
from .lamino import reconstruct, simulate

__all__ = ["bucket", "reconstruct", "simulate"]
