"""Alignment solvers."""

from .cross_correlation import cross_correlation
from .farneback import farneback

__all__ = ["cross_correlation", "farneback"]
