"""Laminography solvers: one outer iteration each."""

from .cgls import cgls
from .cgrad import cgrad

__all__ = ["cgrad", "cgls"]
