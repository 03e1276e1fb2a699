"""Laminography solvers: one outer iteration each."""

from .bucket import bucket
from .cgls import cgls
from .cgrad import cgrad

__all__ = ["bucket", "cgls", "cgrad"]
