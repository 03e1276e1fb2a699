"""Laminography on PyTorch: simulate and reconstruct (cgrad, CGLS)."""

from .lamino import reconstruct, simulate

__all__ = ["reconstruct", "simulate"]
