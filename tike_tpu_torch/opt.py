"""Adaptive-moment step directions (PyTorch).

Counterpart of :mod:`tike_tpu.opt`; only ``adam``, which the position
step of the LSQML epoch uses when ``PositionOptions.use_adaptive_moment``
is set.
"""

from __future__ import annotations

import torch


def adam(g, v=None, m=None, vdecay=0.999, mdecay=0.9, eps=1e-8):
    """Adaptive moment estimation direction.

    Returns ``(direction, v, m)``: the new second moment ``v`` (real) and
    first moment ``m`` (of ``g``'s dtype) to pass to the next call.
    """
    v = torch.zeros_like(g.real) if v is None else v
    m = torch.zeros_like(g) if m is None else m
    m = mdecay * m + (1 - mdecay) * g
    v = vdecay * v + (1 - vdecay) * (g * g.conj()).real
    m_ = m / (1 - mdecay)
    v_ = torch.sqrt(v / (1 - vdecay))
    return m_ / (v_ + eps), v, m
