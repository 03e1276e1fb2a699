"""Adaptive-moment step directions (PyTorch).

Counterpart of :mod:`tike_tpu.opt`: ``adam`` (the position step, and rPIE's
per-batch object and probe moments), ``momentum`` (LSQML's per-batch
object momentum) and ``momentum_checked_traced`` (the epoch-end moment of
compact runs). Every decision stays on the device: nothing here reads a
value back to the host.
"""

from __future__ import annotations

import torch

from . import linalg


def momentum(g, v, m, vdecay=None, mdecay=0.9):
    """Classical momentum direction. Returns ``(direction, None, m)``."""
    m = 0 if m is None else m
    m = mdecay * m + (1 - mdecay) * g
    return m, None, m


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


def momentum_checked_traced(
    g,
    previous_g,
    m,
    mdecay,
    err_hist,
    n_epochs_done,
    beta=1.0,
):
    """Momentum, applied only while the cost trends down and the recent
    normalized steps agree.

    ``previous_g`` (3, *g.shape) holds the last normalized steps, ``m`` the
    momentum (like ``g``), ``err_hist`` the (3,) tail of the epoch-cost
    series with the current epoch last, and ``n_epochs_done`` the length of
    that series. The decision is a ``torch.where`` over device values, as
    in the JAX package's traced version. Returns ``(direction, previous_g,
    m)``.
    """
    previous_g = torch.roll(previous_g, shifts=-1, dims=0)
    gnorm = linalg.norm(g)
    previous_g = previous_g.clone()
    previous_g[-1] = g / torch.where(gnorm == 0, 1, gnorm) * beta
    trending = (n_epochs_done > 2) & (
        torch.maximum(err_hist[0], err_hist[1])
        > torch.minimum(err_hist[1], err_hist[2])
    )
    corr = linalg.inner(
        previous_g[:-1], previous_g[-1:], dim=(-2, -1)
    ).real.reshape(-1)
    allpos = torch.all(corr > 0)
    # Least-squares slope of [0, log corr...] against [0, 1, ...].
    y = torch.cat(
        [torch.zeros((1,), dtype=corr.dtype, device=corr.device),
         torch.log(torch.clamp(corr, min=1e-30))]
    )
    x = torch.arange(y.shape[0], dtype=y.dtype, device=y.device)
    count = y.shape[0]
    slope = (count * torch.sum(x * y) - x.sum() * y.sum()) / (
        count * torch.sum(x * x) - x.sum() ** 2
    )
    friction = 0.5 * torch.clamp(-slope, min=0)
    take = trending & allpos
    m_new = torch.where(take, (1 - friction) * m + g, m / 2)
    d = torch.where(take, mdecay * m_new, torch.zeros_like(g))
    return d, previous_g, m_new
