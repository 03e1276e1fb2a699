"""Alignment entry points: simulate, invert and reconstruct.

Counterpart of :mod:`tike_tpu.align.align`. The images, shifts, flows and
angles are plain numpy arrays (or tensors) on both sides, so nothing needs
converting between the packages: the same arrays go to either. The
operators run on ``device``, the CUDA card unless the caller passes another
(``device="cpu"``); with no card, asking for it raises, as the
ptychography entry points do. The results come back as numpy arrays.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..ops.alignment import alignment_fwd, alignment_inv
from ..precision import as_tensor, to_numpy
from ..ptycho.ptycho import _resolve_device
from . import solvers

__all__ = ["reconstruct", "simulate", "invert"]

logger = logging.getLogger(__name__)


def _on_device(device, kwargs: dict) -> dict:
    """The operator's keyword arguments with each array (a shift or a
    flow) as a float32 tensor on ``device``; shapes (tuples), None and
    scalars as they are."""
    return {
        key: as_tensor(value, torch.float32, device)
        if isinstance(value, torch.Tensor) or (not isinstance(value, tuple) and np.ndim(value) > 0)
        else value
        for key, value in kwargs.items()
    }


def _operator(function, original, device, kwargs):
    device = _resolve_device(
        device, original=original,
        **{k: v for k, v in kwargs.items() if isinstance(v, torch.Tensor)},
    )
    result = function(as_tensor(original, torch.complex64, device), **_on_device(device, kwargs))
    return to_numpy(result)


def simulate(original, *, device="cuda", **kwargs) -> np.ndarray:
    """Return ``original`` transformed by the alignment operator (pad,
    shift, flow, rotate; ``kwargs`` as :func:`~tike_tpu_torch.ops.alignment.
    alignment_fwd` takes them), as a complex64 numpy array."""
    return _operator(alignment_fwd, original, device, kwargs)


def invert(original, *, device="cuda", **kwargs) -> np.ndarray:
    """Return ``original`` passed through the inverse alignment operator,
    as a complex64 numpy array."""
    return _operator(alignment_inv, original, device, kwargs)


def reconstruct(original, unaligned, algorithm, num_iter=1, rtol=-1, *, device="cuda", **kwargs):
    """Solve the alignment problem; returns the solver's result (the
    estimated ``shift`` or ``flow``) with its arrays as numpy arrays.
    ``cross_correlation`` runs on ``device``; ``farneback`` is OpenCV on
    the host whatever the device."""
    if algorithm not in solvers.__all__:
        raise ValueError("The '{}' algorithm is not an available.".format(algorithm))
    logger.info(
        "{} on {:,d} - {:,d} by {:,d} images for {:,d} iterations.".format(
            algorithm, *unaligned.shape, num_iter
        )
    )
    result = getattr(solvers, algorithm)(
        None,
        original=original,
        unaligned=unaligned,
        num_iter=num_iter,
        device=device,
        **kwargs,
    )
    return {k: to_numpy(v) if np.ndim(v) > 0 else v for k, v in result.items()}
