"""Laminography drivers: reconstruct and simulate (PyTorch).

Counterpart of :mod:`tike_tpu.lamino.lamino`. The volume, data and theta
cross in and out as numpy arrays; everything between runs on ``device``
(the card unless the caller asks for the CPU), where the USFFT's KB
interpolation is the hand-written kernels of ``csrc/usfft.cu``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..ops.lamino import LaminoConfig, LaminoPlan, lamino_fwd
from ..precision import as_tensor, to_numpy
from . import solvers

__all__ = ["reconstruct", "simulate"]

logger = logging.getLogger(__name__)


def simulate(obj, theta, tilt, eps=1e-3, upsample=1, kernel="kb", device="cuda", **kwargs):
    """Return complex64 simulated laminography data (ntheta, n, n), numpy."""
    assert obj.ndim == 3
    assert np.ndim(theta) == 1
    cfg = LaminoConfig(
        n=obj.shape[-1], tilt=float(tilt), eps=float(eps), upsample=upsample,
        kernel=kernel,
    )
    theta = as_tensor(theta, torch.float32, device)
    data = lamino_fwd(
        cfg, as_tensor(obj, torch.complex64, device), theta, LaminoPlan(cfg, theta)
    )
    return to_numpy(data)


def reconstruct(
    data,
    theta,
    tilt,
    algorithm,
    obj=None,
    num_iter=1,
    rtol=-1,
    eps=1e-3,
    num_gpu=1,
    upsample=1,
    mesh=None,
    kernel="kb",
    device="cuda",
    **kwargs,
):
    """Solve the laminography problem using the given algorithm.

    The parameters of ``tike_tpu.lamino.reconstruct``, plus ``device``.
    ``algorithm`` is ``"cgrad"`` (backtracking Dai-Yuan CG) or ``"cgls"``
    (optimal-step CG on the normal equations). Returns a dict of numpy
    arrays: ``obj``, ``cost`` (one per outer iteration) and what the solver
    returns besides. ``mesh`` (several devices) is not ported.
    """
    if mesh is not None:
        raise NotImplementedError("multi-device laminography (mesh) is not ported")
    n = data.shape[2]
    obj = np.zeros([n, n, n], dtype="complex64") if obj is None else obj
    if algorithm == "bucket":
        raise ValueError(
            "Use tike_tpu.lamino.bucket.reconstruct for the bucket solver."
        )
    if algorithm not in solvers.__all__:
        raise ValueError(
            "The '{}' algorithm is not an available.".format(algorithm)
        )
    cfg = LaminoConfig(
        n=obj.shape[-1], tilt=float(tilt), eps=float(eps), upsample=upsample,
        kernel=kernel,
    )
    data_d = as_tensor(data, torch.complex64, device)
    theta_d = as_tensor(theta, torch.float32, device)
    obj_d = as_tensor(obj, torch.complex64, device)

    logger.info(
        "{} on {:,d} by {:,d} by {:,d} volume for {:,d} "
        "iterations.".format(algorithm, *obj.shape, num_iter)
    )

    # The geometry never changes within the call: one plan for every
    # transform of every iteration.
    plan = LaminoPlan(cfg, theta_d)
    result = {"obj": obj_d}
    costs = []
    for i in range(num_iter):
        kwargs.update(result)
        result = getattr(solvers, algorithm)(
            cfg, data=data_d, theta=theta_d, plan=plan, **kwargs
        )
        if result.get("cost") is not None:
            costs.append(float(result["cost"]))
        if len(costs) > 1 and abs((costs[-1] - costs[-2]) / costs[-2]) < rtol:
            logger.info("Cost function rtol < %g reached at %d iterations.", rtol, i)
            break

    result["cost"] = np.asarray(costs)
    return {
        k: to_numpy(v) if isinstance(v, torch.Tensor) else v
        for k, v in result.items()
    }
