"""Laminography drivers: reconstruct and simulate (PyTorch).

Counterpart of :mod:`tike_tpu.lamino.lamino`. The volume, data and theta
cross in and out as numpy arrays (:func:`reconstruct` given tensors
returns tensors instead); everything between runs on ``device`` (the card
unless the caller asks for the CPU), where the USFFT's interpolation is
the hand-written kernels of ``csrc/usfft.cu`` (Kaiser-Bessel) and
``csrc/usfft_gaussian.cu`` (Gaussian).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..ops.lamino import LaminoConfig, LaminoPlan, MeshLaminoPlan, _plan, lamino_fwd
from ..parallel import home_device
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
    *,
    plan=None,
    **kwargs,
):
    """Solve the laminography problem using the given algorithm.

    The parameters of ``tike_tpu.lamino.reconstruct``, plus ``device`` and
    the keyword-only ``plan``. ``algorithm`` is ``"cgrad"`` (backtracking
    Dai-Yuan CG) or ``"cgls"`` (optimal-step CG on the normal equations);
    ``"bucket"`` raises ``ValueError``, as in ``tike_tpu``: its solver is
    :func:`tike_tpu_torch.lamino.bucket.reconstruct`. Returns a dict:
    ``obj``, ``cost`` (one per outer iteration, always a numpy array) and
    what the solver returns besides. ``mesh``
    (:func:`tike_tpu_torch.parallel.make_mesh`) splits the angles over its
    shards (their number must divide the angles'), as the JAX package
    shards theta: the projections and angles stay on the first shard's
    device, whose type ``device`` must name, and each shard transforms its
    own angles (:class:`~tike_tpu_torch.ops.lamino.MeshLaminoPlan`). On a
    mesh across processes
    (:func:`tike_tpu_torch.parallel.distributed.global_mesh`) each process
    passes its own contiguous run of the angles and their projections
    (``distributed.split_for_process``), each as many, and every process
    gets the same volume and costs.

    ``data``, ``theta`` and ``obj`` are arrays or tensors. What comes back
    follows ``data``: numpy arrays for an array; for a tensor, tensors on
    ``device``, and tensors already there are used as they are, so nothing
    makes a trip through the host (joint ADMM fits its volume so). ``plan``
    is the geometry's :class:`~tike_tpu_torch.ops.lamino.LaminoPlan`, for a
    caller that solves many problems at one set of angles; without one, a
    plan is built for the call. With a mesh, a plan must be the mesh's
    :class:`~tike_tpu_torch.ops.lamino.MeshLaminoPlan`.
    """
    if mesh is not None:
        device = home_device(mesh, device)
        if plan is not None and not isinstance(plan, MeshLaminoPlan):
            raise ValueError("with a mesh, plan must be a MeshLaminoPlan of that mesh")
    if algorithm == "bucket":
        raise ValueError(
            "Use tike_tpu_torch.lamino.bucket.reconstruct for the bucket solver."
        )
    if algorithm not in solvers.__all__:
        raise ValueError(
            "The '{}' algorithm is not an available.".format(algorithm)
        )
    n = data.shape[2]
    data_d = as_tensor(data, torch.complex64, device)
    theta_d = as_tensor(theta, torch.float32, device)
    if obj is None:
        obj_d = torch.zeros((n, n, n), dtype=torch.complex64, device=data_d.device)
    else:
        obj_d = as_tensor(obj, torch.complex64, device)
    cfg = LaminoConfig(
        n=obj_d.shape[-1], tilt=float(tilt), eps=float(eps), upsample=upsample,
        kernel=kernel,
    )

    logger.info(
        "{} on {:,d} by {:,d} by {:,d} volume for {:,d} "
        "iterations.".format(algorithm, *obj_d.shape, num_iter)
    )

    # The geometry never changes within the call: one plan for every
    # transform of every iteration.
    if mesh is not None and plan is None:
        plan = MeshLaminoPlan(cfg, theta_d, mesh)
    plan = _plan(plan, cfg, theta_d)
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
    if isinstance(data, torch.Tensor):
        return result
    return {
        k: to_numpy(v) if isinstance(v, torch.Tensor) else v
        for k, v in result.items()
    }
