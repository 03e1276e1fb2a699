"""Bucket laminography drivers: reconstruct and simulate (PyTorch).

Counterpart of :mod:`tike_tpu.lamino.bucket` for one device (its
single-device branch). The projections are the hand-written kernels of
``csrc/bucket.cu`` on the card, their plain PyTorch versions on the CPU.
Numpy in gives numpy out; tensors in give tensors on ``device`` out.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..ops.bucket import BucketConfig, bucket_fwd, bucket_trig
from ..precision import as_tensor, to_numpy
from .solvers import bucket as _bucket_solver  # the solver function

__all__ = ["reconstruct", "simulate"]

logger = logging.getLogger(__name__)

_SOLVERS = {"bucket": _bucket_solver}


def simulate(obj, theta, tilt, eps=1.0, *, device="cuda", **kwargs):
    """Return complex64 projections (ntheta, n, n) simulated with the
    Bucket operator: numpy for an array ``obj``, a tensor on ``device`` for
    a tensor."""
    assert obj.ndim == 3
    assert np.ndim(theta) == 1
    n = obj.shape[-1]
    cfg = BucketConfig.from_eps(n=n, tilt=float(tilt), eps=eps)
    theta_d = as_tensor(theta, torch.float32, device)
    data = bucket_fwd(cfg, as_tensor(obj, torch.complex64, device), theta_d,
                      trig=bucket_trig(cfg, theta_d))
    return data if isinstance(obj, torch.Tensor) else to_numpy(data)


def reconstruct(
    data,
    theta,
    tilt,
    algorithm="bucket",
    obj=None,
    num_iter=1,
    rtol=-1,
    eps=1e-1,
    num_gpu=1,
    obj_split=1,
    use_mpi=False,
    mesh=None,
    *,
    device="cuda",
    **kwargs,
):
    """Solve the laminography problem with the Bucket operator on
    ``device`` (the card unless the caller asks for another).

    The parameters of ``tike_tpu.lamino.bucket.reconstruct``, plus the
    keyword-only ``device``; ``num_gpu`` and ``use_mpi`` are not read, as
    there. Volume model parallelism (``obj_split > 1`` or a ``mesh``) is not
    ported and raises ``NotImplementedError``. Returns a dict: ``obj``,
    ``cost`` (one per outer iteration, a numpy array) and the solver's
    ``step_length``; numpy arrays for an array ``data``, tensors on
    ``device`` for a tensor.
    """
    if mesh is not None or obj_split > 1:
        raise NotImplementedError(
            "volume model parallelism (obj_split > 1, mesh) is not ported"
        )
    n = data.shape[2]
    if algorithm not in _SOLVERS:
        raise ValueError("The '{}' algorithm is not an available.".format(algorithm))
    cfg = BucketConfig.from_eps(n=n, tilt=float(tilt), eps=eps)
    data_d = as_tensor(data, torch.complex64, device)
    theta_d = as_tensor(theta, torch.float32, device)
    if obj is None:
        obj_d = torch.zeros((n, n, n), dtype=torch.complex64, device=data_d.device)
    else:
        obj_d = as_tensor(obj, torch.complex64, device)
    # The angles never change within the call: one table for every
    # projection of every iteration.
    trig = bucket_trig(cfg, theta_d)

    logger.info(
        "{} on {:,d} by {:,d} by {:,d} volume for {:,d} "
        "iterations.".format(algorithm, *obj_d.shape, num_iter)
    )
    result = {"obj": obj_d}
    costs = []
    for i in range(num_iter):
        kwargs.update(result)
        result = _SOLVERS[algorithm](cfg, data=data_d, theta=theta_d, trig=trig, **kwargs)
        if result.get("cost") is not None:
            costs.append(float(result["cost"]))
        if len(costs) > 1 and abs((costs[-1] - costs[-2]) / costs[-2]) < rtol:
            logger.info("Cost function rtol < %g reached at %d iterations.", rtol, i)
            break

    result["cost"] = np.asarray(costs)
    if isinstance(data, torch.Tensor):
        return result
    return {k: to_numpy(v) if isinstance(v, torch.Tensor) else v for k, v in result.items()}
