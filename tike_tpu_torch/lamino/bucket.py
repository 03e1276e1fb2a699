"""Bucket laminography drivers: reconstruct and simulate (PyTorch).

Counterpart of :mod:`tike_tpu.lamino.bucket`, on one device or on a mesh
of shards that each own an x-slab of the volume (``obj_split``, or a 1-D
``mesh``), or a 2-D (data x volume) mesh. The projections are the
hand-written kernels of ``csrc/bucket.cu`` on the card, their plain
PyTorch versions on the CPU. Numpy in gives numpy out; tensors in give
tensors on ``device`` out.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..ops.bucket import (
    BucketConfig,
    bucket_fwd,
    bucket_trig,
    sharded_bucket_ops,
    sharded_bucket_ops_2d,
)
from ..parallel import Mesh, home_device, make_mesh
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
    there. Volume model parallelism, as there: ``obj_split > 1`` makes a
    mesh of that many shards on ``device``'s devices (the visible cards in
    turn, so that several shards may share one; CPU shards for the CPU), a
    1-D ``mesh`` (:func:`tike_tpu_torch.parallel.make_mesh`) gives each
    shard an x-slab of the volume, and a 2-D mesh splits the angles over
    its first axis and the slabs over its second
    (:func:`~tike_tpu_torch.ops.bucket.sharded_bucket_ops_2d`); the mesh's
    axes must divide the volume's side and the angles. The volume, data
    and angles stay on the mesh's first device, whose type ``device`` must
    name. On a mesh across processes
    (:func:`tike_tpu_torch.parallel.distributed.global_mesh`) every process
    passes the whole data and angles and computes its own shards' slabs. Returns a dict: ``obj``, ``cost`` (one per outer iteration, a
    numpy array) and the solver's ``step_length``; numpy arrays for an
    array ``data``, tensors on ``device`` for a tensor.
    """
    n = data.shape[2]
    if algorithm not in _SOLVERS:
        raise ValueError("The '{}' algorithm is not an available.".format(algorithm))
    cfg = BucketConfig.from_eps(n=n, tilt=float(tilt), eps=eps)
    if mesh is None and obj_split > 1:
        mesh = _split_mesh(obj_split, device)
    if mesh is not None:
        device = home_device(mesh, device)
    data_d = as_tensor(data, torch.complex64, device)
    theta_d = as_tensor(theta, torch.float32, device)
    if obj is None:
        obj_d = torch.zeros((n, n, n), dtype=torch.complex64, device=data_d.device)
    else:
        obj_d = as_tensor(obj, torch.complex64, device)
    # The angles never change within the call: one table for every
    # projection of every iteration.
    trig = bucket_trig(cfg, theta_d)
    if mesh is not None:
        if len(mesh.axis_names) == 2:
            ops = sharded_bucket_ops_2d(cfg, mesh, *mesh.axis_names)
        else:
            if n % mesh.size:
                raise ValueError(
                    f"the mesh size ({mesh.size}) must evenly divide the volume side ({n}) "
                    "so each device owns a whole x-slab"
                )
            ops = sharded_bucket_ops(cfg, mesh, mesh.axis_names[0])
        _, _, cost_op, grad_op, step_op = ops
        kwargs.setdefault("raw_cost", cost_op)
        kwargs.setdefault("raw_grad", grad_op)
        kwargs.setdefault("step_scale_op", lambda u, t_: step_op(u, t_, trig))

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


def _split_mesh(obj_split: int, device) -> Mesh:
    """A 1-D mesh of ``obj_split`` shards on ``device``'s type of device:
    the visible cards in turn, or the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return make_mesh(devices=[device] * obj_split)
    count = torch.cuda.device_count()
    return make_mesh(devices=[torch.device("cuda", s % count) for s in range(obj_split)])
