"""Conjugate-gradient solver for the Bucket laminography operator (PyTorch).

Counterpart of :mod:`tike_tpu.lamino.solvers.bucket`: Dai-Yuan directions
and a backtracking line search on the least-squares cost of
:func:`~tike_tpu_torch.ops.bucket.bucket_fwd`, with the gradient through
:func:`~tike_tpu_torch.ops.bucket.bucket_adj`, on one device, or on a mesh
through the cost, gradient and step scale of
:func:`~tike_tpu_torch.ops.bucket.sharded_bucket_ops` (or ``_2d``), which
the caller passes as ``raw_cost``, ``raw_grad`` and ``step_scale_op``, as
the JAX package's ``reconstruct`` passes its sharded operators.
``tike_tpu`` traces the whole outer iteration into one device program;
here it is the eager loop of :func:`tike_tpu_torch.opt.conjugate_gradient`,
as the port's ``cgrad`` runs it.
"""

from __future__ import annotations

import logging

import numpy as np

from ... import opt
from ...ops.bucket import (
    BucketConfig,
    bucket_cost,
    bucket_fwd,
    bucket_grad,
    bucket_step_scale,
)

logger = logging.getLogger(__name__)


def _single_device_raw(cfg: BucketConfig):
    """The cost and gradient of the operator on one device."""

    def cost_raw(data, u, theta, grid=None, trig=None):
        return bucket_cost(data, bucket_fwd(cfg, u, theta, grid, trig))

    def grad_raw(data, u, theta, grid=None, trig=None):
        return bucket_grad(cfg, data, theta, bucket_fwd(cfg, u, theta, grid, trig), grid, trig)

    return cost_raw, grad_raw


def bucket(
    cfg: BucketConfig,
    data,
    theta,
    obj,
    grid=None,
    cg_iter=4,
    step_length=1,
    trig=None,
    raw_cost=None,
    raw_grad=None,
    step_scale_op=None,
    **kwargs,
):
    """One outer iteration (``cg_iter`` CG steps) for the Bucket
    laminography problem. Returns ``{"obj", "cost", "step_length"}``: the
    cost a float, the step length the one this iteration started from.
    ``grid`` (None: the full lattice) and ``trig`` (the angles' table,
    :func:`~tike_tpu_torch.ops.bucket.bucket_trig`) are the caller's, if it
    keeps them. ``raw_cost(data, u, theta, grid, trig)``, ``raw_grad(data,
    u, theta, grid, trig)`` and ``step_scale_op(u, theta)`` default to the
    operators of one device."""
    if raw_cost is None or raw_grad is None:
        raw_cost, raw_grad = _single_device_raw(cfg)
    if step_scale_op is None:

        def step_scale_op(u, theta_):
            return bucket_step_scale(cfg, u, theta_, grid, trig)

    def cost(u):
        return raw_cost(data, u, theta, grid, trig)

    def grad(u):
        return raw_grad(data, u, theta, grid, trig).reshape(u.shape)

    if step_length == 1:
        s = float(step_scale_op(obj, theta))
        step_length = s if np.isfinite(s) and s > 0 else 1.0
    obj, cost_d, _ = opt.conjugate_gradient(
        obj, cost_function=cost, grad=grad, num_iter=cg_iter, step_length=step_length
    )
    cost_value = float(cost_d)
    # The adapted step stays inside the inner iterations; each outer
    # iteration restarts from the estimated step, as in tike_tpu.
    logger.info("%10s cost is %+12.5e", "object", cost_value)
    return {"obj": obj, "cost": cost_value, "step_length": step_length}
