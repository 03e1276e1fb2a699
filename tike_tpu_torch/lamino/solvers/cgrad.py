"""Conjugate-gradient solver for laminography (PyTorch).

Counterpart of :mod:`tike_tpu.lamino.solvers.cgrad`: Dai-Yuan directions
and a backtracking line search on the least-squares cost, with the
gradient through :func:`~tike_tpu_torch.ops.lamino.lamino_adj`. ``tike_tpu``
traces the whole outer iteration into one device program; here it is an
eager loop, and each line-search trial reads one comparison back to the
host (``tike_tpu_torch.opt.HOST_READS``).
"""

from __future__ import annotations

import logging

import numpy as np

from ... import opt
from ...ops.lamino import (
    LaminoConfig,
    LaminoPlan,
    lamino_cost,
    lamino_grad,
    lamino_step_scale,
)

logger = logging.getLogger(__name__)


def _estimate_step_length(obj, theta, cfg, plan=None):
    """Step-length scale 2|A*A u| / |u|; 1 where that is not a positive
    number (a zero object gives 0)."""
    s = float(lamino_step_scale(cfg, obj, theta, plan))
    return s if np.isfinite(s) and s > 0 else 1.0


def cgrad(
    cfg: LaminoConfig,
    data,
    theta,
    obj,
    cg_iter=4,
    step_length=1,
    plan=None,
    **kwargs,
):
    """One outer iteration (``cg_iter`` CG steps) for the laminography
    problem. Returns ``{"obj", "cost", "step_length"}``: the cost a float,
    the step length the one this iteration started from. ``plan`` is the
    geometry's :class:`~tike_tpu_torch.ops.lamino.LaminoPlan`, if the
    caller keeps one."""
    plan = LaminoPlan(cfg, theta) if plan is None else plan
    if step_length == 1:
        step_length = _estimate_step_length(obj, theta, cfg, plan)
    obj, cost, _ = opt.conjugate_gradient(
        obj,
        cost_function=lambda u: lamino_cost(cfg, data, theta, u, plan),
        grad=lambda u: lamino_grad(cfg, data, theta, u, plan),
        num_iter=cg_iter,
        step_length=step_length,
    )
    cost = float(cost)
    # The adapted step stays inside the inner iterations; each outer
    # iteration restarts from the estimated step, as in tike_tpu.
    logger.info("%10s cost is %+12.5e", "object", cost)
    return {"obj": obj, "cost": cost, "step_length": step_length}
