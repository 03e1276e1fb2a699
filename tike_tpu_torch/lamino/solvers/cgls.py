"""CGLS solver for laminography (PyTorch).

Counterpart of :mod:`tike_tpu.lamino.solvers.cgls`. The laminography
forward model is linear, so CGLS needs one forward and one exact adjoint
(:func:`~tike_tpu_torch.ops.lamino.lamino_adj_exact`) per inner step with
optimal step lengths: no backtracking and no host read until the cost.
"""

from __future__ import annotations

import logging

from ... import opt
from ...ops.lamino import LaminoConfig, LaminoPlan, lamino_adj_exact, lamino_fwd

logger = logging.getLogger(__name__)


def cgls(
    cfg: LaminoConfig,
    data,
    theta,
    obj,
    cg_iter=4,
    plan=None,
    **kwargs,
):
    """One outer iteration (``cg_iter`` CGLS steps). Returns ``{"obj",
    "cost"}``, the cost a float. ``plan`` is the geometry's
    :class:`~tike_tpu_torch.ops.lamino.LaminoPlan`, if the caller keeps
    one."""
    plan = LaminoPlan(cfg, theta) if plan is None else plan
    # CGLS requires the true adjoint: lamino_adj drifts ~20% from
    # adjointness at upsample=1, which makes optimal-step CG diverge.
    obj, cost = opt.cgls(
        fwd=lambda u: lamino_fwd(cfg, u, theta, plan),
        adj=lambda r: lamino_adj_exact(cfg, r, theta, plan),
        b=data,
        x0=obj,
        num_iter=cg_iter,
    )
    cost = float(cost)
    logger.info("%10s cost is %+12.5e", "object", cost)
    return {"obj": obj, "cost": cost}
