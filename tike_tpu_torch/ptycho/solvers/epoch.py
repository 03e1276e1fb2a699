"""One LSQML solver epoch as an eager PyTorch loop.

Counterpart of :mod:`tike_tpu.ptycho.solvers.fused`, which folds whole
epochs into one XLA program and therefore gates epoch-dependent steps with
traced ``jnp.where`` predicates. Here PyTorch runs eagerly, so the same
steps are plain Python ``if`` statements over the same math:

1. :func:`_epoch_begin_math`: the whole-epoch object preconditioner, in
   the gather or the FFT formulation;
2. :func:`_batch_update_math`: one LSQML mini-batch; in compact mode psi is
   fixed during the sweep and its updates are summed, while the probe, the
   eigen probes and the batch's eigen weights move every batch and the
   position gradients are summed;
3. :func:`_epoch_end_math`: the position step, then the summed object
   update, applied once with the mean object step, then the periodic
   mean-abs object/probe rescale.

Ported: compact batching, LSQML, object and probe recovery, shared probe
modes, eigen probes and weights (OPR), position correction with or without
adaptive moments, the Gaussian noise model,
``rescale_method='mean_of_abs_object'``, default probe and object
constraints (which are no-ops). Everything else raises in
``Reconstruction`` before an epoch starts. As in ``fused.py``, the LSQML
epoch does not constrain the eigen probes (``constrain_variable_probe``
runs only in the JAX package's per-epoch loop).
"""

from __future__ import annotations

import dataclasses
import typing

import torch

from ... import linalg, opt
from ...ops.ptycho import PtychoConfig
from ._preconditioner import _psi_precond_fft_math, _psi_precond_math
from .lstsq import (
    _POS_EDGE,
    _fz,
    _lstsq_batch_math,
    _precondition_object_update,
    _trim_mean,
)


@dataclasses.dataclass(frozen=True)
class EpochPlan:
    """Static configuration of an LSQML epoch."""

    cfg: PtychoConfig
    noise_model: str
    steplength_usemodes: str
    recover_psi: bool
    recover_probe: bool
    # probe update schedule
    update_start: int
    update_period: int
    # rescale
    rescale_mean_abs: bool
    rescale_period: int
    # FFT-formulation preconditioners (exact; see _preconditioner.py)
    fft_precond: bool = False
    # eigen weights (and perhaps eigen probes) are part of the state
    has_eigen: bool = False
    # position correction
    recover_positions: bool = False
    pos_update_start: int = 0
    pos_use_adaptive_moment: bool = False
    pos_vdecay: float = 0.999
    pos_mdecay: float = 0.9
    pos_update_magnitude_limit: float = 0.0

    def recover_now(self, total_e: int) -> bool:
        """Whether the probe is updated in epoch ``total_e``."""
        return total_e >= self.update_start and (
            total_e % self.update_period == 0
        )


@dataclasses.dataclass
class EpochState:
    """The solver state an epoch reads and returns, as device tensors.

    ``eigen_probe``/``eigen_weights`` are None without eigen probes or
    weights; ``pos_v``/``pos_m`` are the (N, 2) position AdaM moments, or
    None without ``use_adaptive_moment``.
    """

    psi: torch.Tensor
    probe: torch.Tensor
    scan: torch.Tensor
    eigen_probe: typing.Optional[torch.Tensor] = None
    eigen_weights: typing.Optional[torch.Tensor] = None
    pos_v: typing.Optional[torch.Tensor] = None
    pos_m: typing.Optional[torch.Tensor] = None


def _epoch_begin_math(plan: EpochPlan, psi, probe, scan, batch_idx, batch_mask):
    """Start of an epoch: probe power and the whole-epoch psi preconditioner.

    Returns ``(pwr (modes,), psi_pre (1, H, W) float32)``. The default probe
    constraints leave the probe unchanged. The probe preconditioner is not
    computed: only the rPIE update reads it, and the JAX package's compiled
    LSQML epoch drops it as dead code too.
    """
    cfg = plan.cfg
    pwr = torch.sum((probe * probe.conj()).real, dim=(-2, -1)).reshape(-1)
    psi_pre = torch.zeros(
        (1, cfg.nz, cfg.n), dtype=torch.float32, device=psi.device
    )
    if not plan.recover_psi:
        return pwr, psi_pre
    if plan.fft_precond:
        w_all = torch.zeros(scan.shape[0], dtype=torch.float32, device=psi.device)
        w_all.index_add_(0, batch_idx.reshape(-1), batch_mask.reshape(-1))
        return pwr, _psi_precond_fft_math(cfg, scan, probe, w_all)
    for idx, bmask in zip(batch_idx, batch_mask):
        psi_pre = psi_pre + _psi_precond_math(cfg, psi, scan[idx], probe, bmask)
    return pwr, psi_pre


def _batch_update_math(
    plan: EpochPlan,
    data_n,
    idx_n,
    mask_n,
    real_n,
    state: EpochState,
    psi_acc,
    pos_num,
    pos_den,
    psi_pre,
    exitwave_options,
    recover_now: bool,
    nb: int,
):
    """One compact-mode LSQML mini-batch against the epoch's preconditioner.

    ``real_n`` holds the slots of the batch with ``mask_n > 0``: the new
    eigen weights are written back through those alone. A padded slot
    repeats a real position's index, and a scatter with repeated indices
    leaves the write order undefined (``tike_tpu``'s ``.at[idx].set``
    lets the padded slot's stale copy win; see ROADMAP.md §3).

    Updates ``state.probe``, ``state.eigen_probe`` and
    ``state.eigen_weights`` in place of the old tensors, adds into
    ``pos_num``/``pos_den``, and returns ``(psi_acc, cost, beta_object)``:
    the running sum of object updates, the batch's masked mean cost and its
    object step (0-d tensors).
    """
    ew = exitwave_options
    out = _lstsq_batch_math(
        plan.cfg,
        data_n,
        state.scan,
        idx_n,
        mask_n,
        state.psi,
        state.probe,
        state.eigen_probe if plan.has_eigen else None,
        state.eigen_weights if plan.has_eigen else None,
        ew.measured_pixels,
        psi_pre,
        ew.step_length_start,
        ew.step_length_weight,
        ew.unmeasured_pixels_scaling,
        num_batch=float(nb),
        noise_model=plan.noise_model,
        steplength_usemodes=plan.steplength_usemodes,
        recover_psi=plan.recover_psi,
        recover_probe=plan.recover_probe,
        recover_positions=plan.recover_positions,
    )
    if plan.recover_positions:
        pos_num.index_add_(0, idx_n, out["pos_num"])
        pos_den.index_add_(0, idx_n, out["pos_den"])
    beta_obj = torch.zeros((), dtype=torch.float32, device=state.psi.device)
    if plan.recover_psi:
        # On epochs where probe recovery is gated off, use the uncoupled
        # object step.
        beta = out["beta_object"]
        if not recover_now and "beta_object_solo" in out:
            beta = out["beta_object_solo"]
        beta_obj = beta.to(torch.float32).reshape(())
        psi_acc = psi_acc + out["object_upd_sum"]
    if plan.recover_probe and recover_now:
        state.probe = state.probe + out["beta_probe"] * out["m_probe_update"]
        if plan.has_eigen:
            if out["eigen_probe"] is not None:
                state.eigen_probe = out["eigen_probe"]
            state.eigen_weights = state.eigen_weights.index_copy(
                0, idx_n[real_n], out["w_b"][real_n]
            )
    cost = torch.sum(out["costs"] * mask_n) / torch.clamp(
        torch.sum(mask_n), min=1
    )
    return psi_acc, cost, beta_obj


def _position_step(plan: EpochPlan, state: EpochState, pos_num, pos_den):
    """The once-per-epoch position update from the summed gradient terms.

    Clip to the magnitude limit, subtract the 5% trimmed mean (no global
    drift), optionally take the AdaM direction, then clamp the positions to
    ``check_allowed_positions``'s window ``[1, dim - P - 1/256]``.
    """
    cfg = plan.cfg
    palpha = 0.05
    step = pos_num / (
        (1 - palpha) * pos_den + palpha * torch.clamp(pos_den.max(), min=1e-6)
    )
    limit = plan.pos_update_magnitude_limit
    if limit > 0:
        step = torch.clamp(step, -limit, limit)
    step = step - _trim_mean(step, 0.05, dim=0)
    if plan.pos_use_adaptive_moment:
        step, state.pos_v, state.pos_m = opt.adam(
            step,
            state.pos_v,
            state.pos_m,
            vdecay=plan.pos_vdecay,
            mdecay=plan.pos_mdecay,
        )
    scan = state.scan - step
    state.scan = torch.stack(
        [
            torch.clamp(scan[:, 0], 1.0, cfg.nz - cfg.probe_shape - _POS_EDGE),
            torch.clamp(scan[:, 1], 1.0, cfg.n - cfg.probe_shape - _POS_EDGE),
        ],
        dim=-1,
    )


def _epoch_end_math(
    plan: EpochPlan,
    state: EpochState,
    psi_acc,
    pos_num,
    pos_den,
    beta_obj_mean,
    psi_pre,
    total_e: int,
):
    """The position step, the summed object update, then the periodic
    mean-abs rescale; updates ``state`` in place of the old tensors."""
    if plan.recover_positions and total_e >= plan.pos_update_start:
        _position_step(plan, state, pos_num, pos_den)
    if plan.recover_psi:
        psi = state.psi + _fz(
            beta_obj_mean * _precondition_object_update(psi_acc, psi_pre)
        )
        if plan.rescale_mean_abs and (total_e + 1) % plan.rescale_period == 0:
            W = psi_pre / linalg.mnorm(psi_pre)
            object_norm = 2 * torch.sqrt(
                torch.mean(torch.square(torch.abs(psi)) * W)
            )
            psi = psi / object_norm
            state.probe = state.probe * object_norm
        state.psi = psi


def _epoch_math(
    plan: EpochPlan,
    data,
    batch_idx,
    batch_mask,
    batch_real,
    state: EpochState,
    exitwave_options,
    total_e: int,
):
    """One full compact LSQML epoch; batches run in order 0..nb-1.

    data (nb, L, DET, DET) float32; batch_idx (nb, L) int64 and batch_mask
    (nb, L) float32 on the data's device; batch_real[n] the int64 slots of
    batch n with a mask above 0. Updates ``state`` and returns ``(epoch_cost,
    pwr)`` as device tensors.
    """
    nb = batch_idx.shape[0]
    recover_now = plan.recover_now(total_e)
    pwr, psi_pre = _epoch_begin_math(
        plan, state.psi, state.probe, state.scan, batch_idx, batch_mask
    )
    psi_acc = torch.zeros_like(state.psi)
    pos_num = pos_den = None
    if plan.recover_positions:
        pos_num = torch.zeros_like(state.scan)
        pos_den = torch.zeros_like(state.scan)
    costs, betas = [], []
    for n in range(nb):
        psi_acc, cost, beta_obj = _batch_update_math(
            plan,
            data[n],
            batch_idx[n],
            batch_mask[n],
            batch_real[n],
            state,
            psi_acc,
            pos_num,
            pos_den,
            psi_pre,
            exitwave_options,
            recover_now,
            nb,
        )
        costs.append(cost)
        betas.append(beta_obj)
    _epoch_end_math(
        plan,
        state,
        psi_acc,
        pos_num,
        pos_den,
        torch.stack(betas).mean(),
        psi_pre,
        total_e,
    )
    return torch.stack(costs).mean(), pwr
