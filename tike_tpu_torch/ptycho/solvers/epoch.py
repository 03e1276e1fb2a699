"""One LSQML solver epoch as an eager PyTorch loop.

Counterpart of :mod:`tike_tpu.ptycho.solvers.fused`, which folds whole
epochs into one XLA program and therefore gates epoch-dependent steps with
traced ``jnp.where`` predicates. Here PyTorch runs eagerly, so the same
steps are plain Python ``if`` statements over the same math:

1. :func:`_epoch_begin_math`: the whole-epoch object preconditioner, in
   the gather or the FFT formulation;
2. :func:`_batch_update_math`: one LSQML mini-batch; in compact mode psi is
   fixed during the sweep and its updates are summed, while the probe moves
   every batch;
3. :func:`_epoch_end_math`: the summed object update, applied once with the
   mean object step, then the periodic mean-abs object/probe rescale.

Ported: compact batching, LSQML, object and probe recovery, the Gaussian
noise model, ``rescale_method='mean_of_abs_object'``, default probe and
object constraints (which are no-ops). Everything else raises in
``Reconstruction`` before an epoch starts.
"""

from __future__ import annotations

import dataclasses

import torch

from ... import linalg
from ...ops.ptycho import PtychoConfig
from ._preconditioner import _psi_precond_fft_math, _psi_precond_math
from .lstsq import _fz, _lstsq_batch_math, _precondition_object_update


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

    def recover_now(self, total_e: int) -> bool:
        """Whether the probe is updated in epoch ``total_e``."""
        return total_e >= self.update_start and (
            total_e % self.update_period == 0
        )


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
    scan,
    idx_n,
    mask_n,
    psi,
    probe,
    psi_acc,
    psi_pre,
    exitwave_options,
    recover_now: bool,
    nb: int,
):
    """One compact-mode LSQML mini-batch against the epoch's preconditioner.

    Returns ``(probe, psi_acc, cost, beta_object)``: the probe after this
    batch's step, the running sum of object updates, the batch's masked
    mean cost and its object step (0-d tensors).
    """
    ew = exitwave_options
    out = _lstsq_batch_math(
        plan.cfg,
        data_n,
        scan,
        idx_n,
        mask_n,
        psi,
        probe,
        None,
        None,
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
        recover_positions=False,
    )
    beta_obj = torch.zeros((), dtype=torch.float32, device=psi.device)
    if plan.recover_psi:
        # On epochs where probe recovery is gated off, use the uncoupled
        # object step.
        beta = out["beta_object"]
        if not recover_now and "beta_object_solo" in out:
            beta = out["beta_object_solo"]
        beta_obj = beta.to(torch.float32).reshape(())
        psi_acc = psi_acc + out["object_upd_sum"]
    if plan.recover_probe and recover_now:
        probe = probe + out["beta_probe"] * out["m_probe_update"]
    cost = torch.sum(out["costs"] * mask_n) / torch.clamp(
        torch.sum(mask_n), min=1
    )
    return probe, psi_acc, cost, beta_obj


def _epoch_end_math(
    plan: EpochPlan, psi, probe, psi_acc, beta_obj_mean, psi_pre, total_e: int
):
    """Apply the summed object update, then the periodic mean-abs rescale."""
    if plan.recover_psi:
        psi = psi + _fz(
            beta_obj_mean * _precondition_object_update(psi_acc, psi_pre)
        )
        if plan.rescale_mean_abs and (total_e + 1) % plan.rescale_period == 0:
            W = psi_pre / linalg.mnorm(psi_pre)
            object_norm = 2 * torch.sqrt(
                torch.mean(torch.square(torch.abs(psi)) * W)
            )
            psi = psi / object_norm
            probe = probe * object_norm
    return psi, probe


def _epoch_math(
    plan: EpochPlan,
    data,
    scan,
    batch_idx,
    batch_mask,
    psi,
    probe,
    exitwave_options,
    total_e: int,
):
    """One full compact LSQML epoch; batches run in order 0..nb-1.

    data (nb, L, DET, DET) float32; batch_idx (nb, L) int64 and batch_mask
    (nb, L) float32 on the data's device. Returns ``(psi, probe,
    epoch_cost, pwr)`` with the cost and probe power as device tensors.
    """
    nb = batch_idx.shape[0]
    recover_now = plan.recover_now(total_e)
    pwr, psi_pre = _epoch_begin_math(
        plan, psi, probe, scan, batch_idx, batch_mask
    )
    psi_acc = torch.zeros_like(psi)
    costs, betas = [], []
    for n in range(nb):
        probe, psi_acc, cost, beta_obj = _batch_update_math(
            plan,
            data[n],
            scan,
            batch_idx[n],
            batch_mask[n],
            psi,
            probe,
            psi_acc,
            psi_pre,
            exitwave_options,
            recover_now,
            nb,
        )
        costs.append(cost)
        betas.append(beta_obj)
    psi, probe = _epoch_end_math(
        plan, psi, probe, psi_acc, torch.stack(betas).mean(), psi_pre, total_e
    )
    return psi, probe, torch.stack(costs).mean(), pwr
