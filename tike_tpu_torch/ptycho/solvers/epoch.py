"""One rPIE or LSQML solver epoch as an eager PyTorch loop.

Counterpart of :mod:`tike_tpu.ptycho.solvers.fused`, which folds whole
epochs into one XLA program and therefore gates epoch-dependent steps with
traced ``jnp.where`` predicates. Here PyTorch runs eagerly, so the same
steps are plain Python ``if`` statements over the same math, which is
bitwise the same where the gate is 0 or 1:

1. :func:`_epoch_begin_math`: the probe constraints (applied on
   probe-recovery epochs), the probe power, the periodic
   ``constant_probe_photons`` rescale, and the whole-epoch object and
   probe preconditioners, in the gather or the FFT formulation;
2. :func:`_batch_update_math`: one mini-batch. In compact mode psi is
   fixed during the sweep and the updates are summed; otherwise each batch
   steps psi (rPIE with optional AdaM, LSQML with optional momentum). The
   probe, the eigen probes and the batch's eigen weights move every batch,
   except rPIE's compact probe, which moves at the epoch end;
3. :func:`_epoch_end_math`: the position step, the compact updates with
   their checked momenta, the eigen-weight normalisation (rPIE), the
   object constraints, then the periodic mean-abs object/probe rescale.

Batches run in the order the caller gives: 0..nb-1 in compact mode, a
permutation drawn per epoch otherwise. Moment states advance as in
``fused.py``: the object's every epoch, the probe's only on probe-recovery
epochs. As in ``fused.py``, the epoch does not constrain the eigen probes
(``constrain_variable_probe`` runs only in the JAX package's per-epoch
loop).
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from ... import linalg, opt
from ...ops.ptycho import PtychoConfig
from .. import object as object_module
from .. import probe as probe_module
from ._preconditioner import (
    _probe_precond_fft_math,
    _probe_precond_math,
    _psi_precond_fft_math,
    _psi_precond_math,
)
from .lstsq import (
    _POS_EDGE,
    _fz,
    _lstsq_batch_math,
    _precondition_object_update,
    _trim_mean,
)
from .rpie import _batch_gradients_math, _normalize_eigen_weights


@dataclasses.dataclass(frozen=True)
class EpochPlan:
    """Static configuration of an rPIE or LSQML epoch."""

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
    solver: str = "lstsq"  # 'lstsq' | 'rpie'
    compact: bool = True
    # FFT-formulation preconditioners (exact; see _preconditioner.py)
    fft_precond: bool = False
    # eigen weights (and perhaps eigen probes) are part of the state
    has_eigen: bool = False
    # probe constraints
    probe_support: float = 0.0
    probe_support_radius: float = 0.35
    probe_support_degree: float = 2.5
    additional_probe_penalty: float = 0.0
    median_filter: bool = False
    median_filter_px: tuple = (1.0, 1.0)
    force_center: bool = False
    force_sparsity: float = 0.0
    force_orthogonality: bool = False
    # object constraints
    positivity: float = 0.0
    smoothness: float = 0.0
    clip_magnitude: bool = False
    # rPIE's step-length control
    alpha: float = 0.05
    # rescale_method='constant_probe_photons': the photon count, or 0 (off)
    rescale_photons: float = 0.0
    # adaptive moments: obj none | adam | momentum | checked;
    # probe none | adam | checked
    obj_moment: str = "none"
    probe_moment: str = "none"
    obj_vdecay: float = 0.999
    obj_mdecay: float = 0.9
    probe_vdecay: float = 0.999
    probe_mdecay: float = 0.9
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
    None without ``use_adaptive_moment``. ``obj_v``/``obj_m`` and
    ``probe_v``/``probe_m`` are the object and probe moment states of the
    plan's moment kinds (None where a kind keeps none), and ``err_hist``
    the (3,) tail of the epoch-cost series that the checked momenta read.
    """

    psi: torch.Tensor
    probe: torch.Tensor
    scan: torch.Tensor
    eigen_probe: typing.Optional[torch.Tensor] = None
    eigen_weights: typing.Optional[torch.Tensor] = None
    pos_v: typing.Optional[torch.Tensor] = None
    pos_m: typing.Optional[torch.Tensor] = None
    obj_v: typing.Optional[torch.Tensor] = None
    obj_m: typing.Optional[torch.Tensor] = None
    probe_v: typing.Optional[torch.Tensor] = None
    probe_m: typing.Optional[torch.Tensor] = None
    err_hist: typing.Optional[torch.Tensor] = None


@dataclasses.dataclass
class _Sums:
    """What the batches of one epoch add up: the compact object and probe
    updates, the position gradient terms, and LSQML's mean probe step and
    step size for its checked probe momentum."""

    psi: typing.Optional[torch.Tensor] = None
    probe: typing.Optional[torch.Tensor] = None
    pos_num: typing.Optional[torch.Tensor] = None
    pos_den: typing.Optional[torch.Tensor] = None
    pcomb: typing.Optional[torch.Tensor] = None
    pbeta: typing.Optional[torch.Tensor] = None


def seed_err_hist(prev_costs) -> np.ndarray:
    """(3,) tail of the epoch-cost series, right-aligned before the
    current slot: the checked momentum reads the last three costs after
    the epoch end appends the current one."""
    eh = np.full(3, np.inf, np.float32)
    tail = list(prev_costs)[-2:]
    if len(tail) >= 1:
        eh[2] = tail[-1]
    if len(tail) >= 2:
        eh[1] = tail[-2]
    return eh


def _probe_constraints_math(plan: EpochPlan, probe):
    """The per-epoch probe constraints, in the JAX package's order, and the
    constrained probe's mode powers (sorted when orthogonalized)."""
    if plan.probe_support > 0:
        b0 = probe_module.finite_probe_support(
            probe,
            p=plan.probe_support,
            radius=plan.probe_support_radius,
            degree=plan.probe_support_degree,
        )
        probe = probe - b0 * torch.conj(b0 * probe)
    if plan.additional_probe_penalty > 0:
        b1 = plan.additional_probe_penalty * torch.linspace(
            0, 1, probe.shape[-3], dtype=torch.float32, device=probe.device
        )[..., None, None]
        probe = probe - b1 * torch.conj(b1 * probe)
    if plan.median_filter:
        probe = probe_module.apply_median_filter_abs_probe(
            probe, med_filt_px=plan.median_filter_px
        )
    if plan.force_center:
        probe = probe_module.constrain_center_peak(probe)
    if plan.force_sparsity < 1:
        probe = probe_module.constrain_probe_sparsity(probe, f=plan.force_sparsity)
    if plan.force_orthogonality:
        return probe_module._orthogonalize_eig_body(probe)
    return probe, probe_module.power(probe)


def _epoch_begin_math(
    plan: EpochPlan, state: EpochState, batch_idx, batch_mask, recover_now, total_e
):
    """Start of an epoch: the probe constraints and rescale (into
    ``state.probe``) and the whole-epoch preconditioners.

    Returns ``(pwr (modes,), psi_pre (1, H, W), probe_pre (1, P, P) or
    None)``. As in ``fused.py``, ``pwr`` is the power of the constrained
    probe even on epochs where the constraints are not applied, so the
    constraints run whenever the probe is recovered. Only rPIE reads the
    probe preconditioner; the LSQML epoch does not compute it.
    """
    cfg = plan.cfg
    probe = state.probe
    if plan.recover_probe:
        constrained, pwr = _probe_constraints_math(plan, probe)
        if recover_now:
            probe = constrained
    else:
        pwr = probe_module.power(probe)
    if plan.rescale_photons > 0 and total_e % plan.rescale_period == 0:
        probe = probe_module.rescale_probe_using_fixed_intensity_photons(
            probe, Nphotons=plan.rescale_photons
        )
    state.probe = probe

    psi, scan = state.psi, state.scan
    want_probe_pre = plan.solver == "rpie" and plan.recover_probe
    psi_pre = torch.zeros((1, cfg.nz, cfg.n), dtype=torch.float32, device=psi.device)
    probe_pre = None
    if plan.fft_precond:
        w_all = torch.zeros(scan.shape[0], dtype=torch.float32, device=psi.device)
        w_all.index_add_(0, batch_idx.reshape(-1), batch_mask.reshape(-1))
        if plan.recover_psi:
            psi_pre = _psi_precond_fft_math(cfg, scan, probe, w_all)
        if want_probe_pre:
            probe_pre = _probe_precond_fft_math(cfg, psi, scan, w_all)
        return pwr, psi_pre, probe_pre
    if want_probe_pre:
        probe_pre = torch.zeros(
            (1, cfg.probe_shape, cfg.probe_shape), dtype=torch.float32,
            device=psi.device,
        )
    for idx, bmask in zip(batch_idx, batch_mask):
        if plan.recover_psi:
            psi_pre = psi_pre + _psi_precond_math(cfg, psi, scan[idx], probe, bmask)
        if want_probe_pre:
            probe_pre = probe_pre + _probe_precond_math(cfg, psi, scan[idx], bmask)
    return pwr, psi_pre, probe_pre


def _rpie_denominator(pre, alpha: float, dims):
    """rPIE's ``(1 - alpha) * pre + alpha * max(pre)``, the max over ``dims``."""
    return (1 - alpha) * pre + alpha * torch.amax(torch.abs(pre), dim=dims, keepdim=True)


def _lstsq_batch(plan, out, state, sums, idx_n, real_n, recover_now, nb):
    """Apply one LSQML batch's result ``out``; return its object step."""
    if plan.recover_positions:
        sums.pos_num.index_add_(0, idx_n, out["pos_num"])
        sums.pos_den.index_add_(0, idx_n, out["pos_den"])
    beta_obj = torch.zeros((), dtype=torch.float32, device=state.psi.device)
    if plan.recover_psi:
        # On epochs where probe recovery is gated off, use the uncoupled
        # object step.
        beta = out["beta_object"]
        if not recover_now and "beta_object_solo" in out:
            beta = out["beta_object_solo"]
        beta_obj = beta.to(torch.float32).reshape(())
        if plan.compact:
            sums.psi = sums.psi + out["object_upd_sum"]
        else:
            dpsi = _fz(beta * out["object_update_precond"])
            if plan.obj_moment == "momentum":
                dpsi, _, state.obj_m = opt.momentum(
                    dpsi, None, state.obj_m, mdecay=plan.obj_mdecay
                )
            state.psi = state.psi + dpsi
    if plan.recover_probe:
        dprobe = out["beta_probe"] * out["m_probe_update"]
        if recover_now:
            state.probe = state.probe + dprobe
        if plan.probe_moment == "checked":
            sums.pcomb = sums.pcomb + dprobe / nb
            sums.pbeta = sums.pbeta + torch.mean(out["beta_probe"])
        if plan.has_eigen and recover_now:
            if out["eigen_probe"] is not None:
                state.eigen_probe = out["eigen_probe"]
            state.eigen_weights = state.eigen_weights.index_copy(
                0, idx_n[real_n], out["w_b"][real_n]
            )
    return beta_obj


def _rpie_batch(plan, nums, state, sums, idx_n, psi_pre, probe_pre, recover_now):
    """Apply one rPIE batch's numerators ``(psi_num, probe_num,
    eigen_delta)``."""
    psi_num, probe_num, eigen_delta = nums
    if plan.has_eigen and eigen_delta is not None and recover_now:
        # An add through the batch's indices: a padded slot repeats a real
        # index and adds its masked delta, 0.
        w = state.eigen_weights.clone()
        w[:, 0, 0].index_add_(0, idx_n, eigen_delta)
        state.eigen_weights = w
    if plan.compact:
        sums.psi = sums.psi + psi_num
        sums.probe = sums.probe + probe_num
        return
    if plan.recover_psi:
        deno = _rpie_denominator(psi_pre, plan.alpha, (-2, -1))
        state.psi = state.psi + _fz(psi_num / deno)
        if plan.obj_moment == "adam":
            # Both the plain and the AdaM step are added, as in fused.py.
            d2, state.obj_v, state.obj_m = opt.adam(
                psi_num,
                state.obj_v,
                state.obj_m,
                vdecay=plan.obj_vdecay,
                mdecay=plan.obj_mdecay,
            )
            state.psi = state.psi + _fz(d2 / deno)
    if plan.recover_probe and recover_now:
        ppre = torch.abs(probe_pre[0])
        pdeno = (1 - plan.alpha) * ppre + plan.alpha * ppre.max()
        probe = state.probe + _fz(probe_num[0] / pdeno)
        if plan.probe_moment == "adam":
            # Mode 0 alone, as in fused.py.
            d2, state.probe_v, state.probe_m = opt.adam(
                probe_num[0][0, 0, 0],
                state.probe_v,
                state.probe_m,
                vdecay=plan.probe_vdecay,
                mdecay=plan.probe_mdecay,
            )
            probe = probe.clone()
            probe[0, 0, 0] += d2 / pdeno
        state.probe = probe


def _batch_update_math(
    plan: EpochPlan,
    data_n,
    idx_n,
    mask_n,
    real_n,
    state: EpochState,
    sums: _Sums,
    psi_pre,
    probe_pre,
    exitwave_options,
    recover_now: bool,
    nb: int,
):
    """One mini-batch against the epoch's preconditioners.

    ``real_n`` holds the slots of the batch with ``mask_n > 0``: LSQML's
    new eigen weights are written back through those alone. A padded slot
    repeats a real position's index, and a scatter with repeated indices
    leaves the write order undefined (``tike_tpu``'s ``.at[idx].set``
    lets the padded slot's stale copy win; see ROADMAP.md §3).

    Updates ``state`` in place of the old tensors and adds into ``sums``;
    returns ``(cost, beta_object)``, the batch's masked mean cost and its
    LSQML object step (0 for rPIE), as 0-d tensors.
    """
    ew = exitwave_options
    args = (
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
    )
    steps = (ew.step_length_start, ew.step_length_weight, ew.unmeasured_pixels_scaling)
    modes = dict(
        noise_model=plan.noise_model, steplength_usemodes=plan.steplength_usemodes
    )
    if plan.solver == "lstsq":
        out = _lstsq_batch_math(
            *args,
            psi_pre,
            *steps,
            num_batch=float(nb),
            recover_psi=plan.recover_psi,
            recover_probe=plan.recover_probe,
            recover_positions=plan.recover_positions,
            **modes,
        )
        costs = out["costs"]
        beta_obj = _lstsq_batch(plan, out, state, sums, idx_n, real_n, recover_now, nb)
    else:
        costs, *nums = _batch_gradients_math(
            *args, *steps, recover_probe=plan.recover_probe, **modes
        )
        _rpie_batch(plan, nums, state, sums, idx_n, psi_pre, probe_pre, recover_now)
        beta_obj = torch.zeros((), dtype=torch.float32, device=state.psi.device)
    cost = torch.sum(costs * mask_n) / torch.clamp(torch.sum(mask_n), min=1)
    return cost, beta_obj


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


def _checked(plan: EpochPlan, state: EpochState, g, which: str, total_e, beta=1.0):
    """``momentum_checked_traced`` on the ``which`` ('obj' or 'probe')
    moment states; returns the new states and the direction."""
    v, m = getattr(state, which + "_v"), getattr(state, which + "_m")
    d, v, m = opt.momentum_checked_traced(
        g, v, m, getattr(plan, which + "_mdecay"), state.err_hist, total_e + 1,
        beta=beta,
    )
    return d, v, m


def _compact_end(plan, state, sums, beta_obj_mean, psi_pre, probe_pre, recover_now, total_e):
    """Apply the summed updates of a compact epoch, with their checked
    momenta."""
    if plan.solver == "lstsq":
        if plan.recover_psi:
            dpsi = _fz(beta_obj_mean * _precondition_object_update(sums.psi, psi_pre))
            state.psi = state.psi + dpsi
            if plan.obj_moment == "checked":
                d2, state.obj_v, state.obj_m = _checked(
                    plan, state, dpsi, "obj", total_e, beta=beta_obj_mean
                )
                W = torch.abs(psi_pre)
                state.psi = state.psi + _fz((W / (0.1 * W.max() + W)) * d2)
        return
    if plan.recover_psi:
        deno = _rpie_denominator(psi_pre, plan.alpha, (-2, -1))
        state.psi = state.psi + _fz(sums.psi / deno)
        if plan.obj_moment == "checked":
            d2, state.obj_v, state.obj_m = _checked(plan, state, sums.psi, "obj", total_e)
            state.psi = state.psi + _fz(d2 / deno)
    if plan.recover_probe and recover_now:
        ppre = torch.abs(probe_pre[0])
        pdeno = (1 - plan.alpha) * ppre + plan.alpha * ppre.max()
        probe = state.probe + _fz(sums.probe[0] / pdeno)
        if plan.probe_moment == "checked":
            # Mode 0 alone, as in fused.py.
            d2, state.probe_v, state.probe_m = _checked(
                plan, state, sums.probe[0][0, 0, 0], "probe", total_e
            )
            probe = probe.clone()
            probe[0, 0, 0] += d2 / pdeno
        state.probe = probe


def _epoch_end_math(
    plan: EpochPlan,
    state: EpochState,
    sums: _Sums,
    beta_obj_mean,
    psi_pre,
    probe_pre,
    recover_now: bool,
    total_e: int,
    nb: int,
):
    """Everything after the batch sweep; updates ``state`` in place of the
    old tensors. ``state.err_hist`` already ends with this epoch's cost."""
    if plan.recover_positions and total_e >= plan.pos_update_start:
        _position_step(plan, state, sums.pos_num, sums.pos_den)
    if plan.compact:
        _compact_end(
            plan, state, sums, beta_obj_mean, psi_pre, probe_pre, recover_now, total_e
        )
    if (
        plan.solver == "lstsq"
        and plan.recover_probe
        and plan.probe_moment == "checked"
        and recover_now
    ):
        # The mean probe step of the epoch, main mode only, compact or not.
        d2, state.probe_v, state.probe_m = _checked(
            plan, state, sums.pcomb[..., 0, :, :], "probe", total_e,
            beta=sums.pbeta / nb,
        )
        probe = state.probe.clone()
        probe[..., 0, :, :] += d2
        state.probe = probe
    if plan.has_eigen and plan.solver == "rpie":
        state.eigen_weights = _normalize_eigen_weights(state.eigen_weights)
    if not plan.recover_psi:
        return
    psi = state.psi
    if plan.positivity:
        psi = object_module.positivity_constraint(psi, r=plan.positivity)
    if plan.smoothness:
        psi = object_module.smoothness_constraint(psi, a=plan.smoothness)
    if plan.clip_magnitude:
        psi = object_module.clip_magnitude(psi, a_max=1.0)
    if plan.rescale_mean_abs and (total_e + 1) % plan.rescale_period == 0:
        W = psi_pre / linalg.mnorm(psi_pre)
        object_norm = 2 * torch.sqrt(torch.mean(torch.square(torch.abs(psi)) * W))
        psi = psi / object_norm
        state.probe = state.probe * object_norm
    state.psi = psi


def _epoch_math(
    plan: EpochPlan,
    data,
    batch_idx,
    batch_mask,
    batch_real,
    order,
    state: EpochState,
    exitwave_options,
    total_e: int,
):
    """One full epoch, its batches in ``order``.

    data (nb, L, DET, DET) float32; batch_idx (nb, L) int64 and batch_mask
    (nb, L) float32 on the data's device; batch_real[n] the int64 slots of
    batch n with a mask above 0; order a sequence of the nb batch numbers.
    Updates ``state`` and returns ``(epoch_cost, pwr)`` as device tensors;
    the epoch cost is the mean of the batch costs taken in batch order.
    """
    nb = batch_idx.shape[0]
    recover_now = plan.recover_now(total_e)
    pwr, psi_pre, probe_pre = _epoch_begin_math(
        plan, state, batch_idx, batch_mask, recover_now, total_e
    )
    sums = _Sums()
    if plan.compact:
        sums.psi = torch.zeros_like(state.psi)
        if plan.solver == "rpie":
            sums.probe = torch.zeros(
                (1, *state.probe.shape), dtype=state.probe.dtype, device=state.probe.device
            )
    if plan.recover_positions:
        sums.pos_num = torch.zeros_like(state.scan)
        sums.pos_den = torch.zeros_like(state.scan)
    if plan.solver == "lstsq" and plan.probe_moment == "checked":
        sums.pcomb = torch.zeros_like(state.probe)
        sums.pbeta = torch.zeros((), dtype=torch.float32, device=state.probe.device)
    costs, betas = [None] * nb, []
    for n in order:
        costs[n], beta_obj = _batch_update_math(
            plan,
            data[n],
            batch_idx[n],
            batch_mask[n],
            batch_real[n],
            state,
            sums,
            psi_pre,
            probe_pre,
            exitwave_options,
            recover_now,
            nb,
        )
        betas.append(beta_obj)
    epoch_cost = torch.stack(costs).mean()
    if state.err_hist is not None:
        state.err_hist = torch.cat([state.err_hist[1:], epoch_cost.reshape(1)])
    _epoch_end_math(
        plan,
        state,
        sums,
        torch.stack(betas).mean(),
        psi_pre,
        probe_pre,
        recover_now,
        total_e,
        nb,
    )
    return epoch_cost, pwr
