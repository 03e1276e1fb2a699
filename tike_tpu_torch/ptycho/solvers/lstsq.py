"""Least-squares maximum-likelihood (LSQML) mini-batch math.

Counterpart of :mod:`tike_tpu.ptycho.solvers.lstsq` (Odstrcil, Menzel,
Guizar-Sicairos 2018, Optics Express): object and probe updated together
with jointly-optimal step sizes from a per-position 2x2 least-squares
solve. Single slice, Gaussian noise model, no eigen probes and no position
correction; each of those raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from ...ops.objective import ELEMENTWISE, GRAD
from ...ops.patch import patch_adj, patch_fwd
from ...ops.propagation import propagation_adj, propagation_fwd
from ...ops.ptycho import PtychoConfig, _crop_from_detector, _pad_to_detector


def _fz(x: torch.Tensor) -> torch.Tensor:
    """Replace non-finite entries with 0 (degenerate-batch 0/0 guards)."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def _masked_mean_each_pattern(elem, pixel_mask):
    """Per-pattern mean over measured pixels only.

    Counterpart of ``tike_tpu.ptycho.solvers.rpie._masked_mean_each_pattern``.
    """
    w = pixel_mask.to(elem.dtype)
    return torch.sum(elem * w, dim=(-2, -1)) / torch.sum(w)


def _precondition_object_update(
    object_upd_sum, psi_update_denominator, alpha: float = 0.05
):
    """Divide by the smoothed illumination magnitude."""
    d = torch.abs(psi_update_denominator)
    dmax = torch.amax(d, dim=(-2, -1), keepdim=True)
    return object_upd_sum / torch.sqrt(
        torch.square((1 - alpha) * d) + torch.square(alpha * dmax)
    )


def _lstsq_batch_math(
    cfg: PtychoConfig,
    data_b,
    scan,
    idx,
    bmask,
    psi,
    probe,
    eigen_probe,
    eigen_weights,
    measured_pixels,
    psi_preconditioner,
    step_length_start,
    step_length_weight,
    unmeasured_pixels_scaling,
    *,
    num_batch: float,
    noise_model: str,
    steplength_usemodes: str,
    recover_psi: bool,
    recover_probe: bool,
    recover_positions: bool,
):
    """One LSQML mini-batch: gradients and optimal step sizes.

    Same signature and returned dict as the JAX function, for the
    ``recover_psi``/``recover_probe`` branches: ``costs`` (B,),
    ``object_upd_sum`` (1, H, W), ``object_update_precond``,
    ``m_probe_update`` (1, 1, M, P, P), ``beta_object`` (1,),
    ``beta_object_solo`` (1,) and ``beta_probe`` (1, 1, 1, 1).
    ``step_length_*`` belong to the Poisson model and are unused here.
    """
    if eigen_probe is not None or eigen_weights is not None:
        raise NotImplementedError("eigen probes are not ported yet")
    if recover_positions:
        raise NotImplementedError("position correction is not ported yet")
    if noise_model != "gaussian":
        raise NotImplementedError(
            f"the {noise_model!r} LSQML step is not ported yet"
        )
    nmodes = probe.shape[-3]
    m = 0  # the mode used for the step-size solves
    scan_b = scan[idx]
    p = cfg.probe_shape
    unique_probe = probe.expand(scan_b.shape[0], 1, nmodes, p, p)

    # Forward model (single slice).
    patches2d = patch_fwd(psi[0], scan_b, p)  # (B, P, P)
    nearplane = patches2d[:, None, None] * unique_probe  # (B, 1, M, P, P)
    farplane = propagation_fwd(_pad_to_detector(nearplane, cfg))
    intensity = torch.sum(torch.square(torch.abs(farplane)), dim=(1, 2))

    costs = _masked_mean_each_pattern(
        ELEMENTWISE[noise_model](data_b, intensity), measured_pixels
    )
    update = -GRAD[noise_model](data_b, farplane, intensity)
    chi_far = torch.where(
        measured_pixels, update, farplane * (unmeasured_pixels_scaling - 1.0)
    )
    chi = _crop_from_detector(propagation_adj(chi_far), cfg)  # (B,1,M,P,P)
    chi = chi * bmask[:, None, None, None, None]

    out = {"costs": costs}

    # (24b)/(25b) object gradient: sum over modes and positions.
    if recover_psi:
        object_update_proj = unique_probe.conj() * chi
        object_upd_sum = patch_adj(
            torch.sum(object_update_proj[:, 0], dim=1),
            scan_b,
            (cfg.nz, cfg.n),
        )[None]
        out["object_upd_sum"] = object_upd_sum

    # (24a)/(25a) probe gradient: simple average over batch.
    bpatches = patches2d[:, None, None]  # (B, 1, 1, P, P)
    if recover_probe:
        bprobe_update = bpatches.conj() * chi  # (B, 1, M, P, P)
        m_probe_update = (
            torch.sum(bprobe_update, dim=0, keepdim=True) / num_batch
        )  # (1, 1, M, P, P)
        out["m_probe_update"] = m_probe_update

    # Optimal step sizes.
    eps = 1e-9 / (p * p)
    if recover_psi:
        object_update_precond = _precondition_object_update(
            object_upd_sum, psi_preconditioner
        )
        out["object_update_precond"] = object_update_precond
        proj = patch_fwd(object_update_precond[0], scan_b, p)
        dOP = proj[:, None, None] * unique_probe[..., m : m + 1, :, :]
        A1 = torch.sum((dOP * dOP.conj()).real + eps, dim=(-2, -1))
        A1 = A1 + 0.5 * torch.mean(A1, dim=-3)
    if recover_probe:
        dPO = m_probe_update[..., m : m + 1, :, :] * bpatches
        A4 = torch.sum((dPO * dPO.conj()).real + eps, dim=(-2, -1))
        A4 = A4 + 0.5 * torch.mean(A4, dim=-3)

    chi_m = chi[..., m : m + 1, :, :]
    x1 = x2 = x1_solo = None
    if recover_psi and recover_probe:
        b1 = torch.sum((dOP.conj() * chi_m).real, dim=(-2, -1))
        b2 = torch.sum((dPO.conj() * chi_m).real, dim=(-2, -1))
        A2 = torch.sum(dOP * dPO.conj(), dim=(-2, -1))
        A3 = A2.conj()
        determinant = A1 * A4 - A2 * A3
        determinant = torch.where(
            torch.abs(determinant) == 0,
            torch.full_like(determinant, 1e-32),
            determinant,
        )
        x1 = -torch.conj(A2 * b2 - A4 * b1) / determinant
        x2 = torch.conj(A1 * b2 - A3 * b1) / determinant
        # The uncoupled object step, for epochs where probe recovery is
        # gated off.
        x1_solo = b1 / A1
    elif recover_psi:
        b1 = torch.sum((dOP.conj() * chi_m).real, dim=(-2, -1))
        x1 = b1 / A1
    elif recover_probe:
        b2 = torch.sum((dPO.conj() * chi_m).real, dim=(-2, -1))
        x2 = b2 / A4

    nvalid = torch.sum(bmask) + 1e-32
    wmask = bmask[:, None, None, None, None]

    def beta(x):
        step = 0.9 * torch.clamp(_fz(x[..., None, None].real), min=0)
        return torch.sum(step * wmask, dim=0) / nvalid

    if x1 is not None:
        out["beta_object"] = beta(x1)[0, 0, 0]
    if x1_solo is not None:
        out["beta_object_solo"] = beta(x1_solo)[0, 0, 0]
    if x2 is not None:
        out["beta_probe"] = beta(x2)
    return out
