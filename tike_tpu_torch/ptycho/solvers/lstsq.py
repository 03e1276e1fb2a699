"""Least-squares maximum-likelihood (LSQML) mini-batch math.

Counterpart of :mod:`tike_tpu.ptycho.solvers.lstsq` (Odstrcil, Menzel,
Guizar-Sicairos 2018, Optics Express): object and probe updated together
with jointly-optimal step sizes from a per-position 2x2 least-squares
solve, plus the eigen-probe (OPR) updates and the gradient terms of
position correction. Single slice; Gaussian or Poisson noise model.
"""

from __future__ import annotations

import torch

from ... import linalg
from ...ops.objective import ELEMENTWISE, GRAD
from ...ops.patch import patch_adj, patch_fwd
from ...ops.propagation import propagation_adj, propagation_fwd
from ...ops.ptycho import PtychoConfig, _crop_from_detector, _pad_to_detector
from ..exitwave import (
    poisson_steplength_all_modes,
    poisson_steplength_dominant_mode,
)
from ..position import gaussian_gradient
from ..probe import get_varying_probe, update_eigen_probe

# Largest float margin below the valid-position limit dim - P: positions
# clamp to dim - P - _POS_EDGE, whose floor is dim - P - 1, the exact upper
# corner check_allowed_positions accepts. Exactly representable in float32
# (2^-8) and large enough to survive rounding at realistic dims.
_POS_EDGE = 1.0 / 256.0


def _fz(x: torch.Tensor) -> torch.Tensor:
    """Replace non-finite entries with 0 (degenerate-batch 0/0 guards)."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def _trim_mean(x, proportion=0.05, dim=0):
    """Mean with the extreme ``proportion`` trimmed from both ends."""
    n = x.shape[dim]
    k = int(n * proportion)
    s = torch.sort(x, dim=dim).values
    return torch.mean(s.narrow(dim, k, n - 2 * k), dim=dim, keepdim=True)


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
    """One LSQML mini-batch: gradients, optimal step sizes, OPR and
    position terms.

    Same signature and returned dict as the JAX function: ``costs`` (B,),
    ``object_upd_sum`` (1, H, W), ``object_update_precond``,
    ``m_probe_update`` (1, 1, M, P, P), ``beta_object`` (1,),
    ``beta_object_solo`` (1,) and ``beta_probe`` (1, 1, 1, 1); with eigen
    weights and probe recovery also ``eigen_probe`` (None without eigen
    probes) and ``w_b`` (B, EIGEN+1, M), the batch's new weight rows; with
    ``recover_positions`` also ``pos_num`` and ``pos_den`` (B, 2), masked.
    ``step_length_*`` are read by the Poisson model alone.
    """
    nmodes = probe.shape[-3]
    m = 0  # the mode used for the step-size, eigen and position solves
    scan_b = scan[idx]
    p = cfg.probe_shape
    if eigen_weights is not None:
        w_b = eigen_weights[idx]
        unique_probe = get_varying_probe(probe, eigen_probe, w_b)  # (B,1,M,P,P)
    else:
        w_b = None
        unique_probe = probe.expand(scan_b.shape[0], 1, nmodes, p, p)

    # Forward model (single slice).
    patches2d = patch_fwd(psi[0], scan_b, p)  # (B, P, P)
    nearplane = patches2d[:, None, None] * unique_probe  # (B, 1, M, P, P)
    farplane = propagation_fwd(_pad_to_detector(nearplane, cfg))
    intensity = torch.sum(torch.square(torch.abs(farplane)), dim=(1, 2))

    costs = _masked_mean_each_pattern(
        ELEMENTWISE[noise_model](data_b, intensity), measured_pixels
    )
    if noise_model == "poisson":
        xi = (1 - data_b / (intensity + 1e-9))[:, None, None]
        grad_cost = farplane * xi
        step_length = torch.full(
            (farplane.shape[0], 1, nmodes, 1, 1),
            step_length_start,
            dtype=intensity.dtype,
            device=intensity.device,
        )
        if steplength_usemodes == "dominant_mode":
            step_length = poisson_steplength_dominant_mode(
                xi, intensity, data_b, measured_pixels, step_length,
                step_length_weight,
            )
        else:
            step_length = poisson_steplength_all_modes(
                xi, torch.square(torch.abs(farplane)), intensity, data_b,
                measured_pixels, step_length, step_length_weight,
            )
        update = -step_length * grad_cost
    else:
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

    # Eigen probe (OPR) updates.
    if recover_probe and eigen_weights is not None:
        # The weight of the shared probe component.
        OP = bpatches * probe[:, :, m : m + 1]
        num = torch.sum(
            torch.real(torch.conj(OP) * chi[:, :, m : m + 1]), dim=(-1, -2)
        )
        den = torch.sum(torch.abs(OP) ** 2, dim=(-1, -2)) + 1e-32
        w_b = w_b.clone()
        w_b[:, 0:1, m : m + 1] += 0.1 * (num / den) * bmask[:, None, None]

        if w_b.shape[-2] > 1 and eigen_probe is not None:
            R = (
                bprobe_update[..., m : m + 1, :, :]
                - m_probe_update[..., m : m + 1, :, :]
            )
            for c in range(1, eigen_probe.shape[-4] + 1):
                if m < eigen_probe.shape[-3]:
                    eigen_probe, w_b = update_eigen_probe(
                        R,
                        eigen_probe,
                        w_b,
                        bpatches,
                        chi,
                        valid=bmask,
                        β=min(0.1, 1.0 / num_batch),
                        c=c,
                        m=m,
                    )
                    if c + 1 < w_b.shape[-2]:
                        R = R - linalg.projection(
                            R,
                            eigen_probe[:, c - 1 : c, m : m + 1],
                            dim=(-2, -1),
                        )
        out["eigen_probe"] = eigen_probe
        out["w_b"] = w_b

    # Position gradient terms.
    if recover_positions:
        grad_x, grad_y = gaussian_gradient(bpatches, sigma=0.333)
        crop = probe.shape[-1] // 4
        up = unique_probe[..., m : m + 1, crop:-crop, crop:-crop]
        cc = chi[..., m : m + 1, crop:-crop, crop:-crop]
        gx = grad_x[..., crop:-crop, crop:-crop] * up
        gy = grad_y[..., crop:-crop, crop:-crop] * up
        dims = (-4, -3, -2, -1)
        pos_num = torch.stack(
            [
                torch.sum(torch.real(torch.conj(gx) * cc), dim=dims),
                torch.sum(torch.real(torch.conj(gy) * cc), dim=dims),
            ],
            dim=-1,
        )
        pos_den = torch.stack(
            [
                torch.sum(torch.abs(gx) ** 2, dim=dims),
                torch.sum(torch.abs(gy) ** 2, dim=dims),
            ],
            dim=-1,
        )
        out["pos_num"] = pos_num * bmask[:, None]
        out["pos_den"] = pos_den * bmask[:, None]

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
