"""Regularized ptychographic iterative engine (rPIE) mini-batch math.

Counterpart of :mod:`tike_tpu.ptycho.solvers.rpie` (Maiden & Rodenburg
2009, Ultramicroscopy 109; Maiden, Johnson, Li 2017, Optica 4): one
batch's forward model, exitwave step (Gaussian or Poisson) and the
backpropagated object and probe numerators, for one object slice. How the
numerators become steps (per batch, or summed over the epoch in compact
mode) is the epoch's business (``epoch.py``).
"""

from __future__ import annotations

import torch

from ... import linalg
from ...ops.objective import ELEMENTWISE, GRAD
from ...ops.patch import patch_adj, patch_fwd
from ...ops.propagation import propagation_adj, propagation_fwd
from ...ops.ptycho import (
    PtychoConfig,
    _crop_from_detector,
    _pad_to_detector,
    _require_single_slice,
    intensity_from_farplane,
)
from ..exitwave import (
    poisson_steplength_all_modes,
    poisson_steplength_dominant_mode,
)
from ..probe import get_varying_probe
from .lstsq import _masked_mean_each_pattern


def _batch_gradients_math(
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
    step_length_start,
    step_length_weight,
    unmeasured_pixels_scaling,
    *,
    noise_model: str,
    steplength_usemodes: str,
    recover_probe: bool,
):
    """Forward model, exitwave step and numerators for one batch.

    data_b (B, DET, DET) is the batch's data; idx (B,) indexes the full
    scan and eigen weights; bmask (B,) zeroes padded slots. Returns
    ``(costs (B,), psi_num (1, H, W), probe_num (1, 1, 1, M, P, P),
    eigen_delta (B,) or None)``; ``eigen_delta`` is the change of each
    position's shared-component weight of mode 0, 0 in padded slots.

    The object windows are gathered again for the probe numerator, as the
    JAX package does by default, rather than kept from the forward model.
    """
    _require_single_slice(cfg)
    nmodes = probe.shape[-3]
    p = cfg.probe_shape
    scan_b = scan[idx]
    if eigen_weights is not None:
        w_b = eigen_weights[idx]
        unique_probe = get_varying_probe(probe, eigen_probe, w_b)[:, 0]
    else:
        unique_probe = probe[:, 0]  # (1, M, P, P)

    patches = patch_fwd(psi[0], scan_b, p)
    farplane = propagation_fwd(
        _pad_to_detector(patches[:, None] * unique_probe, cfg)
    )  # (B, M, DET, DET)
    intensity = intensity_from_farplane(farplane)

    costs = _masked_mean_each_pattern(
        ELEMENTWISE[noise_model](data_b, intensity), measured_pixels
    )

    if noise_model == "poisson":
        xi = (1 - data_b / (intensity + 1e-9))[:, None, :, :]
        grad_cost = farplane * xi
        step_length = torch.full(
            (farplane.shape[0], 1, nmodes, 1, 1),
            step_length_start,
            dtype=intensity.dtype,
            device=intensity.device,
        )
        if steplength_usemodes == "dominant_mode":
            step_length = poisson_steplength_dominant_mode(
                xi[:, :, None],
                intensity,
                data_b,
                measured_pixels,
                step_length,
                step_length_weight,
            )
        else:
            step_length = poisson_steplength_all_modes(
                xi[:, :, None],
                torch.square(torch.abs(farplane))[:, None],
                intensity,
                data_b,
                measured_pixels,
                step_length,
                step_length_weight,
            )
        update = -step_length[:, 0] * grad_cost
    else:
        update = -GRAD[noise_model](data_b, farplane, intensity)

    chi = torch.where(
        measured_pixels, update, farplane * (unmeasured_pixels_scaling - 1.0)
    )
    diff = _crop_from_detector(propagation_adj(chi), cfg)  # (B, M, P, P)
    diff = diff * bmask[:, None, None, None]

    grad_psi = torch.sum(torch.conj(unique_probe) * diff, dim=1) / nmodes
    psi_num = patch_adj(grad_psi, scan_b, (cfg.nz, cfg.n))[None]
    patches = patch_fwd(psi[0], scan_b, p)
    probe_num = torch.sum(torch.conj(patches)[:, None] * diff, dim=0)[
        None, None, None
    ]  # (1, 1, 1, M, P, P)

    eigen_delta = None
    if recover_probe and eigen_weights is not None:
        OP = patches[:, None] * probe[0, :, 0:1, :, :]
        eigen_numerator = torch.sum(
            torch.real(torch.conj(OP) * diff[:, 0:1]), dim=(-1, -2)
        )
        eigen_denominator = torch.sum(torch.abs(OP) ** 2, dim=(-1, -2)) + 1e-32
        eigen_delta = 0.1 * (eigen_numerator / eigen_denominator)[:, 0] * bmask
    return costs, psi_num, probe_num, eigen_delta


def _normalize_eigen_weights(eigen_weights):
    """Divide each eigen component's weights by their root mean square over
    positions; the epsilon keeps an all-zero column at zero."""
    return eigen_weights / (
        linalg.mnorm(eigen_weights, dim=-3, keepdim=True) + 1e-32
    )
