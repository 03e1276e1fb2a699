"""Regularized ptychographic iterative engine (rPIE) mini-batch math.

Counterpart of :mod:`tike_tpu.ptycho.solvers.rpie` (Maiden & Rodenburg
2009, Ultramicroscopy 109; Maiden, Johnson, Li 2017, Optica 4): one
batch's forward model, exitwave step (Gaussian or Poisson) and the
backpropagated object and probe numerators, for each object slice: with
D > 1 slices the exit-wave difference is propagated back from the last
slice to the first by the adjoint Fresnel propagator. How the numerators
become steps (per batch, or summed over the epoch in compact mode) is the
epoch's business (``epoch.py``), and so is the body of :func:`rpie`, the
per-epoch solver function.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from ... import linalg
from ...ops.objective import ELEMENTWISE, _masked_mean_each_pattern, gaussian_farplane
from ...ops.patch import patch_adj, patch_fwd
from ...ops.propagation import fresnel_adj, propagation_adj
from ...ops.ptycho import (
    PtychoConfig,
    _crop_from_detector,
    intensity_from_farplane,
    ptycho_fwd_with_probes,
)
from ...parallel import Gather, Sum, run_local
from ..exitwave import (
    poisson_steplength_all_modes,
    poisson_steplength_dominant_mode,
)
from ..probe import get_varying_probe


def _batch_gradients_math(*args, **kwargs):
    """Forward model, exitwave step and numerators for one batch.

    data_b (B, DET, DET) is the batch's data; idx (B,) indexes the full
    scan and eigen weights; bmask (B,) zeroes padded slots. Returns
    ``(costs (B,), psi_num (D, H, W), probe_num (D, 1, 1, M, P, P),
    eigen_delta (B,) or None)``; ``eigen_delta`` is the change of each
    position's shared-component weight of mode 0, 0 in padded slots, from
    slice 0's windows and the difference propagated back to slice 0.

    The object windows are gathered again for the probe numerator, as the
    JAX package does by default, rather than kept from the forward model.
    :func:`_batch_gradients_steps` on one device.
    """
    return run_local(_batch_gradients_steps(*args, **kwargs))


def _batch_gradients_steps(
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
    """:func:`_batch_gradients_math` on one shard's slots of a batch split
    over a mesh, as a generator for ``parallel.run_shards``: the object and
    probe numerators are summed over the shards, and the per-slot costs and
    eigen deltas gathered, so that it returns the whole batch's result on
    every shard."""
    nmodes = probe.shape[-3]
    p = cfg.probe_shape
    scan_b = scan[idx]
    if eigen_weights is not None:
        w_b = eigen_weights[idx]
        unique_probe = get_varying_probe(probe, eigen_probe, w_b)[:, 0]
    else:
        unique_probe = probe[:, 0]  # (1, M, P, P)

    farplane, slice_probes = ptycho_fwd_with_probes(
        cfg, psi, scan_b, unique_probe
    )  # (B, M, DET, DET), (D, B, M, P, P)

    if noise_model == "poisson":
        intensity = intensity_from_farplane(farplane)
        costs = _masked_mean_each_pattern(
            ELEMENTWISE[noise_model](data_b, intensity), measured_pixels
        )
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
        chi = torch.where(
            measured_pixels, update, farplane * (unmeasured_pixels_scaling - 1.0)
        )
    elif noise_model == "gaussian":
        costs, chi = gaussian_farplane(
            data_b, farplane, measured_pixels, unmeasured_pixels_scaling
        )
    else:
        raise KeyError(f"unknown noise model {noise_model!r}")
    diff = _crop_from_detector(propagation_adj(chi), cfg)  # (B, M, P, P)
    diff = diff * bmask[:, None, None, None]

    # From the last slice back to the first; the loop ends with slice 0's
    # windows in ``patches`` and its difference in ``diff``.
    psi_num, probe_num = [], []
    prop = cfg.propagator(psi.device)
    for tt in range(cfg.nslices - 1, -1, -1):
        grad_psi = torch.sum(torch.conj(slice_probes[tt]) * diff, dim=1) / nmodes
        psi_num.append(patch_adj(grad_psi, scan_b, (cfg.nz, cfg.n)))
        patches = patch_fwd(psi[tt], scan_b, p)
        probe_num.append(torch.sum(torch.conj(patches)[:, None] * diff, dim=0))
        if tt > 0:
            diff = fresnel_adj(diff, prop)
    psi_num = torch.stack(psi_num[::-1])  # (D, H, W)
    probe_num = torch.stack(probe_num[::-1])[:, None, None]  # (D, 1, 1, M, P, P)

    eigen_delta = None
    if recover_probe and eigen_weights is not None:
        OP = patches[:, None] * probe[0, :, 0:1, :, :]
        eigen_numerator = torch.sum(
            torch.real(torch.conj(OP) * diff[:, 0:1]), dim=(-1, -2)
        )
        eigen_denominator = torch.sum(torch.abs(OP) ** 2, dim=(-1, -2)) + 1e-32
        eigen_delta = 0.1 * (eigen_numerator / eigen_denominator)[:, 0] * bmask
    psi_num, probe_num = yield Sum((psi_num, probe_num))
    costs, eigen_delta = yield Gather((costs, eigen_delta))
    return costs, psi_num, probe_num, eigen_delta


def _normalize_eigen_weights(eigen_weights):
    """Divide each eigen component's weights by their root mean square over
    positions; the epsilon keeps an all-zero column at zero."""
    return eigen_weights / (
        linalg.mnorm(eigen_weights, dim=-3, keepdim=True) + 1e-32
    )


def rpie(
    parameters,
    data,
    batches: typing.Tuple[np.ndarray, np.ndarray],
    *,
    op: PtychoConfig,
    epoch: int,
    rng: typing.Optional[np.random.Generator] = None,
):
    """One rPIE epoch over all mini-batches, as ``tike_tpu``'s
    ``solvers.rpie``: the batches in order for compact batching, else in a
    permutation drawn from ``rng``; the preconditioners already in the
    options; the probe updated where ``probe_options.recover_probe(epoch)``
    says, with AdaM (per batch) or checked momentum (compact, decided on
    the host) on mode 0 where the options ask, and likewise the object;
    the eigen weights normalized; no probe or object constraint; the mean
    batch cost appended to ``algorithm_options.costs``. ``data`` is
    batch-major (nb, L, DET, DET) or flat (N, DET, DET). Returns
    ``parameters``, updated. See
    :func:`~tike_tpu_torch.ptycho.solvers.epoch.solver_epoch`.
    """
    from .epoch import solver_epoch

    return solver_epoch("rpie", parameters, data, batches, op=op, epoch=epoch, rng=rng)
