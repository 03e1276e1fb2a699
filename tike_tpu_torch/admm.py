"""Joint ptycho-tomography reconstruction by ADMM (PyTorch).

Counterpart of :mod:`tike_tpu.admm`. Recover a 3D complex refractive index
``obj`` from ptychographic diffraction measurements at several rotation
angles, with the laminography operator as the projection (tilt = pi/2 is
conventional tomography). Split variables:

    minimize  sum_t ptycho_cost(data_t; psi_t)
    s.t.      psi_t = exp(i k voxelsize * P_t(obj))      (P_t = projection)

ADMM iteration (rho = penalty, lamda = scaled dual):
  1. psi_t  <- ptycho epochs on data_t, then proximal blend toward
               hobj_t - lamda_t/rho
  2. phi_t  = -i/k * log(psi_t + lamda_t/rho) / voxelsize
  3. obj    <- laminography CG fit of phi
  4. hobj_t = exp(i k voxelsize P_t(obj))
  5. lamda += rho (psi - hobj)

Every piece runs on ``device``: rPIE or LSQML through
:class:`tike_tpu_torch.ptycho.Reconstruction` (the patch kernels), the
coverage weights through ``patch_adj``, the volume fit and the
re-projection through the USFFT's KB kernels. The diffraction data is
uploaded once; psi, hobj, lamda, the weights, phi and obj stay on the
device across the iterations, and one
:class:`~tike_tpu_torch.ops.lamino.LaminoPlan` serves all of them (the
angles never change). The host sees each angle's cost and its small
parameter state (probe, positions, histories) after its epochs, as
``Reconstruction.get_result`` returns them, and the final result.
"""

from __future__ import annotations

import copy
import logging
import typing

import numpy as np
import torch

from . import ptycho as tp
from .constants import wavenumber
from .lamino import reconstruct as lamino_reconstruct
from .ops.lamino import LaminoConfig, LaminoPlan, lamino_fwd
from .ops.patch import patch_adj
from .precision import as_tensor, to_numpy
from .ptycho.ptycho import _resolve_device
from .ptycho.solvers import PtychoParameters

logger = logging.getLogger(__name__)

__all__ = ["reconstruct_joint_admm"]


def coverage_weights(parameters: typing.Sequence[PtychoParameters], shape, device):
    """Per-angle illumination coverage, normalized to mean 1: the sum of
    |probe|^2 (over the modes) accumulated over the scan windows, the
    psi-preconditioner quantity. Returns a (T, H, W) float32 tensor."""
    weights = []
    for p in parameters:
        probe = as_tensor(p.probe, torch.complex64, device)
        pw = torch.sum(torch.square(torch.abs(probe))[0, 0], dim=0)
        scan = as_tensor(p.scan, torch.float32, device)
        cov = patch_adj(
            pw.expand(scan.shape[0], *pw.shape).contiguous(), scan, tuple(shape)
        )
        weights.append(cov / (cov.mean() + 1e-12))
    return torch.stack(weights)


def _gauge_fixed(raw, target, gauge: str):
    """``raw`` turned by the piston that ``gauge`` estimates against
    ``target``; decided on the device, with no host read."""
    if gauge == "target":
        # Least-squares gauge: the phase of <target, raw>, where it has one.
        z = torch.sum(torch.conj(target) * raw)
        mag = torch.abs(z)
        one = torch.ones((), dtype=raw.dtype, device=raw.device)
        return raw * torch.where(mag > 0, torch.conj(z) / torch.clamp(mag, min=1e-38), one)
    if gauge == "median":
        # The median as numpy takes it: the mean of the two middle values
        # of an even count.
        d = torch.angle(raw * torch.conj(target))
        return raw * torch.exp(-1j * torch.quantile(d.reshape(-1), 0.5))
    return raw


def reconstruct_joint_admm(
    data: typing.Sequence[np.ndarray],
    parameters: typing.Sequence[PtychoParameters],
    theta: np.ndarray,
    tilt: float = np.pi / 2,
    obj: np.ndarray | None = None,
    voxelsize: float = 1.0,
    energy: float = 10.0,
    num_iter: int = 1,
    rho: float = 0.5,
    ptycho_iter: int = 2,
    lamino_iter: int = 2,
    eps: float = 1e-3,
    upsample: float = 2.0,
    gauge: str = "target",
    coverage_weighted: bool = True,
    *,
    device="cuda",
):
    """Jointly reconstruct a 3D object from multi-angle ptychography.

    Parameters
    ----------
    data : list of (POSI, DET, DET) float32, one per rotation angle
    parameters : list of PtychoParameters, one per angle (psi is the
        per-angle projection transmission estimate)
    theta : (T,) float32 rotation angles [radians]
    tilt : float, angle between rotation axis and beam (pi/2 = tomography)
    voxelsize : float [cm], object voxel side length
    energy : float [keV], probe energy
    rho : float, ADMM penalty; sets the data-vs-consensus blend
        ``rho/(w+rho)`` per iteration.
    ptycho_iter, lamino_iter : int, inner iterations per ADMM iteration.
    gauge : str, per-angle phase piston estimator: "target" (the phase of
        the inner product with the consensus target), "median" (the median
        pointwise phase difference to the target) or "none". Diffraction
        intensities do not see a global phase on psi, so each angle's
        ptychography drifts by a constant that log-linearizes into an
        offset of phi_t, inconsistent across angles.
    coverage_weighted : bool, weight the proximal blend by illumination
        coverage so weakly-measured pixels lean on the consensus volume
        (the exact unweighted blend when False).
    device : where everything runs: the CUDA card unless the caller asks
        for another, such as ``"cpu"``. Keyword-only.

    Each angle's ptychography is unseeded, as in ``tike_tpu``: with more
    than one batch its clustering and batch order differ from call to call.

    Returns
    -------
    dict with 'obj' (N, N, N) complex64 numpy, 'parameters' (updated list,
    host arrays), 'costs' (per-iteration mean ptycho cost).
    """
    if gauge not in ("target", "median", "none"):
        raise ValueError(f"unknown gauge: {gauge!r}")
    T = len(theta)
    if len(data) != T or len(parameters) != T:
        raise ValueError(
            f"{len(data)} data sets and {len(parameters)} parameter sets for "
            f"{T} angles: there must be one of each per angle"
        )
    device = _resolve_device(device, obj=obj, theta=theta)
    n = parameters[0].psi.shape[-1]
    k = wavenumber(energy)
    cfg = LaminoConfig(n=n, tilt=float(tilt), eps=eps, upsample=upsample)
    theta_d = as_tensor(theta, torch.float32, device)
    plan = LaminoPlan(cfg, theta_d)
    if obj is None:
        obj_d = torch.zeros((n, n, n), dtype=torch.complex64, device=device)
    else:
        obj_d = as_tensor(obj, torch.complex64, device)
    data_d = [as_tensor(d, torch.float32, device) for d in data]

    psi = torch.stack(
        [as_tensor(p.psi, torch.complex64, device)[0] for p in parameters]
    )  # (T, n, n)
    hobj = torch.ones_like(psi)
    lamda = torch.zeros_like(psi)
    params = [copy.deepcopy(p) for p in parameters]

    # Uniform weight 1 reduces the blend exactly to (raw + rho t)/(1 + rho).
    if coverage_weighted:
        weights = coverage_weights(params, psi.shape[-2:], device)
    else:
        weights = torch.ones(psi.shape, dtype=torch.float32, device=device)
    for p in params:
        # The periodic object-magnitude rescale fixes the psi/probe scale
        # degeneracy of standalone ptychography; under ADMM the consensus
        # constraint psi = h(obj) already anchors psi's scale, and a
        # mid-run rescale would desync psi and probe from hobj and lamda.
        p.algorithm_options.rescale_period = int(1e9)
    costs = []

    for it in range(num_iter):
        # 1. Per-angle ptychography with proximal blend toward the consensus.
        angle_costs = []
        new_psi = []
        for t in range(T):
            params[t].psi = psi[t][None].clone()
            params[t].algorithm_options.num_iter = ptycho_iter
            with tp.Reconstruction(data_d[t], params[t], device=device) as context:
                context.iterate(ptycho_iter)
                raw = context.parameters.psi[0]
                params[t] = context.get_result()
            angle_costs.append(float(np.mean(params[t].algorithm_options.costs[-1])))
            target = hobj[t] - lamda[t] / rho
            raw = _gauge_fixed(raw, target, gauge)
            w = weights[t]
            new_psi.append((w * raw + rho * target) / (w + rho))
        psi = torch.stack(new_psi)
        costs.append(float(np.mean(angle_costs)))

        # 2. Log-linearize the projections.
        phi = (-1j / k) * torch.log(psi + lamda / rho + 1e-12) / voxelsize

        # 3. Fit the volume to the projections.
        obj_d = lamino_reconstruct(
            data=phi,
            theta=theta_d,
            tilt=tilt,
            algorithm="cgrad",
            obj=obj_d,
            num_iter=lamino_iter,
            eps=eps,
            upsample=upsample,
            device=device,
            plan=plan,
        )["obj"]

        # 4. Re-project and re-exponentiate the consensus variable.
        line_integrals = lamino_fwd(cfg, obj_d, theta_d, plan) * voxelsize
        hobj = torch.exp((1j * k) * line_integrals)

        # 5. Dual ascent on the residual of the constraint psi = h(obj):
        # with the augmented Lagrangian written on (psi - h), as in the
        # target of step 1 and the fit of step 2, the multiplier ascends
        # along (psi - hobj).
        lamda = lamda + rho * (psi - hobj)
        logger.info("ADMM iteration %d: ptycho cost %.3e", it, costs[-1])

    psi_host = to_numpy(psi)
    for t in range(T):
        params[t].psi = psi_host[t][None]
    return {"obj": to_numpy(obj_d), "parameters": params, "costs": costs}
