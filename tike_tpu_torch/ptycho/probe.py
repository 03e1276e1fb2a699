"""Probe options, eigen (variable) probes and the mode set-up helpers.

Counterpart of :mod:`tike_tpu.ptycho.probe`. Probes are (1, 1, SHARED, W, H)
complex64; eigen probes are (1, EIGEN, SHARED, W, H) and eigen weights are
(POSI, EIGEN + 1, SHARED) float32. The unique probe at a position is
``weights[0] * probe + sum(weights[1:] * eigen_probe)`` (orthogonal probe
relaxation, OPR).

The per-epoch probe constraints (finite support, median filter of the
magnitude, centering, sparsity, orthogonalization), the photon-count
rescale and ``adjust_probe_power`` run on tensors on any device. The
set-up helpers (``add_modes_*``, ``init_varying_probe``,
``simulate_varying_weights``) are host numpy, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from .. import linalg
from ..parallel import Sum, run_local
from ..precision import as_tensor, cfloating, floating, to_numpy
from ..utils.ndimage import (
    center_of_mass2d,
    gaussian_filter2d,
    integer_shift2d,
    median_filter2d,
)


@dataclasses.dataclass
class ProbeOptions:
    """Manage data and settings related to probe correction."""

    update_start: int = 0
    """Start probe updates at this epoch."""

    update_period: int = 1
    """The number of epochs between probe updates."""

    init_rescale_from_measurements: bool = True
    """Initial rescaling of probe using measured intensity."""

    probe_photons: float = np.nan
    """The shared probe mode intensity must add up to this number."""

    probe_wavelength: float = np.nan
    """Wavelength (meters) of the probing wavefield."""

    probe_FOV_lengths: typing.Tuple[float, float] = (np.nan, np.nan)
    """Transverse field of view of the probe (meters): (vertical, horizontal)."""

    force_orthogonality: bool = False
    """Forces probes to be orthogonal each iteration."""

    force_centered_intensity: bool = False
    """Forces the probe intensity to be centered."""

    force_sparsity: float = 0.0
    """Forces this proportion of zero elements."""

    use_adaptive_moment: bool = False
    """Whether or not to use adaptive moment."""

    vdecay: float = 0.999
    """Second-moment decay for adaptive moment."""

    mdecay: float = 0.9
    """First-moment decay for adaptive moment."""

    v: typing.Any = dataclasses.field(init=False, default=None)
    """The second moment for adaptive moment."""

    m: typing.Any = dataclasses.field(init=False, default=None)
    """The first moment for adaptive moment."""

    probe_support: float = 0.0
    """Weight of the finite probe support constraint; zero or greater."""

    probe_support_radius: float = 0.5 * 0.7
    """Radius of finite probe support as fraction of probe grid. [0.0, 0.5]."""

    probe_support_degree: float = 2.5
    """Degree of the supergaussian defining the probe support."""

    additional_probe_penalty: float = 0.0
    """Penalty applied linearly-increasing across modes to prefer low modes."""

    median_filter_abs_probe: bool = False
    """Whether to median filter the magnitude of each shared probe mode."""

    median_filter_abs_probe_px: typing.Tuple[float, float] = (1.0, 1.0)
    """Median filter pixel widths along each dimension."""

    preconditioner: typing.Any = dataclasses.field(init=False, default=None)

    power: typing.List[typing.Any] = dataclasses.field(
        init=False, default_factory=list
    )
    """The power of the primary probe modes at each iteration."""

    def recover_probe(self, epoch: int) -> bool:
        """Return whether to update probe at this epoch."""
        return (epoch >= self.update_start) and (
            epoch % self.update_period == 0
        )

    def resample(self, factor: float, interp=None) -> "ProbeOptions":
        """A copy for a grid of another scale: the moments and the
        preconditioner reset, the power history kept (the same list, as in
        the JAX package)."""
        out = dataclasses.replace(self)
        out.power = self.power
        return out


def get_varying_probe(shared_probe, eigen_probe=None, weights=None):
    """Combine shared and eigen probes with weights into per-position probes.

    shared_probe (1, 1, SHARED, W, H); eigen_probe (1, EIGEN, SHARED, W, H)
    or None; weights (POSI, EIGEN+1, SHARED). Returns (POSI, 1, SHARED, W,
    H) unique probes, or the shared probe itself when weights is None.
    Eigen probes may cover only the first modes (``eigen_probe.shape[-3]``
    <= SHARED); the other modes are only scaled by ``weights[:, 0]``.
    """
    if weights is None:
        return shared_probe
    unique = weights[..., 0:1, :, None, None] * shared_probe
    if eigen_probe is not None:
        m = eigen_probe.shape[-3]
        contrib = torch.sum(
            weights[..., 1:, :m, None, None] * eigen_probe[..., 0:, :m, :, :],
            dim=-4,
            keepdim=True,
        ).to(unique.dtype)
        if m == unique.shape[-3]:
            unique = unique + contrib
        else:
            unique = torch.cat(
                [unique[..., :m, :, :] + contrib, unique[..., m:, :, :]], dim=-3
            )
    return unique


def update_eigen_probe(
    R, eigen_probe, weights, patches, diff, valid=None, *, β=0.1, c=1, m=0
):
    """Update one eigen probe and its weights from a batch's residuals.

    R (B, 1, 1, W, H) residual probe updates; patches (B, 1, 1, W, H);
    diff (B, 1, SHARED, W, H); eigen_probe (1, EIGEN, SHARED, W, H);
    weights (B, EIGEN+1, SHARED), the batch's rows of the full weights.
    ``valid`` is an optional (B,) 0/1 mask of real (unpadded) slots.
    Returns new ``(eigen_probe, weights)``; the inputs are not modified.
    The ``1e-32`` guards are the JAX package's, kept so both round alike.
    """
    return run_local(
        update_eigen_probe_steps(R, eigen_probe, weights, patches, diff, valid, β=β, c=c, m=m)
    )


def update_eigen_probe_steps(
    R, eigen_probe, weights, patches, diff, valid=None, *, β=0.1, c=1, m=0
):
    """:func:`update_eigen_probe` on one shard's slots of a batch split over
    a mesh: a generator that yields its partial sums over the slots
    (``parallel.Sum``) and goes on with the sums over all shards
    (``parallel.run_shards``). Returns the new eigen probe (the same on
    every shard) and this shard's new weights."""
    v = (
        torch.ones(R.shape[0], dtype=R.real.dtype, device=R.device)
        if valid is None
        else valid
    )
    v5 = v[:, None, None, None, None]
    w = weights[:, c : c + 1, m : m + 1, None, None]
    norm_weights, nvalid = yield Sum(
        (torch.sum(torch.square(w) * v5, dim=0, keepdim=True), torch.sum(v))
    )
    norm_weights = norm_weights + 1e-32
    nvalid = nvalid + 1e-32

    proj = (
        torch.real(R.conj() * eigen_probe[:, c - 1 : c, m : m + 1, :, :]) + w
    ) / norm_weights
    update = (
        yield Sum(
            torch.sum(
                R * torch.mean(proj, dim=(-2, -1), keepdim=True) * v5,
                dim=0,
                keepdim=True,
            )
        )
    ) / nvalid

    update_norm = linalg.mnorm(update, dim=(-2, -1), keepdim=True) + 1e-32
    new_eigen = eigen_probe[:, c - 1 : c, m : m + 1, :, :] + (
        β * update / update_norm
    )
    new_eigen = new_eigen / (
        linalg.mnorm(new_eigen, dim=(-2, -1), keepdim=True) + 1e-32
    )
    eigen_probe = eigen_probe.clone()
    eigen_probe[:, c - 1 : c, m : m + 1, :, :] = new_eigen

    # New weights for the updated eigen probe.
    phi = patches * new_eigen
    n = torch.mean(
        torch.real(diff[:, :, m : m + 1, :, :] * phi.conj()), dim=(-1, -2)
    )
    d = torch.mean(torch.square(torch.abs(phi)), dim=(-1, -2))
    d_mean = (yield Sum(torch.sum(d * v[:, None, None], dim=0, keepdim=True))) / nvalid
    weight_update = (n / (d + 0.1 * d_mean)) * v[:, None, None]
    weights = weights.clone()
    weights[:, c : c + 1, m : m + 1] += weight_update.reshape(
        weights[:, c : c + 1, m : m + 1].shape
    )
    return eigen_probe, weights


def constrain_variable_probe(variable_probe, weights):
    """Constrain eigen probes: normalize, orthogonalize, sort, de-outlier.

    variable_probe (1, EIGEN, SHARED', W, H), weights (POSI, EIGEN+1,
    SHARED), tensors on one device. Each eigen probe is normalized to unit
    RMS and its norm moved into its weights; the eigen probes are
    Gram-Schmidt orthogonalized along the axis before the pixels (as
    :func:`~tike_tpu_torch.linalg.orthogonalize_gs` and the JAX package
    enumerate them); per mode, the eigen probes and their weights are sorted
    by the energy of the weights, descending, in the order numpy's
    ``argsort`` gives on the host (ties included); and every weight is
    clipped in magnitude to 1.5 times the 95th percentile over the
    positions (linear interpolation, numpy's default). Returns new
    ``(variable_probe, weights)``.
    """
    vnorm = linalg.mnorm(variable_probe, dim=(-2, -1), keepdim=True)
    variable_probe = variable_probe / (vnorm + 1e-32)
    m = variable_probe.shape[-3]
    weights = weights.clone()
    weights[..., 1:, :m] = weights[..., 1:, :m] * vnorm[..., 0, 0]

    variable_probe = linalg.orthogonalize_gs(variable_probe, dim=(-2, -1))

    power = linalg.norm(weights[..., 1:, :m], dim=-3, keepdim=True) ** 2
    power = to_numpy(power)  # one small read: the order is numpy's
    sorted_weights = weights.clone()
    sorted_probe = variable_probe.clone()
    for i in range(m):
        order = torch.as_tensor(
            np.argsort(-power[..., i].flatten()), device=weights.device
        )
        sorted_weights[..., 1:, i] = weights[..., 1 + order, i]
        sorted_probe[..., :, i, :, :] = variable_probe[..., order, i, :, :]

    aevol = torch.abs(sorted_weights)
    limit = 1.5 * torch.quantile(aevol, 0.95, dim=-3, keepdim=True)
    weights = torch.minimum(aevol, limit) * torch.sign(sorted_weights)
    return sorted_probe, weights


def gaussian(size, rin=0.8, rout=1.0):
    """A real circular probe amplitude with soft edges (numpy)."""
    r, c = np.mgrid[:size, :size] + 0.5
    rs = np.sqrt((r - size / 2) ** 2 + (c - size / 2) ** 2)
    rmax = np.sqrt(2) * 0.5 * rout * rs.max() + 1.0
    rmin = np.sqrt(2) * 0.5 * rin * rs.max()
    img = np.zeros((size, size), dtype=floating)
    img[rs < rmin] = 1.0
    img[rs > rmax] = 0.0
    zone = np.logical_and(rs > rmin, rs < rmax)
    img[zone] = np.divide(rmax - rs[zone], rmax - rmin)
    return img


def adjust_probe_power(probe, power=None, *, device="cuda"):
    """Rescale the probe modes (axis -3) to the relative powers ``power``
    (default 1 / (1, 2, 3, ...)) of the first mode's.

    A tensor ``probe`` is rescaled on its device; a numpy one on
    ``device``, and given back as numpy.
    """
    host = not isinstance(probe, torch.Tensor)
    x = as_tensor(probe, torch.complex64, device) if host else probe
    if power is None:
        power = 1.0 / np.arange(1, x.shape[-3] + 1)
    power = as_tensor(power, torch.float32, x.device)[..., None, None]
    norm = linalg.norm(x, dim=(-2, -1), keepdim=True)
    out = x * power * norm[..., 0:1, :, :] / (norm + 1e-32)
    return to_numpy(out) if host else out


def add_modes_random_phase(probe, nmodes, rng=None):
    """Add probe modes by random linear phase shifts of the first mode.

    Host numpy, a verbatim copy of the JAX package's helper.
    """
    rng = np.random.default_rng() if rng is None else rng
    probe = np.asarray(probe)
    all_modes = np.empty(
        (*probe.shape[:-3], nmodes, *probe.shape[-2:]), dtype=probe.dtype
    )
    pw = probe.shape[-1]
    for m in range(nmodes):
        if m < probe.shape[-3]:
            all_modes[..., m, :, :] = probe[..., m, :, :]
        else:
            shift = np.exp(
                -2j
                * np.pi
                * (rng.random((2, 1)) - 0.5)
                * ((np.arange(0, pw) + 0.5) / pw - 0.5)
            )
            all_modes[..., m, :, :] = (
                probe[..., 0, :, :] * shift[0][None] * shift[1][:, None]
            )
    return all_modes


def add_modes_cartesian_hermite(probe, nmodes: int):
    """Create probe modes from 2D Cartesian Hermite basis functions.

    Host numpy, a verbatim copy of the JAX package's helper (Odstrcil et
    al. 2018): multiply the probe by polynomial-times-gaussian envelopes,
    Gram-Schmidt as you go.
    """
    if nmodes < 1:
        raise ValueError(f"nmodes cannot be less than 1. It was {nmodes}.")
    probe = np.asarray(probe)
    if probe.ndim < 3:
        raise ValueError(
            "probe should be (..., 1, W, H) not " + str(probe.shape)
        )

    M = int(np.ceil(np.sqrt(nmodes)))
    N = int(np.ceil(nmodes / M))
    X, Y = np.meshgrid(
        np.arange(probe.shape[-2]) - (probe.shape[-2] // 2 - 1),
        np.arange(probe.shape[-1]) - (probe.shape[-2] // 2 - 1),
        indexing="xy",
    )
    p2 = np.abs(probe) ** 2
    tot = np.sum(p2, axis=(-2, -1), keepdims=True)
    cenx = np.sum(X * p2, axis=(-2, -1), keepdims=True) / tot
    ceny = np.sum(Y * p2, axis=(-2, -1), keepdims=True) / tot
    varx = np.sum((X - cenx) ** 2 * p2, axis=(-2, -1), keepdims=True) / tot
    vary = np.sum((Y - ceny) ** 2 * p2, axis=(-2, -1), keepdims=True) / tot

    def _norm(x):
        return np.sqrt(np.sum(np.abs(x) ** 2, axis=(-2, -1), keepdims=True))

    new_probes = []
    for nii in range(N):
        for mii in range(M):
            basis = ((X - cenx) ** mii) * ((Y - ceny) ** nii) * probe
            if not (mii == 0 and nii == 0):
                basis = basis * np.exp(
                    -((X - cenx) ** 2) / (2 * varx)
                    - ((Y - ceny) ** 2) / (2 * vary)
                )
            basis = basis / _norm(basis)
            for H in new_probes:
                basis = basis - H * np.sum(
                    np.conj(H) * basis, axis=(-2, -1), keepdims=True
                )
            basis = basis / _norm(basis)
            new_probes.append(basis)
            if len(new_probes) == nmodes:
                return np.concatenate(new_probes, axis=-3)[
                    ..., :nmodes, :, :
                ].astype(cfloating)
    raise RuntimeError("add_modes_cartesian_hermite never reached a return.")


def init_varying_probe(
    scan, shared_probe, num_eigen_probes, probes_with_modes=1, rng=None
):
    """Initialize eigen probe and weight arrays (host numpy).

    Returns ``(eigen_probe, weights)``: ``(None, None)`` for fewer than one
    eigen probe, ``(None, weights)`` for exactly one (the shared component's
    weights alone).
    """
    rng = np.random.default_rng() if rng is None else rng
    probes_with_modes = max(probes_with_modes, 0)
    if probes_with_modes > shared_probe.shape[-3]:
        raise ValueError(
            f"probes_with_modes ({probes_with_modes}) cannot be more than "
            f"the number of probes ({shared_probe.shape[-3]})!"
        )
    if num_eigen_probes < 1:
        return None, None

    weights = 1e-6 * rng.random(
        (*scan.shape[:-1], num_eigen_probes, shared_probe.shape[-3])
    ).astype(floating)
    weights -= np.mean(weights, axis=-3, keepdims=True)
    weights[..., 0, :] = 1.0
    weights[..., 1:, probes_with_modes:] = 0

    if num_eigen_probes == 1:
        return None, weights

    shape = (
        *shared_probe.shape[:-4],
        num_eigen_probes - 1,
        probes_with_modes,
        *shared_probe.shape[-2:],
    )
    eigen_probe = (
        rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    ).astype(cfloating)
    # The root-mean-square magnitude in float32, as tike_tpu.linalg.mnorm.
    eigen_probe /= np.sqrt(
        np.mean(
            (eigen_probe * eigen_probe.conj()).real, axis=(-2, -1), keepdims=True
        )
    )
    return eigen_probe, weights


def power(probe: torch.Tensor) -> torch.Tensor:
    """Return the power of each probe mode, flattened, on the probe's
    device."""
    return torch.sum((probe * probe.conj()).real, dim=(-2, -1)).reshape(-1)


def _orthogonalize_eig_body(x: torch.Tensor):
    """Orthogonalize the modes of ``x`` through the eigenvectors of their
    pairwise dot products, then sort them by power, descending.

    ``A_ij = <x_i, x_j>`` and the modes become ``V^T x``, as in the JAX
    package. An eigenvector is defined only up to a unit phase, and LAPACK,
    the JAX package's LAPACK and cuSOLVER pick it differently; here each
    eigenvector is turned so that its first component is real and
    non-negative. LAPACK's first component is already real (its Householder
    reduction leaves it so), so this port differs from the JAX package by
    at most a sign per mode. Returns ``(modes, power)``, the power (M,)
    sorted. ``torch.linalg.eigh`` synchronizes a CUDA device with the host.
    """
    flat = x.reshape(*x.shape[:-2], -1)
    A = torch.conj(flat) @ flat.transpose(-1, -2)
    _, vectors = torch.linalg.eigh(A)
    first = vectors[..., 0:1, :]
    mag = torch.abs(first)
    phase = torch.where(mag > 0, first.conj() / torch.clamp(mag, min=1e-30), 1)
    vectors = vectors * phase
    result = (vectors.transpose(-1, -2) @ flat).reshape(x.shape)
    pwr = power(result)
    order = torch.argsort(-pwr, stable=True)
    modes = result.reshape(pwr.shape[0], -1)[order]
    return modes.reshape(x.shape), pwr[order]


def orthogonalize_eig(x: torch.Tensor):
    """Orthogonalize the probe modes (see :func:`_orthogonalize_eig_body`).

    Returns the orthogonal modes, sorted by power descending, and their
    power as a numpy array.
    """
    result, pwr = _orthogonalize_eig_body(x)
    return result, to_numpy(pwr)


def constrain_center_peak(probe: torch.Tensor) -> torch.Tensor:
    """Shift the probe by at most one pixel per axis so that its blurred
    intensity is centered.

    The shift stays a device integer (``torch.round``, half to even, as
    ``jnp.round``) and moves the modes by an index gather.
    """
    half = probe.shape[-2] // 2, probe.shape[-1] // 2
    stack = probe.reshape((-1, *probe.shape[-2:]))
    intensity = gaussian_filter2d(
        torch.sum(torch.square(torch.abs(stack)), dim=0),
        sigma=(half[0] / 3, half[1] / 3),
        mode="constant",
        truncate=6.0,
    )
    cy, cx = center_of_mass2d(intensity)
    dy = torch.clamp(torch.round(half[0] - cy), -1, 1).to(torch.int64)
    dx = torch.clamp(torch.round(half[1] - cx), -1, 1).to(torch.int64)
    return integer_shift2d(stack, (dy, dx)).reshape(probe.shape)


def apply_median_filter_abs_probe(probe: torch.Tensor, med_filt_px=(1.0, 1.0)):
    """Median filter each shared probe mode's magnitude, keeping its phase."""
    abs_probe = torch.abs(probe[0, 0])
    filt = median_filter2d(
        abs_probe, (max(int(med_filt_px[0]), 1), max(int(med_filt_px[1]), 1))
    )
    out = probe.clone()
    out[0, 0] = (filt * torch.exp(1j * torch.angle(probe[0, 0]))).to(probe.dtype)
    return out


def constrain_probe_sparsity(probe: torch.Tensor, f: float) -> torch.Tensor:
    """Zero the ``f`` fraction of pixels with the least blurred intensity.

    The threshold is the k-th smallest blurred intensity, counting from 0
    (``jnp.sort(flat)[k]``), with ``k = int(f * P * P)``.
    """
    if f == 0:
        return probe
    stack = probe.reshape((-1, *probe.shape[-2:]))
    intensity = torch.sum(torch.square(torch.abs(stack)), dim=0)
    sigma = (probe.shape[-2] / 8, probe.shape[-1] / 8)
    intensity = gaussian_filter2d(intensity, sigma, mode="wrap")
    k = int(f * probe.shape[-1] * probe.shape[-2])
    flat = intensity.reshape(-1)
    kth = torch.sort(flat).values[k]
    keep = (flat >= kth).reshape(intensity.shape)
    return probe * keep


def finite_probe_support(probe, *, radius=0.5, degree=5.0, p=1.0):
    """Supergaussian penalty mask for finite probe support:
    ``p - p * exp(-((x/radius)^2 + (y/radius)^2)^degree)``, a (P, P)
    float32 tensor on the probe's device, or 0.0 when ``p <= 0``."""
    if p <= 0:
        return 0.0
    N = probe.shape[-1]
    centers = (
        torch.arange(N, dtype=torch.float32, device=probe.device) / N - 0.5
    ) + 0.5 / N
    j, i = torch.meshgrid(centers, centers, indexing="ij")
    mask = 1 - torch.exp(
        -((torch.square(i / radius) + torch.square(j / radius)) ** degree)
    )
    return p * mask


def rescale_probe_using_fixed_intensity_photons(
    probe: torch.Tensor, Nphotons, probe_power_fraction=None
):
    """Rescale the shared probe modes so that their intensity sums to
    ``Nphotons``, keeping each mode's share (or ``probe_power_fraction``)."""
    probe_photons = torch.sum(torch.abs(probe) ** 2, dim=(-1, -2))
    if probe_power_fraction is None:
        probe_power_fraction = probe_photons / torch.sum(probe_photons)
    return probe * torch.sqrt(
        probe_power_fraction * Nphotons / (probe_photons + 1e-32)
    )[..., None, None]


def simulate_varying_weights(scan, eigen_probe, rng=None):
    """Random sinusoidal eigen weights for a simulation, host numpy: along
    axis 1 of ``scan``, one random period and phase per eigen probe and
    mode of ``eigen_probe``."""
    rng = np.random.default_rng() if rng is None else rng
    N = scan.shape[1]
    x = np.arange(N)[..., :, None, None]
    period = N * rng.random(eigen_probe.shape[:-2])
    phase = 2 * np.pi * rng.random(eigen_probe.shape[:-2])
    return np.sin(2 * np.pi / period * x - phase)
