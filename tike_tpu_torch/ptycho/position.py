"""Scan-position correction: affine model, RANSAC fit, options, gradient.

Counterpart of :mod:`tike_tpu.ptycho.position`. Scan positions are (y, x)
min-corner coordinates of the probe grid in the psi frame, with a 1-pixel
margin inside psi (:func:`check_allowed_positions`).

The RANSAC affine fit is data-dependent control flow on a few thousand
points and stays host numpy, as in the JAX package; it takes an explicit
``numpy.random.Generator``. The per-position gradient math of the solver
(:func:`gaussian_gradient`) runs on tensors.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import numpy.typing as npt
import torch

from .. import linalg
from ..ops import objective
from ..ops.ptycho import intensity_from_farplane, ptycho_fwd
from ..precision import as_tensor, floating, to_numpy


@dataclasses.dataclass(frozen=True)
class AffineTransform:
    """A 2D affine transformation: scale @ shear @ rotate (+ translation)."""

    scale0: float = 1.0
    scale1: float = 1.0
    shear1: float = 0.0
    angle: float = 0.0
    t0: float = 0.0
    t1: float = 0.0

    def resample(self, factor: float) -> "AffineTransform":
        return AffineTransform(
            self.scale0,
            self.scale1,
            self.shear1,
            self.angle,
            self.t0 * factor,
            self.t1 * factor,
        )

    @classmethod
    def frombuffer(cls, buffer: np.ndarray) -> "AffineTransform":
        return AffineTransform(*(float(v) for v in buffer))

    def asbuffer(self) -> np.ndarray:
        return np.array(self.astuple())

    @classmethod
    def fromarray(cls, T: np.ndarray) -> "AffineTransform":
        """Decompose a 2x2 (or 3x2) matrix (Graphics Gems 2, Section 7.1)."""
        R = np.array(T[:2, :2], dtype=np.float64, copy=True)
        scale0 = float(np.linalg.norm(R[0]))
        if scale0 <= 0:
            return AffineTransform()
        R[0] /= scale0
        shear1 = float(R[0] @ R[1])
        R[1] -= shear1 * R[0]
        scale1 = float(np.linalg.norm(R[1]))
        if scale1 <= 0:
            return AffineTransform()
        R[1] /= scale1
        shear1 /= scale1
        angle = float(np.arccos(np.clip(R[0, 0], -1.0, 1.0)))
        return AffineTransform(
            scale0=scale0,
            scale1=scale1,
            shear1=shear1,
            angle=angle,
            t0=float(T[2, 0]) if T.shape[0] > 2 else 0.0,
            t1=float(T[2, 1]) if T.shape[0] > 2 else 0.0,
        )

    def asarray(self) -> np.ndarray:
        """Return the 2x2 scale @ shear @ rotate matrix."""
        cosx = np.cos(self.angle)
        sinx = np.sin(self.angle)
        scale = np.array(
            [[self.scale0, 0.0], [0.0, self.scale1]], dtype=floating
        )
        shear = np.array([[1.0, 0.0], [self.shear1, 1.0]], dtype=floating)
        rotate = np.array([[+cosx, -sinx], [+sinx, +cosx]], dtype=floating)
        return scale @ shear @ rotate

    def asarray3(self) -> np.ndarray:
        """Return the 3x2 matrix including translation in the last row."""
        T = np.empty((3, 2), dtype=floating)
        T[2] = (self.t0, self.t1)
        T[:2, :2] = self.asarray()
        return T

    def astuple(self) -> tuple:
        return (
            self.scale0,
            self.scale1,
            self.shear1,
            self.angle,
            self.t0,
            self.t1,
        )

    def __call__(self, x: np.ndarray, shift=True) -> np.ndarray:
        result = x @ self.asarray()
        if shift:
            result = result + np.array((self.t0, self.t1))
        return result


def estimate_global_transformation(
    positions0: np.ndarray,
    positions1: np.ndarray,
    weights: np.ndarray = None,
    transform=None,
) -> typing.Tuple[AffineTransform, float]:
    """Weighted least-squares fit of the global affine transformation."""
    a = np.pad(positions0, ((0, 0), (0, 1)), constant_values=1)
    try:
        if weights is not None:
            aw = a * weights[:, None]
            bw = positions1 * weights[:, None]
        else:
            aw, bw = a, positions1
        x, *_ = np.linalg.lstsq(aw, bw, rcond=None)
        result = AffineTransform.fromarray(x)
    except np.linalg.LinAlgError:
        result = AffineTransform()
    return result, float(np.linalg.norm(result(positions0) - positions1))


def estimate_global_transformation_ransac(
    positions0: np.ndarray,
    positions1: np.ndarray,
    weights: np.ndarray = None,
    transform: AffineTransform = AffineTransform(),
    min_sample: int = 4,
    max_error: float = 32,
    min_consensus: float = 0.75,
    max_iter: int = 20,
    rng: np.random.Generator | None = None,
) -> typing.Tuple[AffineTransform, float]:
    """RANSAC estimate of the global affine transformation.

    Candidate fits on random subsets drawn from ``rng``; a candidate is
    accepted when at least ``min_consensus`` of the points lie within
    ``max_error`` of it, and is then refit on those inliers. Returns the
    best refit and its residual norm, or ``transform`` and ``inf`` when no
    candidate reaches consensus.
    """
    rng = np.random.default_rng() if rng is None else rng
    best_fitness = np.inf
    for subset in rng.choice(
        a=len(positions0), size=(max_iter, min_sample), replace=True
    ):
        candidate, _ = estimate_global_transformation(
            positions0[subset], positions1[subset], weights=None
        )
        position_error = np.linalg.norm(
            candidate(positions0) - positions1, axis=-1
        )
        inliers = position_error <= max_error
        if np.sum(inliers) / len(inliers) >= min_consensus:
            candidate, fitness = estimate_global_transformation(
                positions0[inliers], positions1[inliers], weights=None
            )
            if fitness < best_fitness:
                best_fitness = fitness
                transform = candidate
    return transform, best_fitness


@dataclasses.dataclass
class PositionOptions:
    """Manage data and settings related to position correction.

    Its arrays (``initial_scan``, ``confidence``, ``_momentum``) are numpy
    on the host and tensors after :meth:`copy_to_device`.
    """

    initial_scan: np.ndarray
    """The original scan positions before position correction."""

    use_adaptive_moment: bool = False
    """Whether AdaM is used to accelerate position correction updates."""

    vdecay: float = 0.999
    """Second-moment decay."""

    mdecay: float = 0.9
    """First-moment decay."""

    use_position_regularization: bool = False
    """Whether positions are constrained to an affine + random error model."""

    update_magnitude_limit: float = 0
    """Clip per-epoch position update magnitudes to this value if > 0."""

    transform: AffineTransform = AffineTransform()
    """Global transform of positions."""

    origin: npt.NDArray = dataclasses.field(
        default_factory=lambda: np.zeros(2)
    )
    """Rotation center applied before fitting the global transformation."""

    confidence: np.ndarray = dataclasses.field(default_factory=lambda: None)
    """A rating of the confidence of position information at each position."""

    update_start: int = 0
    """Start position updates at this epoch."""

    _momentum: np.ndarray = dataclasses.field(
        init=False, default_factory=lambda: None
    )
    """(POSI, 4) AdaM state: second moment in [..., 0:2], first in [..., 2:4]."""

    def __post_init__(self):
        if not isinstance(self.initial_scan, torch.Tensor):
            self.initial_scan = np.asarray(self.initial_scan).astype(floating)
        if self.confidence is None:
            self.confidence = np.ones(
                shape=tuple(self.initial_scan.shape), dtype=floating
            )
        if self.use_adaptive_moment:
            self._momentum = np.zeros(
                (*self.initial_scan.shape[:-1], 4), dtype=floating
            )

    def _with_arrays(self, convert, initial_scan, confidence, momentum):
        """A copy with the given arrays, each passed through ``convert``."""
        out = PositionOptions(
            initial_scan=convert(initial_scan),
            use_adaptive_moment=self.use_adaptive_moment,
            vdecay=self.vdecay,
            mdecay=self.mdecay,
            use_position_regularization=self.use_position_regularization,
            update_magnitude_limit=self.update_magnitude_limit,
            transform=self.transform,
            origin=self.origin,
            confidence=None if confidence is None else convert(confidence),
            update_start=self.update_start,
        )
        if self.use_adaptive_moment and momentum is not None:
            out._momentum = convert(momentum)
        return out

    def copy_to_device(self, device) -> "PositionOptions":
        """Return a copy whose arrays are float32 tensors on ``device``."""
        device = torch.device(device)
        return self._with_arrays(
            lambda x: as_tensor(x, torch.float32, device),
            self.initial_scan,
            self.confidence,
            self._momentum,
        )

    def copy_to_host(self) -> "PositionOptions":
        """Return a copy whose arrays are float32 host numpy arrays."""
        return self._with_arrays(
            lambda x: to_numpy(x).astype(floating),
            self.initial_scan,
            self.confidence,
            self._momentum,
        )

    def split(self, indices) -> "PositionOptions":
        """Return host options with only the positions in ``indices``."""
        return self._with_arrays(
            lambda x: to_numpy(x)[..., indices, :].astype(floating),
            self.initial_scan,
            self.confidence,
            self._momentum,
        )

    def resample(self, factor: float) -> "PositionOptions":
        """Host options for a grid ``factor`` times as fine: the initial
        positions, the transform's shift and the origin scaled; the AdaM
        moments reset to zeros (or None without AdaM)."""
        out = self._with_arrays(
            lambda x: to_numpy(x).astype(floating), self.initial_scan, self.confidence, None
        )
        out.initial_scan = out.initial_scan * factor
        out.transform = self.transform.resample(factor)
        out.origin = self.origin * factor
        return out

    @staticmethod
    def join(x, reorder) -> "PositionOptions | None":
        """Concatenate the options of ``x`` and reorder their positions."""
        if x is None or any(e is None for e in x):
            return None

        def joined(name):
            parts = [getattr(e, name) for e in x]
            if parts[0] is None:
                return None
            return np.concatenate([to_numpy(p) for p in parts], axis=0)[
                reorder
            ]

        return x[0]._with_arrays(
            lambda a: a.astype(floating),
            joined("initial_scan"),
            joined("confidence"),
            joined("_momentum"),
        )

    # Momentum accessor views matching the reference API.
    @property
    def v(self):
        return self._momentum[..., 0:2]

    @v.setter
    def v(self, x):
        self._momentum[..., 0:2] = x

    @property
    def m(self):
        return self._momentum[..., 2:4]

    @m.setter
    def m(self, x):
        self._momentum[..., 2:4] = x


def check_allowed_positions(scan, psi, probe_shape):
    """Check that all positions are within the field of view.

    Positions must be >= 1 and positions + 1 + probe.shape <= psi.shape.
    """
    int_scan = np.asarray(scan) // 1
    min_corner = np.min(int_scan, axis=-2)
    max_corner = np.max(int_scan, axis=-2)
    valid_min = (1, 1)
    valid_max = (
        psi.shape[-2] - probe_shape[-2] - 1,
        psi.shape[-1] - probe_shape[-1] - 1,
    )
    if (
        min_corner[0] < valid_min[0]
        or min_corner[1] < valid_min[1]
        or max_corner[0] > valid_max[0]
        or max_corner[1] > valid_max[1]
    ):
        raise ValueError(
            "Scan positions must be >= 1 and "
            "scan positions + 1 + probe.shape must be <= psi.shape. "
            "psi may be too small or the scan positions may be scaled wrong. "
            f"The span of scan is {min_corner} to {max_corner}, and "
            f"the shape of psi is {psi.shape}."
        )


def _affine_position_helper(scan, position_options, max_error, relax=0.9):
    predicted = position_options.transform(
        to_numpy(position_options.initial_scan), shift=False
    )
    return scan * (1 - relax) + relax * predicted


def affine_position_regularization(
    updated,
    position_options: PositionOptions,
    max_error: float = 32,
    rng: np.random.Generator | None = None,
):
    """Fit the global affine position model, and apply it when asked.

    Fits ``position_options.transform`` from ``initial_scan`` to
    ``updated`` (both less ``origin``) by RANSAC with subsets drawn from
    ``rng``. With ``use_position_regularization`` the positions are then
    relaxed towards the fitted model; otherwise ``updated`` is returned as
    given. Returns ``(positions, position_options)``; a tensor input gives
    a tensor on its device.
    """
    updated_np = to_numpy(updated)
    new_transform, _ = estimate_global_transformation_ransac(
        positions0=to_numpy(position_options.initial_scan)
        - position_options.origin,
        positions1=updated_np - position_options.origin,
        transform=position_options.transform,
        max_error=max_error,
        rng=rng,
    )
    position_options.transform = new_transform
    if position_options.use_position_regularization:
        relaxed = _affine_position_helper(
            updated_np, position_options, max_error=max_error
        )
        if isinstance(updated, torch.Tensor):
            relaxed = as_tensor(relaxed, updated.dtype, updated.device)
        updated = relaxed
    return updated, position_options


def _gaussian_derivative_taps(sigma: float, truncate: float):
    """The radius, and the (offset, weight) taps of the order-1 Gaussian
    correlation kernel, without its numerically-zero taps.

    At the default sigma=0.333 the +-2 taps weigh ~1e-8 of the +-1 taps
    and the centre tap is exactly 0, so only two taps remain: each one
    dropped saves a full pass over the batch. The weights are rounded to
    float32, as the JAX package holds them.
    """
    radius = max(int(truncate * sigma + 0.5), 1)
    t = np.arange(-radius, radius + 1)
    g = np.exp(-0.5 * (t / sigma) ** 2)
    g /= g.sum()
    k = ((-t / sigma**2) * g)[::-1]
    keep = np.flatnonzero(np.abs(k) > 1e-6 * np.abs(k).max())
    return radius, [(int(i), float(np.float32(k[i]))) for i in keep]


def gaussian_gradient(x: torch.Tensor, sigma: float = 0.333, truncate: float = 6.0):
    """1st-order Gaussian derivative of the last two axes of x.

    Returns (d/dy, d/dx) of ``-x``, each of ``x``'s shape, correlating with
    the same taps as the JAX package and extending ``x`` at its borders
    with its edge values (numpy's ``"edge"`` padding). Complex tensors are
    handled directly: the taps are real, so this equals filtering the real
    and imaginary parts apart.
    """
    radius, taps = _gaussian_derivative_taps(sigma, truncate)

    def correlate(arr, dim):
        extent = arr.shape[dim]
        shape = list(arr.shape)
        shape[dim] = radius
        xp = torch.cat(
            [
                arr.narrow(dim, 0, 1).expand(shape),
                arr,
                arr.narrow(dim, extent - 1, 1).expand(shape),
            ],
            dim=dim,
        )
        acc = torch.zeros_like(arr)
        for i, k in taps:
            acc = acc + k * xp.narrow(dim, i, extent)
        return acc

    return correlate(-x, x.dim() - 2), correlate(-x, x.dim() - 1)


def update_positions_pd(cfg, data, psi, probe, scan, *, dx=-1.0, step=0.05):
    """Update scan positions by the gradient-of-intensity method (Dwivedi
    et al. 2018), as :func:`tike_tpu.ptycho.position.update_positions_pd`.

    data (B, DET, DET), psi (1, H, W), probe (..., M, P, P) and scan (B, 2)
    are tensors on one device. Per mode, the far field's derivatives with
    respect to the position come from finite differences of ``dx`` px along
    each axis; a per-position least-squares solve gives the shift that best
    explains the intensity residual, ``step`` of it is taken, and the mean
    position is restored (no drift). The forward model is ``ops.ptycho``'s,
    so on the card every far field launches the patch kernel. Returns
    ``(new_scan, cost)``: the new positions as a tensor, the Gaussian cost
    at them as a float. Positions outside the allowed window raise
    ``ValueError`` (:func:`check_allowed_positions`).
    """
    b = scan.shape[0]
    npix = cfg.detector_shape * cfg.detector_shape
    probe2 = probe.reshape((1, *probe.shape[-3:]))  # (1, M, P, P)
    dx = torch.tensor(dx, dtype=torch.float32, device=scan.device)
    step = torch.tensor(step, dtype=torch.float32, device=scan.device)

    intensity = intensity_from_farplane(ptycho_fwd(cfg, psi, scan, probe2))
    dI = (data - intensity).reshape(b, npix)

    dI_dx = torch.zeros((b, npix), dtype=torch.float32, device=scan.device)
    dI_dy = torch.zeros((b, npix), dtype=torch.float32, device=scan.device)
    for m in range(probe2.shape[-3]):
        pm = probe2[:, m : m + 1]
        f0 = ptycho_fwd(cfg, psi, scan, pm)
        fx = ptycho_fwd(cfg, psi, scan + torch.stack([0 * dx, dx]), pm)
        fy = ptycho_fwd(cfg, psi, scan + torch.stack([dx, 0 * dx]), pm)
        dI_dx = dI_dx + (2 * ((f0 - fx) / dx * torch.conj(f0)).real).reshape(b, npix)
        dI_dy = dI_dy + (2 * ((f0 - fy) / dx * torch.conj(f0)).real).reshape(b, npix)

    A = torch.stack([dI_dy, dI_dx], dim=-1)  # (B, npix, 2)
    grad = linalg.lstsq(A, dI[..., None])[..., 0]  # (B, 2)

    # Remove drift: keep the center of mass stationary.
    center0 = torch.mean(scan, dim=-2, keepdim=True)
    new_scan = scan - step * grad
    new_scan = new_scan + center0 - torch.mean(new_scan, dim=-2, keepdim=True)

    new_intensity = intensity_from_farplane(ptycho_fwd(cfg, psi, new_scan, probe2))
    cost = objective.COST["gaussian"](data, new_intensity)
    check_allowed_positions(to_numpy(new_scan), np.zeros(psi.shape), probe.shape)
    return new_scan, float(cost)
