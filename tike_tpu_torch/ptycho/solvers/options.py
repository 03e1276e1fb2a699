"""Algorithm options and the PtychoParameters state object.

Counterpart of :mod:`tike_tpu.ptycho.solvers.options`. PtychoParameters is
the solver state: probe, psi, scan, eigen probes/weights and the option
objects. Its arrays are numpy on the host and tensors after
:meth:`PtychoParameters.copy_to_device`.

The resize helpers of :meth:`PtychoParameters.resample` (multigrid) are
host numpy and scipy, copies of the JAX package's (the image-space ones
through :func:`tike_tpu_torch.view.resize_complex_image`): tensors go
through the host, so both packages resample the same bits. :func:`crop_fourier_space`
also takes a tensor and stays on its device.
"""

from __future__ import annotations

import abc
import copy
import dataclasses
import typing

import numpy as np
import torch

from ...precision import as_tensor, cfloating, floating, to_numpy
from ...view import resize_complex_image
from ..exitwave import ExitWaveOptions, crop_fourier_space  # noqa: F401
from ..object import ObjectOptions
from ..position import PositionOptions, check_allowed_positions
from ..probe import ProbeOptions


@dataclasses.dataclass
class IterativeOptions(abc.ABC):
    """A base class providing options for iterative algorithms."""

    name: str = dataclasses.field(default="", init=False)
    """The name of the algorithm."""

    num_batch: int = 1
    """The dataset is divided into this number of groups processed
    sequentially."""

    batch_method: str = "wobbly_center"
    """The name of the batch selection method from tike_tpu_torch.cluster."""

    rescale_method: str = "mean_of_abs_object"
    """'mean_of_abs_object' or 'constant_probe_photons' scaling control."""

    rescale_period: int = 10
    """How often (epochs) object/probe rescaling is applied."""

    costs: typing.List[typing.List[float]] = dataclasses.field(
        init=False, default_factory=list
    )
    """The objective function value at previous iterations."""

    num_iter: int = 1
    """The number of epochs to process before returning."""

    times: typing.List[float] = dataclasses.field(
        init=False, default_factory=list
    )
    """The per-iteration wall-time for each previous iteration."""

    convergence_window: int = 0
    """Number of epochs for convergence monitoring; < 2 disables."""

    time_limit: float = np.inf
    """Stop reconstruction when wall-time exceeds this number of seconds."""


@dataclasses.dataclass
class RpieOptions(IterativeOptions):
    """Options for the regularized ptychographic iterative engine."""

    name: str = dataclasses.field(default="rpie", init=False)

    num_batch: int = 5

    alpha: float = 0.05
    """Step-length control; rPIE becomes ePIE when this is 1."""


@dataclasses.dataclass
class LstsqOptions(IterativeOptions):
    """Options for the least-squares maximum-likelihood solver (LSQML)."""

    name: str = dataclasses.field(default="lstsq_grad", init=False)


def _shape(x) -> tuple:
    return tuple(x.shape)


def _host_or_device(x, dtype):
    """A field that does not depend on the positions, as ``split`` passes
    it on: a tensor as it is (so an object kept on the device between
    calls stays there), anything else as a numpy array of ``dtype``."""
    if x is None or isinstance(x, torch.Tensor):
        return x
    return np.asarray(x).astype(dtype)


def _moments_to_host(options):
    """A shallow copy of object or probe ``options`` whose moment states
    (``v``, ``m``) are host numpy arrays."""
    if options is None:
        return None
    out = copy.copy(options)
    out.v, out.m = to_numpy(options.v), to_numpy(options.m)
    return out


@dataclasses.dataclass
class PtychoParameters:
    """The entire ptychography solver state."""

    probe: typing.Any
    """(1, 1, SHARED, WIDE, HIGH) complex64 shared illumination."""

    psi: typing.Any
    """(DEPTH, WIDE, HIGH) complex64 object transmission."""

    scan: typing.Any
    """(POSI, 2) float32 probe min-corner positions (y, x)."""

    eigen_probe: typing.Any = None
    """(1, EIGEN, SHARED, WIDE, HIGH) complex64 eigen probes."""

    eigen_weights: typing.Any = None
    """(POSI, EIGEN+1, SHARED) float32 eigen-probe weights."""

    algorithm_options: IterativeOptions = dataclasses.field(
        default_factory=RpieOptions
    )
    """Algorithm-specific parameters."""

    exitwave_options: typing.Union[ExitWaveOptions, None] = None
    """Settings related to exitwave updates."""

    probe_options: typing.Union[ProbeOptions, None] = None
    """Settings related to probe updates."""

    object_options: typing.Union[ObjectOptions, None] = None
    """Settings related to object updates."""

    position_options: typing.Union[PositionOptions, None] = None
    """Settings related to position correction."""

    def __post_init__(self):
        scan, probe, psi = _shape(self.scan), _shape(self.probe), _shape(self.psi)
        if len(scan) != 2 or scan[1] != 2 or min(scan) < 1:
            raise ValueError(
                f"scan shape {scan} is incorrect. It should be (N, 2) "
                "where N >= 1 is the number of scan positions."
            )
        if (
            len(probe) != 5
            or probe[:2] != (1, 1)
            or min(probe) < 1
            or probe[-2] != probe[-1]
        ):
            raise ValueError(
                f"probe shape {probe} is incorrect. "
                "It should be (1, 1, S, W, H) "
                "where S >=1 is the number of probes, and "
                "W, H >= 1 are the square probe grid dimensions."
            )
        if len(psi) != 3 or psi[-2] <= probe[-2] or psi[-1] <= probe[-1]:
            raise ValueError(
                f"psi shape {psi} is incorrect. "
                "It should be (D, W, H) where W, H > probe.shape[-2:]."
            )
        # Value checks only for host arrays: reading device tensors here
        # would synchronize on every construction.
        if isinstance(self.scan, np.ndarray):
            check_allowed_positions(self.scan, self.psi, probe)
        if self.exitwave_options is None:
            self.exitwave_options = ExitWaveOptions(
                measured_pixels=np.ones(probe[-2:], dtype=np.bool_)
            )

    def copy_to_device(self, device) -> "PtychoParameters":
        """Return a copy whose arrays are tensors on ``device``."""
        device = torch.device(device)
        return dataclasses.replace(
            self,
            probe=as_tensor(self.probe, torch.complex64, device),
            psi=as_tensor(self.psi, torch.complex64, device),
            scan=as_tensor(self.scan, torch.float32, device),
            eigen_probe=None
            if self.eigen_probe is None
            else as_tensor(self.eigen_probe, torch.complex64, device),
            eigen_weights=None
            if self.eigen_weights is None
            else as_tensor(self.eigen_weights, torch.float32, device),
            exitwave_options=self.exitwave_options.copy_to_device(device),
            probe_options=copy.copy(self.probe_options),
            object_options=copy.copy(self.object_options),
            position_options=None
            if self.position_options is None
            else self.position_options.copy_to_device(device),
        )

    def copy_to_host(self) -> "PtychoParameters":
        """Return a copy whose arrays are host numpy arrays."""
        return dataclasses.replace(
            self,
            probe=to_numpy(self.probe).astype(cfloating),
            psi=to_numpy(self.psi).astype(cfloating),
            scan=to_numpy(self.scan).astype(floating),
            eigen_probe=to_numpy(self.eigen_probe),
            eigen_weights=to_numpy(self.eigen_weights),
            exitwave_options=self.exitwave_options.copy_to_host(),
            probe_options=_moments_to_host(self.probe_options),
            object_options=_moments_to_host(self.object_options),
            position_options=None
            if self.position_options is None
            else self.position_options.copy_to_host(),
        )

    def resample(
        self,
        factor: float,
        interp: typing.Optional[typing.Callable] = None,
    ) -> "PtychoParameters":
        """Return new host parameters rescaled by ``factor``: the probe and
        eigen probes by ``interp`` (default :func:`_resize_fft`), psi by a
        spline zoom, the positions scaled, the options resampled (their
        moments reset). The algorithm options are passed on as they are, so
        the cost history runs on across levels."""
        interp = _resize_fft if interp is None else interp
        return PtychoParameters(
            probe=interp(to_numpy(self.probe), factor).astype(cfloating),
            psi=_resize_spline(to_numpy(self.psi), factor).astype(cfloating),
            scan=to_numpy(self.scan) * factor,
            eigen_probe=interp(to_numpy(self.eigen_probe), factor).astype(cfloating)
            if self.eigen_probe is not None
            else None,
            eigen_weights=self.eigen_weights,
            algorithm_options=self.algorithm_options,
            probe_options=self.probe_options.resample(factor, interp)
            if self.probe_options is not None
            else None,
            object_options=self.object_options.resample(factor, interp)
            if self.object_options is not None
            else None,
            position_options=self.position_options.resample(factor)
            if self.position_options is not None
            else None,
            exitwave_options=self.exitwave_options.resample(factor)
            if self.exitwave_options is not None
            else None,
        )

    @staticmethod
    def split(indices, *, x: "PtychoParameters") -> "PtychoParameters":
        """Return new parameters with only the positions in indices: the
        per-position arrays as host arrays, the probe, psi and eigen probes
        as ``x`` holds them (tensors stay where they are)."""
        return PtychoParameters(
            probe=_host_or_device(x.probe, cfloating),
            psi=_host_or_device(x.psi, cfloating),
            scan=to_numpy(x.scan)[indices].astype(floating),
            eigen_probe=_host_or_device(x.eigen_probe, cfloating),
            eigen_weights=None
            if x.eigen_weights is None
            else to_numpy(x.eigen_weights)[indices].astype(floating),
            algorithm_options=copy.deepcopy(x.algorithm_options),
            exitwave_options=x.exitwave_options,
            probe_options=x.probe_options,
            object_options=x.object_options,
            position_options=None
            if x.position_options is None
            else x.position_options.split(indices),
        )

    @staticmethod
    def join(
        x: typing.Sequence["PtychoParameters"],
        reorder,
        stripe_start: typing.Optional[typing.Sequence[int]],
    ) -> "PtychoParameters":
        """Return host parameters joined from the parts ``x``, one for each
        stripe of positions, as :meth:`tike_tpu.ptycho.solvers.PtychoParameters.join`
        joins them: the per-position arrays (scan, eigen weights, position
        options) concatenated in part order and put in the order
        ``reorder``, the probe and eigen probes of the first part, and psi
        that of the first part with the rows ``stripe_start[i] + w`` up to
        ``stripe_start[i + 1] + w`` (to the end for the last part) taken
        from part ``i``, ``w`` half the probe's width. With one part
        ``stripe_start`` is not read.
        """

        def join_psi(parts):
            joined = np.array(parts[0], copy=True)
            w = x[0].probe.shape[-2] // 2
            for i in range(1, len(parts)):
                lo = stripe_start[i] + w
                hi = stripe_start[i + 1] + w if i + 1 < len(parts) else parts[0].shape[1]
                joined[:, lo:hi, :] = parts[i][:, lo:hi, :]
            return joined

        return PtychoParameters(
            probe=to_numpy(x[0].probe),
            psi=join_psi([to_numpy(e.psi) for e in x]),
            scan=np.concatenate([to_numpy(e.scan) for e in x], axis=0)[reorder],
            eigen_probe=to_numpy(x[0].eigen_probe),
            eigen_weights=None
            if x[0].eigen_weights is None
            else np.concatenate([to_numpy(e.eigen_weights) for e in x], axis=0)[reorder],
            algorithm_options=x[0].algorithm_options,
            exitwave_options=x[0].exitwave_options,
            probe_options=x[0].probe_options,
            object_options=x[0].object_options,
            position_options=PositionOptions.join(
                [e.position_options for e in x], reorder
            ),
        )


def _device_fields(parameters: PtychoParameters) -> torch.device:
    """Make the arrays of ``parameters`` tensors on one device, in place,
    and return that device: psi's if psi is a tensor, else the card
    ('cuda'), the default of the port's entry points. Arrays already there
    stay the objects they are."""
    p = parameters
    device = p.psi.device if isinstance(p.psi, torch.Tensor) else torch.device("cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the parameters hold host arrays, which go to the card, but "
            "torch.cuda.is_available() is false; copy them to a device "
            "with PtychoParameters.copy_to_device"
        )
    p.psi = as_tensor(p.psi, torch.complex64, device)
    p.probe = as_tensor(p.probe, torch.complex64, device)
    p.scan = as_tensor(p.scan, torch.float32, device)
    if p.eigen_probe is not None:
        p.eigen_probe = as_tensor(p.eigen_probe, torch.complex64, device)
    if p.eigen_weights is not None:
        p.eigen_weights = as_tensor(p.eigen_weights, torch.float32, device)
    p.exitwave_options = p.exitwave_options.copy_to_device(device)
    if p.position_options is not None:
        p.position_options = p.position_options.copy_to_device(device)
    return device


def _batch_tensors(batches, device):
    """The ``(indices, mask)`` pair of ``cluster.batches_padded`` on
    ``device``: ``(batch_idx (nb, L) int64, batch_mask (nb, L) float32,
    batch_real)``, ``batch_real[n]`` the int64 slots of batch n whose mask
    is above 0."""
    idx, mask = (to_numpy(b) for b in batches)
    return (
        torch.as_tensor(idx, dtype=torch.int64, device=device),
        torch.as_tensor(mask, dtype=torch.float32, device=device),
        [torch.as_tensor(np.flatnonzero(m > 0), device=device) for m in mask],
    )


def _resize_spline(x: np.ndarray, f: float) -> np.ndarray:
    import scipy.ndimage

    return scipy.ndimage.zoom(
        x, zoom=[1] * (x.ndim - 2) + [f, f], grid_mode=True, prefilter=False
    )


def pad_fourier_space(x: np.ndarray, w: int) -> np.ndarray:
    """Pad x assuming 2D frequency space with zero frequency in corner."""
    assert x.shape[-2] == x.shape[-1], "Only works on square arrays right now."
    half1 = x.shape[-1] // 2
    half0 = x.shape[-1] - half1
    new_x = np.zeros((*x.shape[:-2], w, w), dtype=x.dtype)
    new_x[..., 0:half0, np.r_[0:half0, (w - half1) : w]] = x[..., 0:half0, :]
    new_x[..., -half1:, np.r_[0:half0, (w - half1) : w]] = x[..., -half1:, :]
    return new_x


def _resize_fft(x: np.ndarray, f: float) -> np.ndarray:
    """Fourier interpolation resize of the last 2 dimensions of x."""
    if f == 1:
        return x
    crop_or_pad = crop_fourier_space if f < 1 else pad_fourier_space
    return np.fft.ifft2(
        crop_or_pad(
            np.fft.fft2(x, norm="ortho", axes=(-2, -1)),
            w=int(x.shape[-1] * f),
        ),
        norm="ortho",
        axes=(-2, -1),
    )


def _resize_cv(x: np.ndarray, f: float, interpolation: int) -> np.ndarray:
    """Image-space resize of the last 2 dims of x, image by image."""
    shape = x.shape
    flat = x.reshape(-1, *shape[-2:])
    out = [
        resize_complex_image(img, scale_factor=(f, f), interpolation=interpolation)
        for img in flat
    ]
    return np.asarray(out).reshape(*shape[:-2], *out[0].shape[-2:])


def _resize_linear(x: np.ndarray, f: float) -> np.ndarray:
    return _resize_cv(x, f, 1)


def _resize_cubic(x: np.ndarray, f: float) -> np.ndarray:
    return _resize_cv(x, f, 2)


def _resize_lanczos(x: np.ndarray, f: float) -> np.ndarray:
    return _resize_cv(x, f, 4)
