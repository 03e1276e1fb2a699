"""Algorithm options and the PtychoParameters state object.

Counterpart of :mod:`tike_tpu.ptycho.solvers.options`. PtychoParameters is
the solver state: probe, psi, scan, eigen probes/weights and the option
objects. Its arrays are numpy on the host and tensors after
:meth:`PtychoParameters.copy_to_device`.
"""

from __future__ import annotations

import abc
import copy
import dataclasses
import typing

import numpy as np
import torch

from ...precision import as_tensor, cfloating, floating, to_numpy
from ..exitwave import ExitWaveOptions
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

    @staticmethod
    def split(indices, *, x: "PtychoParameters") -> "PtychoParameters":
        """Return new host parameters with only the positions in indices."""
        return PtychoParameters(
            probe=to_numpy(x.probe).astype(cfloating),
            psi=to_numpy(x.psi).astype(cfloating),
            scan=to_numpy(x.scan)[indices].astype(floating),
            eigen_probe=None
            if x.eigen_probe is None
            else to_numpy(x.eigen_probe).astype(cfloating),
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
        x: typing.Sequence["PtychoParameters"], reorder
    ) -> "PtychoParameters":
        """Return host parameters with the per-position arrays (scan, eigen
        weights, position options) put back in the order ``reorder``.

        ``x`` holds the parameters of each device; the port runs on one, so
        ``x`` has one element (joining object stripes is not ported).
        """
        if len(x) != 1:
            raise NotImplementedError("joining object stripes is not ported yet")
        (p,) = x
        return PtychoParameters(
            probe=to_numpy(p.probe),
            psi=to_numpy(p.psi),
            scan=to_numpy(p.scan)[reorder],
            eigen_probe=to_numpy(p.eigen_probe),
            eigen_weights=None
            if p.eigen_weights is None
            else to_numpy(p.eigen_weights)[reorder],
            algorithm_options=p.algorithm_options,
            exitwave_options=p.exitwave_options,
            probe_options=p.probe_options,
            object_options=p.object_options,
            position_options=PositionOptions.join(
                [p.position_options], reorder
            ),
        )
