"""User-facing ptychography entry points: reconstruct, Reconstruction, simulate.

Counterpart of :mod:`tike_tpu.ptycho.ptycho` for one device and the
replicated layout. The device is explicit: pass a ``torch.device`` (or its
name) to :class:`Reconstruction`, :func:`reconstruct` and :func:`simulate`.
Data stays on that device for the whole reconstruction; there is no host
streaming yet.

Ported: LSQML (``LstsqOptions``) with compact batching, one object slice,
one probe mode, object and probe recovery with the default constraints,
the Gaussian noise model, and the mean-abs object rescale. Any option
outside that raises ``NotImplementedError`` when the Reconstruction is
created.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import time
import typing
import warnings

import numpy as np
import torch

from .. import cluster
from ..ops.ptycho import (
    PtychoConfig,
    intensity_from_farplane,
    ptycho_fwd,
    simulate_intensity,
)
from ..precision import as_tensor, to_numpy
from .probe import get_varying_probe
from .solvers import _preconditioner
from .solvers.epoch import EpochPlan, _epoch_math
from .solvers.options import PtychoParameters

__all__ = [
    "reconstruct",
    "simulate",
    "simulate_device",
    "Reconstruction",
]

logger = logging.getLogger(__name__)


def _resolve_device(device, **inputs) -> torch.device:
    """Return ``device`` as a torch.device, checked against the inputs.

    Host arrays and CPU tensors among ``inputs`` are copied to ``device``;
    a tensor that already lies on another device raises instead of being
    moved, so work never leaves the card without the caller asking.
    """
    if device is None:
        raise TypeError(
            "device is required: pass a torch.device or its name, "
            "such as 'cuda' or 'cpu'"
        )
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} was requested but torch.cuda.is_available() "
            "is false"
        )
    for name, x in inputs.items():
        if not isinstance(x, torch.Tensor) or x.device.type == "cpu":
            continue
        if x.device.type != device.type or (
            device.index is not None and x.device.index != device.index
        ):
            raise ValueError(
                f"{name} is on {x.device} but device is {device}; "
                f"move it or pass device={str(x.device)!r}"
            )
    return device


def _parameter_tensors(parameters: PtychoParameters) -> dict:
    """The arrays of ``parameters`` by name, for :func:`_resolve_device`."""
    return {
        "parameters.probe": parameters.probe,
        "parameters.psi": parameters.psi,
        "parameters.scan": parameters.scan,
        "parameters.eigen_probe": parameters.eigen_probe,
        "parameters.eigen_weights": parameters.eigen_weights,
        "parameters.exitwave_options.measured_pixels": (
            parameters.exitwave_options.measured_pixels
        ),
    }


def simulate(
    detector_shape: int,
    probe,
    scan,
    psi,
    fly: int = 1,
    eigen_probe=None,
    eigen_weights=None,
    *,
    device,
    **kwargs,
) -> torch.Tensor:
    """Propagate the wavefront to the detector and return intensities.

    probe (1, 1, S, P, P), scan (N, 2) and psi (1, H, W), as arrays or
    tensors. Returns an (N, detector, detector) float32 tensor on
    ``device``, summed over probe modes. ``device`` is required; a tensor
    input on another device raises.
    """
    if fly != 1:
        raise NotImplementedError("fly-scan grouping is not ported yet")
    device = _resolve_device(
        device,
        probe=probe,
        scan=scan,
        psi=psi,
        eigen_probe=eigen_probe,
        eigen_weights=eigen_weights,
    )
    probe = as_tensor(probe, torch.complex64, device)
    psi = as_tensor(psi, torch.complex64, device)
    scan = as_tensor(scan, torch.float32, device)
    cfg = PtychoConfig(
        probe_shape=probe.shape[-1],
        detector_shape=detector_shape,
        nz=psi.shape[-2],
        n=psi.shape[-1],
        nslices=psi.shape[0],
        **{
            k: v
            for k, v in kwargs.items()
            if k
            in (
                "probe_wavelength",
                "probe_FOV_lengths",
                "multislice_propagation_distance",
            )
        },
    )
    unique = get_varying_probe(probe, eigen_probe, eigen_weights)
    return simulate_intensity(cfg, psi, scan, unique[:, 0])


# There is no relay between host and device here, so the device-resident
# variant of the JAX package is the same function.
simulate_device = simulate


def _unsupported(parameters: PtychoParameters) -> typing.List[str]:
    """What in ``parameters`` asks for something not ported yet."""
    algo = parameters.algorithm_options
    checks = {
        f"algorithm {algo.name!r} (only 'lstsq_grad')": (
            algo.name != "lstsq_grad"
        ),
        f"batch_method {algo.batch_method!r} (only 'compact')": (
            algo.batch_method != "compact"
        ),
        f"rescale_method {algo.rescale_method!r}": (
            algo.rescale_method != "mean_of_abs_object"
        ),
        "convergence_window >= 2": algo.convergence_window >= 2,
        "a finite time_limit": np.isfinite(algo.time_limit),
        "multislice objects": parameters.psi.shape[0] != 1,
        "multi-mode probes": parameters.probe.shape[-3] != 1,
        "eigen probes": (
            parameters.eigen_probe is not None
            or parameters.eigen_weights is not None
        ),
        "position correction": parameters.position_options is not None,
        "the Poisson noise model": (
            parameters.exitwave_options.noise_model != "gaussian"
        ),
    }
    out = [k for k, on in checks.items() if on]
    for opts in (parameters.object_options, parameters.probe_options):
        if opts is not None:
            out += opts.unsupported()
    return out


class Reconstruction:
    """Context manager for ptychography reconstruction on one device.

    Same API as :class:`tike_tpu.ptycho.Reconstruction`: data and
    parameters stay on ``device`` while the context is open, so
    :meth:`iterate` can be called repeatedly and :meth:`get_result`
    mid-run. The same ``random_seed`` gives the same mini-batches as the
    JAX package. ``device`` is required; a tensor in ``data`` or
    ``parameters`` that lies on another device raises.
    """

    def __init__(
        self,
        data,
        parameters: PtychoParameters,
        device,
        random_seed: typing.Optional[int] = None,
    ):
        if (
            data.ndim != 3
            or data.shape[0] < 1
            or min(data.shape[-2:]) < 1
            or data.shape[-2] != data.shape[-1]
        ):
            raise ValueError(
                f"data shape {tuple(data.shape)} is incorrect. "
                "It should be (N, W, H), "
                "where N >= 1 is the number of square diffraction patterns."
            )
        if data.shape[0] != parameters.scan.shape[0]:
            raise ValueError(
                f"data shape {tuple(data.shape)} and scan shape "
                f"{tuple(parameters.scan.shape)} are incompatible. They "
                "should have the same leading dimension."
            )
        if parameters.probe.shape[-1] > data.shape[-1]:
            raise ValueError(
                f"probe shape {tuple(parameters.probe.shape)} "
                f"and data shape {tuple(data.shape)} are incompatible. "
                "The probe width/height must be <= the data width/height."
            )
        missing = _unsupported(parameters)
        if missing:
            raise NotImplementedError(
                "not ported to tike_tpu_torch yet: " + "; ".join(missing)
            )
        self.device = _resolve_device(
            device, data=data, **_parameter_tensors(parameters)
        )
        self.data_host = data
        self.parameters_host = copy.deepcopy(parameters)
        probe_options = parameters.probe_options
        self.operator = PtychoConfig(
            probe_shape=parameters.probe.shape[-1],
            detector_shape=data.shape[-1],
            nz=parameters.psi.shape[-2],
            n=parameters.psi.shape[-1],
            nslices=parameters.psi.shape[0],
            probe_wavelength=(
                probe_options.probe_wavelength
                if probe_options is not None
                else 1e-9
            ),
            probe_FOV_lengths=(
                tuple(probe_options.probe_FOV_lengths)
                if probe_options is not None
                else (1e-6, 1e-6)
            ),
        )
        self._rng = np.random.default_rng(random_seed)

    def __enter__(self):
        data = self.data_host
        if isinstance(data, torch.Tensor):
            data_ok = not bool(
                torch.any(~torch.isfinite(data)) or torch.any(data < 0)
            )
        else:
            data_ok = np.all(np.isfinite(data)) and not np.any(data < 0)
        if not data_ok:
            warnings.warn(
                "Diffraction patterns contain invalid data. "
                "All data should be non-negative and finite.",
                UserWarning,
            )
        # Order the data by batches, contiguous on the device.
        order, batches, _ = cluster.by_scan_stripes_contiguous(
            scan=to_numpy(self.parameters_host.scan),
            num_stripes=1,
            batch_method=self.parameters_host.algorithm_options.batch_method,
            num_batch=self.parameters_host.algorithm_options.num_batch,
            rng=self._rng,
        )
        self.order = order[0]
        self.batches = cluster.batches_padded(batches[0])
        batch_idx, batch_mask = self.batches
        self._batch_idx = torch.as_tensor(
            batch_idx, dtype=torch.int64, device=self.device
        )
        self._batch_mask = torch.as_tensor(batch_mask, device=self.device)

        self.parameters = PtychoParameters.split(
            self.order, x=self.parameters_host
        ).copy_to_device(self.device)
        # Store data batch-major (num_batch, L, DET, DET).
        perm = self.order[batch_idx.reshape(-1)]
        if isinstance(data, torch.Tensor):
            data = as_tensor(data, torch.float32, self.device)[
                torch.as_tensor(perm, device=self.device)
            ]
        else:
            data = as_tensor(np.asarray(data)[perm], torch.float32, self.device)
        self.data = data.reshape(*batch_idx.shape, *data.shape[-2:])

        popts = self.parameters.probe_options
        if popts is not None and popts.init_rescale_from_measurements:
            self.parameters = _rescale_probe(
                self.operator,
                self.data,
                self._batch_idx,
                self._batch_mask,
                self.parameters,
            )
        return self

    def _make_plan(self) -> EpochPlan:
        p = self.parameters
        popts = p.probe_options
        oopts = p.object_options
        algo = p.algorithm_options
        return EpochPlan(
            cfg=self.operator,
            noise_model=p.exitwave_options.noise_model,
            steplength_usemodes=p.exitwave_options.step_length_usemodes,
            recover_psi=oopts is not None,
            recover_probe=popts is not None,
            update_start=popts.update_start if popts else 0,
            update_period=popts.update_period if popts else 1,
            rescale_mean_abs=(
                oopts is not None
                and algo.rescale_method == "mean_of_abs_object"
            ),
            rescale_period=algo.rescale_period,
            fft_precond=_preconditioner.fft_precond_profitable(
                n_positions=p.scan.shape[0],
                probe_shape=self.operator.probe_shape,
                nz=self.operator.nz,
                n=self.operator.n,
            ),
        )

    def iterate(self, num_iter: int) -> None:
        """Advance the reconstruction by ``num_iter`` epochs.

        The per-epoch costs and probe powers stay on the device until all
        epochs have run, then come to the host in one transfer; each epoch
        is recorded with the mean wall time of the call.
        """
        if num_iter < 1:
            return
        p = self.parameters
        algo = p.algorithm_options
        plan = self._make_plan()
        epoch0 = len(algo.times)
        costs, powers = [], []
        start = time.perf_counter()
        for e in range(num_iter):
            p.psi, p.probe, cost, pwr = _epoch_math(
                plan,
                self.data,
                p.scan,
                self._batch_idx,
                self._batch_mask,
                p.psi,
                p.probe,
                p.exitwave_options,
                epoch0 + e,
            )
            costs.append(cost)
            powers.append(pwr)
        costs_host = to_numpy(torch.stack(costs))  # waits for the device
        powers_host = to_numpy(torch.stack(powers))
        elapsed = time.perf_counter() - start
        for e in range(num_iter):
            algo.costs.append([float(costs_host[e])])
            algo.times.append(elapsed / num_iter)
            if p.probe_options is not None:
                p.probe_options.power.append(powers_host[e])
        logger.info(
            "%10s cost is %+1.3e (%d epochs)",
            p.exitwave_options.noise_model,
            float(costs_host[-1]),
            num_iter,
        )

    def get_result(self) -> PtychoParameters:
        """Return the current parameter estimates as host copies."""
        result = self.parameters.copy_to_host()
        return dataclasses.replace(
            result, scan=result.scan[np.argsort(self.order)]
        )

    def get_convergence(self):
        """Return the (costs, times) series."""
        return (
            self.parameters.algorithm_options.costs,
            self.parameters.algorithm_options.times,
        )

    def __exit__(self, type, value, traceback):
        self.parameters = self.parameters.copy_to_host()
        self.data = None


def reconstruct(
    data,
    parameters: PtychoParameters,
    device,
    random_seed: typing.Optional[int] = None,
) -> PtychoParameters:
    """Solve the ptychography problem (functional API) on ``device``."""
    with Reconstruction(
        data, parameters, device=device, random_seed=random_seed
    ) as context:
        context.iterate(parameters.algorithm_options.num_iter)
        return context.get_result()


def _rescale_probe(
    cfg: PtychoConfig,
    data,
    batch_idx,
    batch_mask,
    parameters: PtychoParameters,
) -> PtychoParameters:
    """Rescale the probe so modeled and measured total intensity match.

    ``data`` is batch-major (num_batch, L, DET, DET); padded slots (mask 0)
    are not counted. Sets ``probe_photons`` from the rescaled probe when it
    is unset.
    """
    w = parameters.exitwave_options.measured_pixels.to(torch.float32)
    s_data = torch.zeros((), device=data.device)
    s_model = torch.zeros((), device=data.device)
    for data_b, idx, bmask in zip(data, batch_idx, batch_mask):
        intensity = intensity_from_farplane(
            ptycho_fwd(
                cfg, parameters.psi, parameters.scan[idx], parameters.probe[:, 0]
            )
        )
        s_data = s_data + torch.sum(torch.sum(data_b * w, dim=(-2, -1)) * bmask)
        s_model = s_model + torch.sum(
            torch.sum(intensity * w, dim=(-2, -1)) * bmask
        )
    rescale = torch.sqrt(s_data / (s_model + 1e-32))
    logger.info("Probe rescaled by %f", float(rescale))
    parameters.probe = parameters.probe * rescale
    popts = parameters.probe_options
    if np.isnan(popts.probe_photons):
        popts.probe_photons = float(
            torch.sum(torch.square(torch.abs(parameters.probe)))
        )
    return parameters
