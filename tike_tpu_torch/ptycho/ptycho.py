"""User-facing ptychography entry points: reconstruct, Reconstruction, simulate.

Counterpart of :mod:`tike_tpu.ptycho.ptycho` for one device and the
replicated layout. :class:`Reconstruction`, :func:`reconstruct` and
:func:`simulate` run on the CUDA card (``device="cuda"``) unless the caller
passes another ``torch.device`` (or its name), such as ``"cpu"``; with no
card they raise rather than fall back to the CPU. Data stays on that
device for the whole reconstruction; there is no host streaming yet.

Ported: what the JAX package's fused single-device program runs for one
object slice. That is rPIE (``RpieOptions``) and LSQML (``LstsqOptions``)
with any batch method (compact batches in order, the others in a
permutation drawn per epoch), any number of shared probe modes, eigen
probes and weights (OPR), position correction for LSQML, the per-epoch
probe and object constraints, object and probe adaptive moments, the
Gaussian and Poisson noise models, and both rescale methods. Any option
outside that raises ``NotImplementedError`` when the Reconstruction is
created.
"""

from __future__ import annotations

import copy
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
from .position import affine_position_regularization
from .probe import get_varying_probe
from .solvers import _preconditioner
from .solvers.epoch import EpochPlan, EpochState, _epoch_math, seed_err_hist
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
            "device must be a torch.device or its name, such as 'cuda' "
            "(the default) or 'cpu'"
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


def simulate_device(
    detector_shape: int,
    probe,
    scan,
    psi,
    fly: int = 1,
    eigen_probe=None,
    eigen_weights=None,
    *,
    device="cuda",
    **kwargs,
) -> torch.Tensor:
    """:func:`simulate`, but the intensities stay on ``device``.

    probe (1, 1, S, P, P), scan (N, 2) and psi (1, H, W), and optionally
    eigen_probe (1, EIGEN, S', P, P) and eigen_weights (N, EIGEN+1, S), as
    arrays or tensors. Returns an (N, detector, detector) float32 tensor on
    ``device`` (the CUDA card unless the caller asks for another), which
    :class:`Reconstruction` takes as it is: per probe mode, the varying
    probe's far-field intensity, summed over modes. A tensor input on
    another device raises.
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
    if eigen_probe is not None:
        eigen_probe = as_tensor(eigen_probe, torch.complex64, device)
    if eigen_weights is not None:
        eigen_weights = as_tensor(eigen_weights, torch.float32, device)
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
    # One mode at a time, so only one mode's far field is held at once.
    intensity = None
    for m in range(probe.shape[-3]):
        unique = get_varying_probe(
            probe[..., m : m + 1, :, :],
            None if eigen_probe is None else eigen_probe[..., m : m + 1, :, :],
            None if eigen_weights is None else eigen_weights[..., m : m + 1],
        )
        mode_intensity = simulate_intensity(cfg, psi, scan, unique[:, 0])
        intensity = (
            mode_intensity if intensity is None else intensity + mode_intensity
        )
    return intensity


def simulate(
    detector_shape: int,
    probe,
    scan,
    psi,
    fly: int = 1,
    eigen_probe=None,
    eigen_weights=None,
    *,
    device="cuda",
    **kwargs,
) -> np.ndarray:
    """Propagate the wavefront to the detector and return intensities: an
    (N, detector, detector) float32 numpy array, as
    :func:`tike_tpu.ptycho.simulate` returns. Computed on ``device`` by
    :func:`simulate_device`, which returns the tensor there instead."""
    return to_numpy(
        simulate_device(
            detector_shape, probe, scan, psi, fly, eigen_probe, eigen_weights,
            device=device, **kwargs,
        )
    )


_RESCALE_METHODS = ("mean_of_abs_object", "constant_probe_photons")


def _unsupported(
    parameters: PtychoParameters,
    num_gpu=1,
    use_mpi: bool = False,
    mesh=None,
    store_data_on_device: typing.Optional[bool] = None,
    object_sharding: str = "replicated",
) -> typing.List[str]:
    """What in ``parameters`` or in the entry point's other arguments asks
    for something not ported yet."""
    algo = parameters.algorithm_options
    checks = {
        f"num_gpu = {num_gpu!r} (one device only: 1 or (1,))": (
            num_gpu not in (1, (1,))
        ),
        "use_mpi": bool(use_mpi),
        "a mesh": mesh is not None,
        "object_sharding='striped'": object_sharding == "striped",
        f"algorithm {algo.name!r} (only 'lstsq_grad' and 'rpie')": (
            algo.name not in ("lstsq_grad", "rpie")
        ),
        f"batch_method {algo.batch_method!r}": (
            algo.batch_method not in cluster.BATCH_METHODS
        ),
        f"rescale_method {algo.rescale_method!r}": (
            algo.rescale_method not in _RESCALE_METHODS
        ),
        "convergence_window >= 2": algo.convergence_window >= 2,
        "a finite time_limit": np.isfinite(algo.time_limit),
        "multislice objects": parameters.psi.shape[0] != 1,
        "position_options.use_position_regularization": (
            parameters.position_options is not None
            and parameters.position_options.use_position_regularization
        ),
        "position correction with rpie (only with lstsq_grad)": (
            parameters.position_options is not None and algo.name == "rpie"
        ),
        "host streaming (store_data_on_device=False)": (
            store_data_on_device is not None and not store_data_on_device
        ),
    }
    return [k for k, on in checks.items() if on]


class Reconstruction:
    """Context manager for ptychography reconstruction on one device.

    Same API as :class:`tike_tpu.ptycho.Reconstruction`: data and
    parameters stay on ``device`` while the context is open, so
    :meth:`iterate` can be called repeatedly and :meth:`get_result`
    mid-run. The same ``random_seed`` gives the same mini-batches as the
    JAX package. ``device`` is the CUDA card unless the caller asks for
    another, such as ``"cpu"``; a tensor in ``data`` or ``parameters`` that
    lies on another device raises.

    The parameters before ``device`` are the JAX package's, in its order.
    Of those, what is not ported raises ``NotImplementedError``: ``num_gpu``
    other than 1 or ``(1,)``, ``use_mpi``, a ``mesh``,
    ``object_sharding="striped"`` and ``store_data_on_device=False`` (host
    streaming; ``None``, the default, means on the device). ``device`` is
    keyword-only.
    """

    def __init__(
        self,
        data,
        parameters: PtychoParameters,
        num_gpu: typing.Union[int, typing.Tuple[int, ...]] = 1,
        use_mpi: bool = False,
        mesh=None,
        store_data_on_device: typing.Optional[bool] = None,
        random_seed: typing.Optional[int] = None,
        object_sharding: str = "replicated",
        *,
        device="cuda",
    ):
        if object_sharding not in ("replicated", "striped"):
            raise ValueError(
                "object_sharding must be 'replicated' or 'striped', "
                f"not {object_sharding!r}"
            )
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
        missing = _unsupported(
            parameters, num_gpu, use_mpi, mesh, store_data_on_device,
            object_sharding,
        )
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
        # The affine position fit draws from its own stream, so that it
        # leaves the batch draws of self._rng as they were.
        self._fit_rng = np.random.default_rng(
            np.random.SeedSequence(random_seed).spawn(1)[0]
        )

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
        # The real (unpadded) slots of each batch: eigen weights are
        # written back through these alone.
        self._batch_real = [
            torch.as_tensor(np.flatnonzero(m > 0), device=self.device)
            for m in batch_mask
        ]

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
        algo = self.parameters.algorithm_options
        if algo.rescale_method == "constant_probe_photons" and (
            popts is None or not np.isfinite(popts.probe_photons)
        ):
            raise ValueError(
                "rescale_method='constant_probe_photons' requires "
                "probe_options.probe_photons (set it explicitly, or enable "
                "init_rescale_from_measurements to derive it from the "
                "rescaled probe)"
            )
        return self

    def _make_plan(self) -> EpochPlan:
        p = self.parameters
        popts = p.probe_options
        oopts = p.object_options
        posopts = p.position_options
        algo = p.algorithm_options
        compact = algo.batch_method == "compact"
        rpie = algo.name == "rpie"
        # The moment kinds of the JAX package's fused program: rPIE takes
        # per-batch AdaM (epoch-end checked momentum when compact); LSQML
        # per-batch classical momentum (checked when compact) for the
        # object and the epoch-end checked momentum for the probe.
        obj_moment = "none"
        if oopts is not None and oopts.use_adaptive_moment:
            obj_moment = "checked" if compact else ("adam" if rpie else "momentum")
        probe_moment = "none"
        if popts is not None and popts.use_adaptive_moment:
            probe_moment = "adam" if rpie and not compact else "checked"
        return EpochPlan(
            cfg=self.operator,
            solver="rpie" if rpie else "lstsq",
            compact=compact,
            noise_model=p.exitwave_options.noise_model,
            steplength_usemodes=p.exitwave_options.step_length_usemodes,
            recover_psi=oopts is not None,
            recover_probe=popts is not None,
            update_start=popts.update_start if popts else 0,
            update_period=popts.update_period if popts else 1,
            probe_support=popts.probe_support if popts else 0.0,
            probe_support_radius=popts.probe_support_radius if popts else 0.35,
            probe_support_degree=popts.probe_support_degree if popts else 2.5,
            additional_probe_penalty=(
                popts.additional_probe_penalty if popts else 0.0
            ),
            median_filter=popts.median_filter_abs_probe if popts else False,
            median_filter_px=(
                tuple(popts.median_filter_abs_probe_px) if popts else (1.0, 1.0)
            ),
            force_center=popts.force_centered_intensity if popts else False,
            force_sparsity=popts.force_sparsity if popts else 0.0,
            force_orthogonality=popts.force_orthogonality if popts else False,
            positivity=float(oopts.positivity_constraint) if oopts else 0.0,
            smoothness=float(oopts.smoothness_constraint) if oopts else 0.0,
            clip_magnitude=bool(oopts.clip_magnitude) if oopts else False,
            rescale_mean_abs=(
                oopts is not None
                and algo.rescale_method == "mean_of_abs_object"
            ),
            rescale_photons=(
                float(popts.probe_photons)
                if popts is not None
                and algo.rescale_method == "constant_probe_photons"
                else 0.0
            ),
            rescale_period=algo.rescale_period,
            alpha=float(getattr(algo, "alpha", 0.05)),
            fft_precond=_preconditioner.fft_precond_profitable(
                n_positions=p.scan.shape[0],
                probe_shape=self.operator.probe_shape,
                nz=self.operator.nz,
                n=self.operator.n,
            ),
            has_eigen=p.eigen_weights is not None,
            obj_moment=obj_moment,
            probe_moment=probe_moment,
            obj_vdecay=oopts.vdecay if oopts else 0.999,
            obj_mdecay=oopts.mdecay if oopts else 0.9,
            probe_vdecay=popts.vdecay if popts else 0.999,
            probe_mdecay=popts.mdecay if popts else 0.9,
            recover_positions=posopts is not None,
            pos_update_start=posopts.update_start if posopts else 0,
            pos_use_adaptive_moment=(
                posopts.use_adaptive_moment if posopts else False
            ),
            pos_vdecay=posopts.vdecay if posopts else 0.999,
            pos_mdecay=posopts.mdecay if posopts else 0.9,
            pos_update_magnitude_limit=(
                posopts.update_magnitude_limit if posopts else 0.0
            ),
        )

    def _moment_states(self, plan: EpochPlan, state: EpochState) -> None:
        """Put the object and probe moment states into ``state``: those
        kept in the options by an earlier call (``ObjectOptions.v/m``,
        ``ProbeOptions.v/m``), or zeros of the plan's moment kinds; and the
        cost tail the checked momenta read, from the host cost history."""
        p = self.parameters
        dev = self.device

        def start(value, shape, dtype):
            if value is None:
                return torch.zeros(shape, dtype=dtype, device=dev)
            return as_tensor(value, dtype, dev)

        if plan.obj_moment != "none":
            oopts = p.object_options
            shape = tuple(p.psi.shape)
            state.obj_m = start(oopts.m, shape, torch.complex64)
            if plan.obj_moment == "adam":
                state.obj_v = start(oopts.v, shape, torch.float32)
            elif plan.obj_moment == "checked":
                state.obj_v = start(oopts.v, (3, *shape), torch.complex64)
        if plan.probe_moment != "none":
            popts = p.probe_options
            pw = p.probe.shape[-1]
            shape = (pw, pw) if plan.solver == "rpie" else (1, 1, pw, pw)
            state.probe_m = start(popts.m, shape, torch.complex64)
            if plan.probe_moment == "adam":
                state.probe_v = start(popts.v, shape, torch.float32)
            else:
                state.probe_v = start(popts.v, (3, *shape), torch.complex64)
        if "checked" in (plan.obj_moment, plan.probe_moment):
            costs = [float(c[0]) for c in p.algorithm_options.costs]
            state.err_hist = torch.as_tensor(seed_err_hist(costs), device=dev)

    def iterate(self, num_iter: int) -> None:
        """Advance the reconstruction by ``num_iter`` epochs.

        Compact batching runs the batches in order; the other batch
        methods in a permutation per epoch, all drawn from the
        reconstruction's generator when the call starts, as the JAX
        package's fused path draws them. The per-epoch costs and probe
        powers stay on the device until all epochs have run, then come to
        the host in one transfer; each epoch is recorded with the mean wall
        time of the call. Moment states are kept in the object, probe and
        position options between calls. With position correction the
        global affine transform is fitted once afterwards, as in the JAX
        package's fused path.
        """
        if num_iter < 1:
            return
        p = self.parameters
        algo = p.algorithm_options
        popt = p.position_options
        plan = self._make_plan()
        epoch0 = len(algo.times)
        nb = self.data.shape[0]
        if plan.compact:
            orders = [range(nb)] * num_iter
        else:
            orders = [self._rng.permutation(nb).tolist() for _ in range(num_iter)]
        state = EpochState(
            psi=p.psi,
            probe=p.probe,
            scan=p.scan,
            eigen_probe=p.eigen_probe,
            eigen_weights=p.eigen_weights,
        )
        if popt is not None and popt.use_adaptive_moment:
            if popt._momentum is None:
                state.pos_v = torch.zeros_like(p.scan)
                state.pos_m = torch.zeros_like(p.scan)
            else:
                state.pos_v = popt._momentum[..., 0:2]
                state.pos_m = popt._momentum[..., 2:4]
        self._moment_states(plan, state)
        costs, powers = [], []
        start = time.perf_counter()
        for e in range(num_iter):
            cost, pwr = _epoch_math(
                plan,
                self.data,
                self._batch_idx,
                self._batch_mask,
                self._batch_real,
                orders[e],
                state,
                p.exitwave_options,
                epoch0 + e,
            )
            costs.append(cost)
            powers.append(pwr)
            # Drop the last epoch's tensors as soon as the next exist.
            p.psi, p.probe, p.scan = state.psi, state.probe, state.scan
            p.eigen_probe = state.eigen_probe
            p.eigen_weights = state.eigen_weights
        if popt is not None and popt.use_adaptive_moment:
            popt._momentum = torch.cat([state.pos_v, state.pos_m], dim=-1)
        if plan.obj_moment != "none":
            p.object_options.m = state.obj_m
            if plan.obj_moment != "momentum":
                p.object_options.v = state.obj_v
        if plan.probe_moment != "none":
            p.probe_options.v = state.probe_v
            p.probe_options.m = state.probe_m
        costs_host = to_numpy(torch.stack(costs))  # waits for the device
        powers_host = to_numpy(torch.stack(powers))
        elapsed = time.perf_counter() - start
        if popt is not None:
            # Outside the recorded epoch times, as in the JAX package.
            p.scan, p.position_options = affine_position_regularization(
                p.scan, popt, rng=self._fit_rng
            )
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

    def get_scan(self) -> np.ndarray:
        """Return the current scan positions in the user's order."""
        return to_numpy(self.parameters.scan)[np.argsort(self.order)]

    def get_result(self) -> PtychoParameters:
        """Return the current parameter estimates as host copies, with the
        per-position arrays (scan, eigen weights, position options) in the
        user's order."""
        return PtychoParameters.join(
            [self.parameters.copy_to_host()], np.argsort(self.order)
        )

    def get_probe(self):
        """Return (probe, eigen_probe, eigen_weights) as numpy arrays, the
        eigen weights in the user's order."""
        p = self.parameters
        return (
            to_numpy(p.probe),
            to_numpy(p.eigen_probe),
            None
            if p.eigen_weights is None
            else to_numpy(p.eigen_weights)[np.argsort(self.order)],
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
    num_gpu: typing.Union[int, typing.Tuple[int, ...]] = 1,
    use_mpi: bool = False,
    mesh=None,
    object_sharding: str = "replicated",
    *,
    device="cuda",
    random_seed: typing.Optional[int] = None,
) -> PtychoParameters:
    """Solve the ptychography problem (functional API) on ``device``, the
    CUDA card unless the caller asks for another. The parameters before
    ``device`` are the JAX package's; see :class:`Reconstruction` for what
    of them raises."""
    with Reconstruction(
        data, parameters, num_gpu, use_mpi, mesh,
        random_seed=random_seed, object_sharding=object_sharding,
        device=device,
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
