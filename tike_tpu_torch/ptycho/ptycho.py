"""User-facing ptychography entry points: reconstruct, Reconstruction, simulate.

Counterpart of :mod:`tike_tpu.ptycho.ptycho` for one device, or one
process driving a mesh of devices (``mesh=``, :mod:`tike_tpu_torch.parallel`),
with the object replicated or split into row stripes
(``object_sharding="striped"``, :mod:`tike_tpu_torch.parallel.striped`).
:class:`Reconstruction`, :func:`reconstruct` and :func:`simulate` run on
the CUDA card (``device="cuda"``) unless the caller passes another
``torch.device`` (or its name), such as ``"cpu"``; with no card they raise
rather than fall back to the CPU. The diffraction data
stays on that device for the whole reconstruction, or, with
``store_data_on_device=False``, in pinned host memory from which each
batch is copied in while the batch before computes (:mod:`.stream`).

Ported: what the JAX package's single-device ``iterate`` runs. That is
rPIE (``RpieOptions``), for one object slice or several (multislice, with
``ObjectOptions.multislice_propagation_distance``,
``ProbeOptions.probe_wavelength`` and ``probe_FOV_lengths``), and LSQML
(``LstsqOptions``), which is single-slice as in the JAX package, with any
batch method (compact batches in order, the others in a permutation drawn
per epoch), any number of shared probe modes, eigen probes and weights
(OPR), position correction for LSQML, the per-epoch probe and object
constraints, object and probe adaptive moments, the Gaussian and Poisson
noise models, and both rescale methods, on one device or data-parallel on
a mesh (the slots of each batch split over the shards, padded to a
multiple of the mesh's size as the JAX package pads them). As in the JAX
package,
:meth:`Reconstruction.iterate` has two paths: all epochs of the call
enqueued with one host read at the end (the counterpart of its fused
program), and a per-epoch loop that reads each epoch's cost, which a finite
``time_limit``, the affine position regularization, position options with
rPIE and host streaming take. The striped object runs the same epochs on
each stripe's window of the object, the stripes reduced and their seams
cross-faded once an epoch. ``num_gpu`` and ``use_mpi`` are accepted and
not read, as in the JAX package, where ``mesh`` supersedes them. Any option
outside that raises ``NotImplementedError`` when the Reconstruction is
created. Several processes (``torch.distributed``) run the JAX package's
multi-process layout on a mesh of
:func:`tike_tpu_torch.parallel.distributed.global_mesh`: each process holds
its stripe of the patterns (:func:`~tike_tpu_torch.parallel.distributed.stripe_for_process`),
or of the striped object's (``striped_local_indices``), and all compute the
same result.
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

from .. import cluster, trace
from ..opt import is_converged
from ..ops.ptycho import (
    PtychoConfig,
    intensity_from_farplane,
    ptycho_fwd,
    simulate_intensity,
)
from ..parallel import all_reduce, distributed, home_device, striped
from ..precision import as_tensor, checked_device, to_numpy
from .position import affine_position_regularization, check_allowed_positions
from .probe import get_varying_probe
from .solvers import _preconditioner
from .solvers.epoch import (
    EpochPlan,
    EpochState,
    ShardedBatches,
    _epoch_math,
    plan_fields,
    seed_err_hist,
)
from .solvers.options import PtychoParameters, _batch_tensors, _resize_fft, crop_fourier_space
from .stream import StreamedBatches, iter_batches, pinned_batches

__all__ = [
    "reconstruct",
    "simulate",
    "simulate_device",
    "Reconstruction",
    "reconstruct_multigrid",
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
    device = checked_device(device)
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

    probe (1, 1, S, P, P), scan (N, 2) and psi (D, H, W), and optionally
    eigen_probe (1, EIGEN, S', P, P) and eigen_weights (N, EIGEN+1, S), as
    arrays or tensors; ``kwargs`` may hold ``probe_wavelength``,
    ``probe_FOV_lengths`` and ``multislice_propagation_distance``, which
    propagate the wave between the D slices. Returns an (N // fly,
    detector, detector) float32 tensor on ``device`` (the CUDA card unless
    the caller asks for another),
    which :class:`Reconstruction` takes as it is: per probe mode, the
    varying probe's far-field intensity, summed over modes and, in a fly
    scan, over each group of ``fly`` consecutive positions (the frames of
    one exposure). A tensor input on another device raises.
    """
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
    if fly > 1:
        intensity = intensity.reshape(
            scan.shape[-2] // fly, fly, detector_shape, detector_shape
        ).sum(dim=1)
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
    object_sharding: str = "replicated",
) -> typing.List[str]:
    """What in ``parameters`` or in the entry point's other arguments asks
    for something not ported yet."""
    algo = parameters.algorithm_options
    checks = {
        f"algorithm {algo.name!r} (only 'lstsq_grad' and 'rpie')": (
            algo.name not in ("lstsq_grad", "rpie")
        ),
        f"batch_method {algo.batch_method!r}": (
            algo.batch_method not in cluster.BATCH_METHODS
        ),
        f"rescale_method {algo.rescale_method!r}": (
            algo.rescale_method not in _RESCALE_METHODS
        ),
    }
    return [k for k, on in checks.items() if on]


def _check_striped_mesh(object_sharding: str, mesh) -> None:
    """The striped object is split over a mesh's shards, so it needs one,
    as the JAX package says."""
    if object_sharding == "striped" and mesh is None:
        raise ValueError("object_sharding='striped' requires a mesh")


def _check_single_slice_lstsq(parameters: PtychoParameters) -> None:
    """LSQML is single-slice in the JAX package, which asserts so; the
    port raises ValueError with its message."""
    if parameters.algorithm_options.name == "lstsq_grad" and parameters.psi.shape[0] != 1:
        raise ValueError(
            "LSQML is single-slice (like the reference); use rpie for "
            "multislice objects"
        )


def _per_epoch_reasons(parameters: PtychoParameters, streamed: bool) -> typing.List[str]:
    """Why :meth:`Reconstruction.iterate` takes the per-epoch loop for
    ``parameters``; empty when all epochs of a call can be enqueued at once
    (the JAX package's ``_fused_eligible``)."""
    algo = parameters.algorithm_options
    popt = parameters.position_options
    checks = {
        "a finite time_limit": algo.time_limit != np.inf,
        "position_options with rpie": popt is not None and algo.name == "rpie",
        "position_options.use_position_regularization": (
            popt is not None and popt.use_position_regularization
        ),
        "host streaming (store_data_on_device=False)": streamed,
    }
    return [k for k, on in checks.items() if on]


# The device working set of one batch, in complex64 arrays of the batch's
# exit waves (L, modes, DET, DET): the full-width runs of chip_smoke.py peak
# at 8 to 14 of them beside the data (PERF.md §6), so 16 leaves a margin.
_WORKING_ARRAYS = 16


def _data_fits_on_device(device, data_shape, num_batch: int, modes: int) -> bool:
    """Whether the data (N, DET, DET) in float32 and the working set of one
    of its ``num_batch`` batches fit into the free memory of the CUDA
    ``device`` (``torch.cuda.mem_get_info``). The CPU always holds its data."""
    if device.type != "cuda":
        return True
    free, _ = torch.cuda.mem_get_info(device)
    n, det = data_shape[0], data_shape[-1]
    per_batch = -(-n // max(int(num_batch), 1))
    working = _WORKING_ARRAYS * 8 * per_batch * modes * det * det
    return 4 * n * det * det + working < free


class Reconstruction:
    """Context manager for ptychography reconstruction on one device.

    Same API as :class:`tike_tpu.ptycho.Reconstruction`: the parameters
    stay on ``device`` while the context is open, so :meth:`iterate` can be
    called repeatedly and :meth:`get_result` mid-run. The same
    ``random_seed`` gives the same mini-batches as the JAX package.
    ``device`` is the CUDA card unless the caller asks for another, such as
    ``"cpu"``; a tensor in ``data`` or ``parameters`` that lies on another
    device raises.

    ``store_data_on_device=True`` keeps the batch-major data on the device;
    ``False`` keeps it on the host (page-locked for a card) and streams one
    batch at a time through two device buffers, so device memory holds two
    batches and the model whatever the number of patterns; ``None``, the
    default, streams only when the data and one batch's working set exceed
    the card's free memory. ``context.data`` is then a
    :class:`~tike_tpu_torch.ptycho.stream.StreamedBatches` whose ``host``
    is the host tensor. Data that already lies on the device cannot be
    streamed: ``False`` raises ``ValueError`` for it. A streamed and a
    resident run from one seed give the same bits.

    The parameters before ``device`` are the JAX package's, in its order.
    ``num_gpu`` and ``use_mpi`` are accepted and not read, as there.
    ``mesh`` (:func:`tike_tpu_torch.parallel.make_mesh`) runs the
    reconstruction data-parallel: the slots of each batch, padded to a
    multiple of ``mesh.size``, are split over the shards, and the object,
    probe and solver state stay on the first shard's device, which each
    shard reads; ``device`` must then name the mesh's type of device. Host
    streaming on a mesh copies each shard's slots of a batch to its device.
    ``object_sharding="striped"`` splits the object into row stripes over
    the mesh (:mod:`tike_tpu_torch.parallel.striped`), which needs host
    data; the probe is then rescaled from a sample of the measurements at
    set-up, as in the JAX package. LSQML
    with more than one object slice raises ``ValueError``, as the JAX
    package refuses it. ``device`` is keyword-only.

    A ``mesh`` across every process of a process group
    (:func:`~tike_tpu_torch.parallel.distributed.global_mesh`) takes the JAX
    package's multi-process layout: the patterns striped by their row
    coordinate, one stripe a process (``distributed.striped_batches``), and
    ``data`` either every pattern or this process's
    ``distributed.stripe_for_process(scan)`` rows; the striped object takes
    the full data or this process's ``striped.striped_local_indices`` rows
    (none, where its stripes hold no position). Every process draws the
    same batches (seed 0 where ``random_seed`` is None) and gets the same
    result. The keyword-only ``_force_stripes=k`` runs that layout of
    ``k`` processes in one process, on a mesh whose size ``k`` divides,
    as the JAX package's hook of that name does.
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
        _force_stripes: typing.Optional[int] = None,
    ):
        if object_sharding not in ("replicated", "striped"):
            raise ValueError(
                "object_sharding must be 'replicated' or 'striped', "
                f"not {object_sharding!r}"
            )
        self.object_sharding = object_sharding
        self.mesh = mesh
        self._force_stripes = _force_stripes
        # Across processes, a process whose stripes of the striped object
        # hold no position takes part with a block of no patterns.
        striped_across = object_sharding == "striped" and self._spans_processes()
        if (
            data.ndim != 3
            or data.shape[0] < (0 if striped_across else 1)
            or min(data.shape[-2:]) < 1
            or data.shape[-2] != data.shape[-1]
        ):
            raise ValueError(
                f"data shape {tuple(data.shape)} is incorrect. "
                "It should be (N, W, H), "
                "where N >= 1 is the number of square diffraction patterns."
            )
        if (
            data.shape[0] != parameters.scan.shape[0]
            and not self._is_multi_host()
            and not striped_across
        ):
            # Only the multi-process layouts take a process's part of the
            # data (checked against its stripe when the context opens).
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
        _check_striped_mesh(object_sharding, mesh)
        missing = _unsupported(parameters, object_sharding)
        if missing:
            raise NotImplementedError(
                "not ported to tike_tpu_torch yet: " + "; ".join(missing)
            )
        _check_single_slice_lstsq(parameters)
        if (
            (object_sharding == "striped" or self._is_multi_host())
            and isinstance(data, torch.Tensor)
            and data.device.type != "cpu"
        ):
            raise NotImplementedError(
                "device-resident data requires the replicated "
                "single-process layout; pass host data for striped or "
                "multi-process runs."
            )
        if mesh is not None:
            device = home_device(mesh, device)
        self.device = _resolve_device(
            device, data=data, **_parameter_tensors(parameters)
        )
        if isinstance(data, torch.Tensor) and data.device.type != "cpu":
            if store_data_on_device is False:
                raise ValueError(
                    "store_data_on_device=False (host streaming) requires "
                    "host data, but data is already device-resident."
                )
            store_data_on_device = True
        if store_data_on_device is None and mesh is not None:
            store_data_on_device = True
        if store_data_on_device is None:
            store_data_on_device = _data_fits_on_device(
                self.device,
                data.shape,
                parameters.algorithm_options.num_batch,
                parameters.probe.shape[-3],
            )
        self.store_data_on_device = bool(store_data_on_device)
        self.data_host = data
        self.parameters_host = copy.deepcopy(parameters)
        probe_options = parameters.probe_options
        object_options = parameters.object_options
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
            multislice_propagation_distance=(
                object_options.multislice_propagation_distance
                if object_options is not None
                else 1e-9
            ),
        )
        self._seed = random_seed
        self._seed_rngs(random_seed)

    def _seed_rngs(self, seed) -> None:
        self._rng = np.random.default_rng(seed)
        # The affine position fit draws from its own stream, so that it
        # leaves the batch draws of self._rng as they were.
        self._fit_rng = np.random.default_rng(np.random.SeedSequence(seed).spawn(1)[0])

    def _spans_processes(self) -> bool:
        """Whether the mesh spans every process of a process group."""
        count = distributed.process_count()
        return self.mesh is not None and count > 1 and self.mesh.process_count == count

    def _is_multi_host(self) -> bool:
        """Whether this run takes the stripe-major multi-process layout of
        the replicated object: a mesh across every process, or its
        emulation in one process (``_force_stripes``)."""
        return self.object_sharding == "replicated" and (
            self._spans_processes()
            or (self.mesh is not None and self._force_stripes is not None)
        )

    def __enter__(self):
        data = self.data_host
        if isinstance(data, torch.Tensor):
            # One pass and no temporaries (the data may be tens of GB on the
            # host): a NaN anywhere makes both ends NaN.
            low, high = torch.aminmax(data)
            data_ok = bool(low >= 0) and bool(torch.isfinite(high))
        else:
            data_ok = np.all(np.isfinite(data)) and not np.any(data < 0)
        if not data_ok:
            warnings.warn(
                "Diffraction patterns contain invalid data. "
                "All data should be non-negative and finite.",
                UserWarning,
            )
        if self.object_sharding == "striped":
            return self._enter_striped()
        if self._is_multi_host():
            return self._enter_multi_host()
        # Order the data by batches, contiguous on the device.
        started = time.perf_counter()
        order, batches, self.stripe_start = cluster.by_scan_stripes_contiguous(
            scan=to_numpy(self.parameters_host.scan),
            num_stripes=1,
            batch_method=self.parameters_host.algorithm_options.batch_method,
            num_batch=self.parameters_host.algorithm_options.num_batch,
            rng=self._rng,
        )
        self.order = order[0]
        # Each batch's slots split evenly over the mesh's shards, as the JAX
        # package pads them.
        self.batches = cluster.batches_padded(
            batches[0], multiple_of=1 if self.mesh is None else self.mesh.size
        )
        batch_idx = self.batches[0]
        # The real (unpadded) slots of each batch: eigen weights are
        # written back through these alone.
        self._batch_idx, self._batch_mask, self._batch_real = _batch_tensors(
            self.batches, self.device
        )

        self.parameters = PtychoParameters.split(
            self.order, x=self.parameters_host
        ).copy_to_device(self.device)
        clustered = time.perf_counter()
        # Store data batch-major (num_batch, L, DET, DET): on the device,
        # or on the host behind two device buffers.
        perm = self.order[batch_idx.reshape(-1)]
        if not self.store_data_on_device:
            self.data = StreamedBatches(
                pinned_batches(data, perm, batch_idx.shape, self.device),
                self.device,
            )
            if self.mesh is not None:
                self.data = ShardedBatches.split(
                    self.mesh, self.data, self._batch_idx, self._batch_mask
                )
        else:
            if isinstance(data, torch.Tensor):
                data = as_tensor(data, torch.float32, self.device)[
                    torch.as_tensor(perm, device=self.device)
                ]
            else:
                data = as_tensor(np.asarray(data)[perm], torch.float32, self.device)
            self.data = data.reshape(*batch_idx.shape, *data.shape[-2:])
            if self.mesh is not None:
                self.data = ShardedBatches.split(
                    self.mesh, self.data, self._batch_idx, self._batch_mask
                )

        stored = time.perf_counter()
        popts = self.parameters.probe_options
        if popts is not None and popts.init_rescale_from_measurements:
            self.parameters = _rescale_probe(
                self.operator,
                self.data,
                self._batch_idx,
                self._batch_mask,
                self.parameters,
            )
        # Host seconds of the set-up's parts (the rescale reads its scale
        # back, so it includes the device's work; the others may not).
        self.setup_seconds = {
            "clustering": clustered - started,
            "data": stored - clustered,
            "rescale": time.perf_counter() - stored,
        }
        self._check_photons()
        return self

    def _enter_multi_host(self):
        """The JAX package's multi-process layout of the replicated object
        (``tike_tpu.ptycho.Reconstruction._enter_multi_host``): the
        patterns in stripes along the row coordinate, one a process
        (``distributed.striped_batches``); each batch's slots stripe after
        stripe, each stripe padded to a common length, so that splitting
        the slots over the process-major mesh gives each process its own
        patterns. This process holds its stripe's block alone, on its shards
        or streamed from the host; in the one-process emulation
        (``_force_stripes``) it holds every stripe's. The batch layout is
        drawn alike in every process, from seed 0 where none is given."""
        started = time.perf_counter()
        data = self.data_host
        emulate = not self._spans_processes()
        n_proc = self._force_stripes if emulate else distributed.process_count()
        if n_proc < 1 or self.mesh.size % n_proc:
            raise ValueError(
                f"the mesh size ({self.mesh.size}) must be a positive multiple of "
                f"the process count ({n_proc}) so every process contributes the "
                "same number of devices"
            )
        if self._seed is None:
            self._seed_rngs(0)
            logger.info(
                "multi-process layout: no random_seed given; using 0 so every "
                "process draws the same batches"
            )
        scan_full = to_numpy(self.parameters_host.scan)
        algo = self.parameters_host.algorithm_options
        global_order, batch_idx, batch_mask, stripe_slots, self.stripe_start = (
            distributed.striped_batches(
                scan_full,
                n_proc,
                batch_method=algo.batch_method,
                num_batch=algo.num_batch,
                rng=self._rng,
                local_multiple=self.mesh.size // n_proc,
            )
        )
        self.order = global_order
        self.batches = (batch_idx, batch_mask)
        self._batch_idx, self._batch_mask, self._batch_real = _batch_tensors(
            self.batches, self.device
        )
        stripes = distributed.stripe_indices(scan_full, n_proc)
        offsets = np.cumsum([0] + [len(x) for x in stripes])

        def stripe_rows(pid: int) -> np.ndarray:
            """(nb, Lp) rows of ``data`` that fill stripe ``pid``'s slots."""
            segment = global_order[offsets[pid] : offsets[pid + 1]]
            if data.shape[0] == scan_full.shape[0]:
                rows = segment
            elif data.shape[0] == len(stripes[pid]):
                rows = striped.local_row_lookup(scan_full.shape[0], stripes[pid])[segment]
            else:
                raise ValueError(
                    f"data has {data.shape[0]} patterns but this process's stripe "
                    f"has {len(stripes[pid])} (or pass the full {scan_full.shape[0]})."
                )
            return rows[stripe_slots[pid][0]]

        pids = range(n_proc) if emulate else [distributed.process_index()]
        perm = np.concatenate([stripe_rows(pid) for pid in pids], axis=1)
        self.parameters = PtychoParameters.split(
            self.order, x=self.parameters_host
        ).copy_to_device(self.device)
        clustered = time.perf_counter()
        if self.store_data_on_device:
            if isinstance(data, torch.Tensor):
                block = data[torch.as_tensor(perm.reshape(-1))]
            else:
                block = np.asarray(data)[perm.reshape(-1)]
            block = as_tensor(block, torch.float32, self.device)
            block = block.reshape(*perm.shape, *block.shape[-2:])
        else:
            block = StreamedBatches(
                pinned_batches(data, perm, perm.shape, self.device), self.device
            )
        self.data = ShardedBatches.split(
            self.mesh, block, self._batch_idx, self._batch_mask
        )
        stored = time.perf_counter()
        popts = self.parameters.probe_options
        if popts is not None and popts.init_rescale_from_measurements:
            self.parameters = _rescale_probe(
                self.operator, self.data, self._batch_idx, self._batch_mask,
                self.parameters,
            )
        self.setup_seconds = {
            "clustering": clustered - started,
            "data": stored - clustered,
            "rescale": time.perf_counter() - stored,
        }
        self._check_photons()
        return self

    def _check_photons(self) -> None:
        p = self.parameters
        popts = p.probe_options
        if p.algorithm_options.rescale_method == "constant_probe_photons" and (
            popts is None or not np.isfinite(popts.probe_photons)
        ):
            raise ValueError(
                "rescale_method='constant_probe_photons' requires "
                "probe_options.probe_photons (set it explicitly, or enable "
                "init_rescale_from_measurements to derive it from the "
                "rescaled probe)"
            )

    def _enter_striped(self):
        """Set up the striped object (:mod:`tike_tpu_torch.parallel.striped`):
        each shard of the mesh owns a row stripe of psi and the positions in
        it; the probe is reduced and the halo rows cross-faded every epoch.
        As in the JAX package, the probe is rescaled from a sample of the
        measurements (``striped.estimate_probe_rescale``, on the host), and
        ``constant_probe_photons`` needs ``probe_photons``. Across processes
        every process draws the same batches (seed 0 where none is given),
        and where any process holds only its stripes' patterns, the rescale
        gathers the sampled patterns from the processes that hold them
        (``striped.estimate_probe_rescale_multihost``)."""
        started = time.perf_counter()
        p = self.parameters_host
        algo = p.algorithm_options
        data = to_numpy(self.data_host)
        probe = to_numpy(p.probe)
        multi = self._spans_processes()
        if multi and self._seed is None:
            self._seed_rngs(0)
            logger.info(
                "striped across processes: no random_seed given; using 0 so "
                "every process draws the same batches"
            )
        if p.probe_options is not None and p.probe_options.init_rescale_from_measurements:
            scan_full = to_numpy(p.scan)
            # Whether to enter the rescale's collective is decided from
            # every process's count: a process whose stripes hold every
            # position has a block the size of the whole data, and one
            # that decided from its own shape alone would leave the others
            # waiting in the collective.
            all_full = not multi or all(
                n == scan_full.shape[0]
                for n in distributed.gather_objects(int(data.shape[0]))
            )
            if all_full:
                scale = striped.estimate_probe_rescale(
                    data, to_numpy(p.psi), probe, scan_full, rng=self._rng
                )
            else:
                local_idx = striped.striped_local_indices(
                    scan_full, p.psi.shape[-2:], probe.shape[-1], self.mesh,
                    position_margin=8,
                )
                scale = striped.estimate_probe_rescale_multihost(
                    data, local_idx, to_numpy(p.psi), probe, scan_full, rng=self._rng
                )
            logger.info("Probe rescaled by %f (striped mode)", scale)
            probe = probe * scale
            if np.isnan(p.probe_options.probe_photons):
                p.probe_options.probe_photons = float(np.sum(np.square(np.abs(probe))))
        rescaled = time.perf_counter()
        self.parameters = copy.deepcopy(p)
        self._check_photons()
        # The striped epoch clamps the positions even with rPIE, which
        # leaves them in place otherwise, as in the JAX package.
        plan = dataclasses.replace(
            self._make_plan(), recover_positions=p.position_options is not None
        )
        ew = p.exitwave_options
        popt = p.position_options
        self._striped = striped.setup_striped_full(
            data,
            to_numpy(p.psi),
            probe,
            to_numpy(p.scan),
            mesh=self.mesh,
            epoch_plan=plan,
            batch_method=algo.batch_method,
            num_batch=int(algo.num_batch),
            store_data_on_device=self.store_data_on_device,
            eigen_probe=to_numpy(p.eigen_probe),
            eigen_weights=to_numpy(p.eigen_weights),
            measured_pixels=to_numpy(ew.measured_pixels),
            step_length_start=float(ew.step_length_start),
            step_length_weight=float(ew.step_length_weight),
            unmeasured_pixels_scaling=float(ew.unmeasured_pixels_scaling),
            position_margin=8,
            pos_momentum=None
            if popt is None or popt._momentum is None
            else to_numpy(popt._momentum),
            prev_costs=[float(c[0]) for c in algo.costs],
            rng=self._rng,
            epochs_done=len(algo.times),
        )
        self.order = np.arange(p.scan.shape[0])
        self.stripe_start = None
        self.data = self._striped.data
        self.setup_seconds = {
            "rescale": rescaled - started,
            **self._striped.setup_seconds,
        }
        return self

    def _iterate_striped(self, num_iter: int) -> None:
        """The striped object's epochs, as the JAX package runs them: in
        chunks of ``convergence_window // 2`` epochs (all epochs at once
        without a window), each chunk's costs read once, the ``time_limit``
        and :func:`~tike_tpu_torch.opt.is_converged` held between chunks.
        With ``use_position_regularization`` the chunks are one epoch long
        and the affine position model is fitted and applied after each;
        otherwise it is fitted once at the end. Each fit draws from a
        generator seeded with ``1000 + epochs done``, as in the JAX
        package."""
        algo = self.parameters.algorithm_options
        popt = self.parameters.position_options
        regularize = popt is not None and popt.use_position_regularization
        window = algo.convergence_window
        chunk = num_iter if window < 2 else max(1, window // 2)
        if regularize:
            chunk = 1
        state = self._striped
        done = 0
        while done < num_iter:
            if np.sum(algo.times) > algo.time_limit:
                logger.info("Maximum reconstruction time exceeded.")
                break
            step = min(chunk, num_iter - done)
            start = time.perf_counter()
            costs = striped.striped_iterate(state, step)
            if regularize:
                scan_g, popt = affine_position_regularization(
                    striped.striped_scan_global(state),
                    popt,
                    rng=np.random.default_rng(1000 + state.epochs_done),
                )
                self.parameters.position_options = popt
                striped.striped_set_scan(state, scan_g)
            elapsed = time.perf_counter() - start
            popts = self.parameters.probe_options
            for e, cost in enumerate(costs):
                algo.costs.append([cost])
                algo.times.append(elapsed / step)
                if popts is not None:
                    popts.power.append(state.last_powers[e])
            logger.info("striped cost is %+1.3e", costs[-1])
            done += step
            if is_converged(algo):
                break
        if popt is not None and not regularize:
            _, popt = affine_position_regularization(
                striped.striped_scan_global(state),
                popt,
                rng=np.random.default_rng(1000 + state.epochs_done),
            )
            self.parameters.position_options = popt

    def _fused_eligible(self) -> bool:
        """Whether :meth:`iterate` can enqueue all its epochs at once."""
        return not _per_epoch_reasons(self.parameters, not self.store_data_on_device)

    def _make_plan(self, per_epoch: bool = False) -> EpochPlan:
        """The static configuration of an epoch. On the per-epoch path, as
        in the JAX package, the preconditioners of one object slice always
        take the FFT formulation (several slices take the gather one on
        either path), rPIE leaves the positions alone, and eigen probes are
        constrained on probe-recovery epochs."""
        p = self.parameters
        popts = p.probe_options
        oopts = p.object_options
        algo = p.algorithm_options
        return EpochPlan(
            **plan_fields(
                self.operator, p, "rpie" if algo.name == "rpie" else "lstsq", popts is not None
            ),
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
            fft_precond=self.operator.nslices == 1
            and (
                per_epoch
                or _preconditioner.fft_precond_profitable(
                    n_positions=p.scan.shape[0],
                    probe_shape=self.operator.probe_shape,
                    nz=self.operator.nz,
                    n=self.operator.n,
                )
            ),
            constrain_eigen=per_epoch and p.eigen_probe is not None,
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

    def _epoch_state(self, plan: EpochPlan) -> EpochState:
        """The solver state an epoch starts from: the fields, and the
        moment states kept in the options by earlier epochs."""
        p = self.parameters
        popt = p.position_options
        state = EpochState(
            psi=p.psi,
            probe=p.probe,
            scan=p.scan,
            eigen_probe=p.eigen_probe,
            eigen_weights=p.eigen_weights,
        )
        if plan.recover_positions and popt.use_adaptive_moment:
            if popt._momentum is None:
                state.pos_v = torch.zeros_like(p.scan)
                state.pos_m = torch.zeros_like(p.scan)
            else:
                state.pos_v = popt._momentum[..., 0:2]
                state.pos_m = popt._momentum[..., 2:4]
        self._moment_states(plan, state)
        return state

    def _keep_fields(self, state: EpochState) -> None:
        p = self.parameters
        p.psi, p.probe, p.scan = state.psi, state.probe, state.scan
        p.eigen_probe = state.eigen_probe
        p.eigen_weights = state.eigen_weights

    def _keep_moments(self, plan: EpochPlan, state: EpochState) -> None:
        """Put the moment states back into the options, for the next call."""
        p = self.parameters
        if plan.recover_positions and p.position_options.use_adaptive_moment:
            p.position_options._momentum = torch.cat(
                [state.pos_v, state.pos_m], dim=-1
            )
        if plan.obj_moment != "none":
            p.object_options.m = state.obj_m
            if plan.obj_moment != "momentum":
                p.object_options.v = state.obj_v
        if plan.probe_moment != "none":
            p.probe_options.v = state.probe_v
            p.probe_options.m = state.probe_m

    def _epoch_order(self, plan: EpochPlan):
        """The next epoch's batch order: 0..nb-1 for compact batches, else
        a permutation drawn from the reconstruction's generator."""
        nb = self._batch_idx.shape[0]
        return range(nb) if plan.compact else self._rng.permutation(nb).tolist()

    def iterate(self, num_iter: int) -> None:
        """Advance the reconstruction by ``num_iter`` epochs.

        Compact batching runs the batches in order; the other batch
        methods in a permutation per epoch from the reconstruction's
        generator. As in the JAX package there are two paths. Where nothing
        needs the host between epochs (:meth:`_fused_eligible`), all epochs
        are enqueued and read back once (:meth:`_iterate_fused`); with
        ``convergence_window >= 2`` in chunks of ``window // 2`` epochs,
        with :func:`~tike_tpu_torch.opt.is_converged` between them. A
        finite ``time_limit``, ``use_position_regularization``, position
        options with rPIE and host-streamed data take the per-epoch loop
        (:meth:`_iterate_per_epoch`). The call is a ``tike.iterate`` span
        (:mod:`tike_tpu_torch.trace`).
        """
        with trace.span("tike.iterate"):
            self._iterate(num_iter)

    def _iterate(self, num_iter: int) -> None:
        if self.object_sharding == "striped":
            return self._iterate_striped(num_iter)
        if num_iter < 1:
            return
        algo = self.parameters.algorithm_options
        if not self._fused_eligible():
            return self._iterate_per_epoch(num_iter)
        window = algo.convergence_window
        if window < 2:
            return self._iterate_fused(num_iter)
        # Early stopping reads the cost history on the host.
        chunk = max(1, window // 2)
        done = 0
        while done < num_iter:
            step = min(chunk, num_iter - done)
            self._iterate_fused(step)
            done += step
            if is_converged(algo):
                return

    def _iterate_fused(self, num_iter: int) -> None:
        """Run ``num_iter`` epochs without reading from the device between
        them: the batch orders are all drawn when the call starts, as the
        JAX package's fused path draws them; the per-epoch costs and probe
        powers stay on the device until all epochs have run, then come to
        the host in one transfer, and each epoch is recorded with the mean
        wall time of the call. Moment states are kept in the object, probe
        and position options between calls. With position correction the
        global affine transform is fitted once afterwards.
        """
        p = self.parameters
        algo = p.algorithm_options
        popt = p.position_options
        plan = self._make_plan()
        epoch0 = len(algo.times)
        orders = [self._epoch_order(plan) for _ in range(num_iter)]
        state = self._epoch_state(plan)
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
            self._keep_fields(state)
        self._keep_moments(plan, state)
        with trace.host_read("ptycho.costs"):
            costs_host = to_numpy(torch.stack(costs))  # waits for the device
        with trace.host_read("ptycho.powers"):
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

    def _iterate_per_epoch(self, num_iter: int) -> None:
        """The per-epoch loop of the JAX package's ``iterate``: before each
        epoch the ``time_limit`` is held against the recorded times and the
        batch order is drawn; after it the epoch's cost (and, on epochs
        that recover the probe, its power) is read to the host, the affine
        position model is fitted (and applied with
        ``use_position_regularization``), the epoch's own wall time is
        recorded and :func:`~tike_tpu_torch.opt.is_converged` is asked.
        Host-streamed data runs here, each batch copied in while the one
        before computes. rPIE leaves the positions alone."""
        p = self.parameters
        algo = p.algorithm_options
        plan = self._make_plan(per_epoch=True)
        start = time.perf_counter()
        for _ in range(num_iter):
            if np.sum(algo.times) > algo.time_limit:
                logger.info("Maximum reconstruction time exceeded.")
                break
            total_e = len(algo.times)
            logger.info("%s epoch %d", algo.name, total_e)
            order = self._epoch_order(plan)
            state = self._epoch_state(plan)
            cost, pwr = _epoch_math(
                plan,
                self.data,
                self._batch_idx,
                self._batch_mask,
                self._batch_real,
                order,
                state,
                p.exitwave_options,
                total_e,
            )
            self._keep_fields(state)
            self._keep_moments(plan, state)
            with trace.host_read("ptycho.costs"):
                algo.costs.append([float(cost)])  # waits for the device
            if plan.recover_probe and plan.recover_now(total_e):
                with trace.host_read("ptycho.powers"):
                    p.probe_options.power.append(to_numpy(pwr))
            if p.position_options is not None:
                p.scan, p.position_options = affine_position_regularization(
                    p.scan, p.position_options, rng=self._fit_rng
                )
            algo.times.append(time.perf_counter() - start)
            start = time.perf_counter()
            logger.info(
                "%10s cost is %+1.3e", p.exitwave_options.noise_model, algo.costs[-1][0]
            )
            if is_converged(algo):
                break

    def get_scan(self) -> np.ndarray:
        """Return the current scan positions in the user's order."""
        return to_numpy(self.parameters.scan)[np.argsort(self.order)]

    def get_result(self) -> PtychoParameters:
        """Return the current parameter estimates as host copies, with the
        per-position arrays (scan, eigen weights, position options) in the
        user's order."""
        if self.object_sharding == "striped":
            res = striped.striped_full_result(self._striped)
            result = self.parameters
            result.psi, result.probe, result.scan = res["psi"], res["probe"], res["scan"]
            if result.eigen_probe is not None:
                result.eigen_probe = res["eigen_probe"]
            if result.eigen_weights is not None:
                result.eigen_weights = res["eigen_weights"]
            popt = result.position_options
            if popt is not None and "position_momentum" in res:
                popt._momentum = res["position_momentum"]
            return result
        return PtychoParameters.join(
            [self.parameters.copy_to_host()],
            np.argsort(self.order),
            stripe_start=self.stripe_start,
        )

    def get_psi(self) -> np.ndarray:
        """Return the current object as a numpy array."""
        if self.object_sharding == "striped":
            return striped.striped_result(self._striped)[0]
        return to_numpy(self.parameters.psi)

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

    def append_new_data(self, new_data, new_scan):
        """Append new diffraction patterns and positions mid-reconstruction.

        Online (streaming-acquisition) reconstruction, as
        :meth:`tike_tpu.ptycho.Reconstruction.append_new_data`: the new
        patterns are checked, data and positions appended, the mini-batches
        clustered again (from the reconstruction's own generator), eigen
        weights padded with their column means, and the position-correction
        state (initial positions, confidence, moments) extended. The solver
        state (object, probe, eigen probes, moments, cost and time
        histories) carries over, and ``init_rescale_from_measurements`` is
        turned off so the refined probe is not rescaled again. Data that
        was given on the device cannot be appended to:
        ``NotImplementedError``; restart with the combined dataset.
        """
        if self._is_multi_host() or (
            self.object_sharding == "striped" and self._spans_processes()
        ):
            raise NotImplementedError(
                "append_new_data supports one process; a multi-process run must "
                "restart with the combined dataset"
            )
        if isinstance(self.data_host, torch.Tensor) and self.data_host.device.type != "cpu":
            raise NotImplementedError(
                "append_new_data requires host data (numpy or a CPU tensor); "
                "data given on the device cannot be appended to. Restart "
                "with the combined dataset instead."
            )
        new_scan = np.asarray(to_numpy(new_scan), dtype=np.float32)
        new_data = (
            new_data.detach().cpu()
            if isinstance(new_data, torch.Tensor)
            else np.asarray(new_data)
        )
        if (
            new_data.ndim != 3
            or new_scan.ndim != 2
            or new_scan.shape[-1] != 2
            or new_data.shape[0] != new_scan.shape[0]
        ):
            raise ValueError(
                f"new data shape {tuple(new_data.shape)} and new scan shape "
                f"{new_scan.shape} are incompatible. They should be "
                "(K, W, H) and (K, 2) with the same leading dimension."
            )
        if tuple(new_data.shape[-2:]) != tuple(self.data_host.shape[-2:]):
            raise ValueError(
                f"new data frames {tuple(new_data.shape[-2:])} do not match the "
                f"existing detector shape {tuple(self.data_host.shape[-2:])}."
            )
        check = to_numpy(new_data)
        if not np.all(np.isfinite(check)) or np.any(check < 0):
            warnings.warn(
                "New diffraction patterns contain invalid data. "
                "All data should be non-negative and finite.",
                UserWarning,
            )

        # The current state in the user's order, then extended.
        params = self.get_result()
        check_allowed_positions(new_scan, params.psi, params.probe.shape)
        n_new = new_scan.shape[0]
        params.scan = np.concatenate([params.scan, new_scan], axis=0)
        if params.eigen_weights is not None:
            params.eigen_weights = np.pad(
                params.eigen_weights, ((0, n_new), (0, 0), (0, 0)), mode="mean"
            )
        popt = params.position_options
        if popt is not None:
            popt.initial_scan = np.concatenate([popt.initial_scan, new_scan], axis=0)
            if popt.confidence is not None:
                popt.confidence = np.concatenate(
                    [popt.confidence, np.ones((n_new, 2), dtype=np.float32)], axis=0
                )
            if popt._momentum is not None:
                popt._momentum = np.pad(popt._momentum, ((0, n_new), (0, 0)))
        if params.probe_options is not None:
            params.probe_options.init_rescale_from_measurements = False

        if isinstance(self.data_host, torch.Tensor):
            self.data_host = torch.cat(
                [self.data_host, torch.as_tensor(new_data, dtype=self.data_host.dtype)]
            )
        else:
            self.data_host = np.concatenate([self.data_host, to_numpy(new_data)], axis=0)
        self.parameters_host = params
        return self.__enter__()


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


def reconstruct_multigrid(
    data,
    parameters: PtychoParameters,
    num_gpu: typing.Union[int, typing.Tuple[int, ...]] = 1,
    use_mpi: bool = False,
    num_levels: int = 3,
    interp: typing.Callable = None,
    mesh=None,
    object_sharding: str = "replicated",
    store_data_on_device: typing.Optional[bool] = None,
    *,
    device="cuda",
    random_seed: typing.Optional[int] = None,
) -> PtychoParameters:
    """Coarse-to-fine reconstruction on ``device``, as
    :func:`tike_tpu.ptycho.reconstruct_multigrid`.

    Level ``num_levels - 1`` first: the parameters resampled by ``0.5 **
    level`` (``interp``, default :func:`~.solvers.options._resize_fft`, for
    the probes) and the data cropped to its lowest ``1 / 2 ** level`` of
    frequencies (:func:`~.solvers.options.crop_fourier_space`: plain
    indexing, so data on the device stays there), then
    ``algorithm_options.num_iter`` epochs, and the result resampled by 2
    for the next level. Returns the finest level's result. The parameters
    before ``device`` are the JAX package's, in its order; ``mesh`` (also
    one across processes, each level in the multi-process layout) runs
    every level on it, and what :class:`Reconstruction` refuses raises
    ``NotImplementedError`` before any level runs. ``random_seed`` seeds
    every level's batches (the JAX package leaves them unseeded).
    """
    missing = _unsupported(parameters, object_sharding)
    if missing:
        raise NotImplementedError("not ported to tike_tpu_torch yet: " + "; ".join(missing))
    _check_single_slice_lstsq(parameters)
    _check_striped_mesh(object_sharding, mesh)
    if mesh is not None:
        home_device(mesh, device)
    interp = _resize_fft if interp is None else interp
    if (data.shape[-1] * 0.5 ** (num_levels - 1)) < 64:
        warnings.warn(
            "Cropping diffraction patterns to less than 64 pixels wide is "
            "not recommended because the full doughnut may be visible."
        )
    resampled_parameters = parameters.resample(0.5 ** (num_levels - 1), interp)
    for level in range(num_levels - 1, -1, -1):
        with Reconstruction(
            data
            if level == 0
            else crop_fourier_space(data, data.shape[-1] // (2**level)),
            resampled_parameters,
            num_gpu,
            use_mpi,
            mesh,
            store_data_on_device,
            random_seed,
            object_sharding,
            device=device,
        ) as context:
            context.iterate(resampled_parameters.algorithm_options.num_iter)
            result = context.get_result()
        if level == 0:
            return result
        resampled_parameters = result.resample(2.0, interp)
    raise RuntimeError("This should not happen.")


def _rescale_probe(
    cfg: PtychoConfig,
    data,
    batch_idx,
    batch_mask,
    parameters: PtychoParameters,
) -> PtychoParameters:
    """Rescale the probe so modeled and measured total intensity match.

    ``data`` is batch-major (num_batch, L, DET, DET), resident or streamed
    from the host batch by batch, or split over a mesh's shards
    (:class:`~.solvers.epoch.ShardedBatches`), each of which sums its own
    slots before the shards' sums are added; padded slots (mask 0) are not
    counted. Sets ``probe_photons`` from the rescaled probe when it is
    unset.
    """
    if isinstance(data, ShardedBatches):
        shards = zip(data.devices, data.data, data.idx, data.mask)
        group = data.group
    else:
        group = [parameters.psi.device]
        shards = [(group[0], data, batch_idx, batch_mask)]
    parts = []
    for device, data_s, idx_s, mask_s in shards:
        w = parameters.exitwave_options.measured_pixels.to(device, torch.float32)
        psi, scan, probe = (parameters.psi.to(device), parameters.scan.to(device),
                            parameters.probe.to(device))
        s_data = torch.zeros((), device=device)
        s_model = torch.zeros((), device=device)
        for n, data_b in iter_batches(data_s, range(idx_s.shape[0])):
            idx, bmask = idx_s[n], mask_s[n]
            intensity = intensity_from_farplane(
                ptycho_fwd(cfg, psi, scan[idx], probe[:, 0])
            )
            s_data = s_data + torch.sum(torch.sum(data_b * w, dim=(-2, -1)) * bmask)
            s_model = s_model + torch.sum(
                torch.sum(intensity * w, dim=(-2, -1)) * bmask
            )
        parts.append((s_data, s_model))
    s_data, s_model = (x.to(parameters.psi.device) for x in all_reduce(parts, group)[0])
    rescale = torch.sqrt(s_data / (s_model + 1e-32))
    logger.info("Probe rescaled by %f", float(rescale))
    parameters.probe = parameters.probe * rescale
    popts = parameters.probe_options
    if np.isnan(popts.probe_photons):
        popts.probe_photons = float(
            torch.sum(torch.square(torch.abs(parameters.probe)))
        )
    return parameters
