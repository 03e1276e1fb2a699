"""Several processes: the original tike's MPI axis over ``torch.distributed``.

Counterpart of :mod:`tike_tpu.parallel.distributed`. Each process of a
``torch.distributed`` group contributes its devices to one global mesh, in
process-major order (:func:`global_mesh`); a shard of another process is a
:class:`~tike_tpu_torch.parallel.Remote` there. A process builds and runs
its own shards alone, and the mesh's collectives (``parallel.run_shards``,
``all_reduce``, ``all_gather``) fetch the other processes' parts through
``torch.distributed`` and add them in mesh order, so every process computes
the same bits, and the bits of one process that holds every shard (the
``Reconstruction(..., _force_stripes=k)`` emulation on a mesh of the same
size). Each process loads only its stripe of the diffraction patterns:

    import tike_tpu_torch.parallel.distributed as dist
    dist.initialize()                          # torchrun's environment
    local = dist.stripe_for_process(scan)      # this process's pattern rows
    data_local = load_my_patterns(local)
    result = tike_tpu_torch.ptycho.reconstruct(
        data_local, parameters, mesh=dist.global_mesh())  # same on every rank

The full scan is small and every process holds it; the batch layout is
computed from it the same way everywhere (seed 0 where no seed is given),
and the data is never gathered.
"""

from __future__ import annotations

import logging
import os
import typing

import numpy as np
import torch

from ..ptycho.stream import StreamedBatches, pinned_batches
from ._mesh import (
    BATCH_AXIS,
    Mesh,
    Remote,
    _group,
    batch_sharding,
    gather_objects,
    process_count,
    process_index,
    put_process_local,
)

__all__ = [
    "HostStreamedBatches",
    "dcn_mesh",
    "default_backend",
    "gather_objects",
    "global_mesh",
    "initialize",
    "make_global_batch_data",
    "process_count",
    "process_index",
    "split_for_process",
    "stripe_for_process",
    "stripe_indices",
    "striped_batches",
]

logger = logging.getLogger(__name__)

_TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def default_backend() -> str:
    """``"nccl"`` where CUDA is available (one rank a card), else ``"gloo"``."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(
    coordinator_address: typing.Optional[str] = None,
    num_processes: typing.Optional[int] = None,
    process_id: typing.Optional[int] = None,
    **kwargs,
) -> None:
    """Join the process group, as :func:`tike_tpu.parallel.distributed.initialize`
    joins ``jax.distributed``: ``torch.distributed.init_process_group`` with
    ``init_method=f"tcp://{coordinator_address}"``, ``world_size`` and
    ``rank``. Without arguments it reads torchrun's environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), and where
    that is absent the process stays on its own and logs so. A no-op where
    a group is initialized already. ``backend`` (a keyword) chooses the
    backend, by default ``"nccl"`` where CUDA is available and ``"gloo"``
    on the CPU; the other keywords go to ``init_process_group`` (such as
    ``init_method`` in place of an address, and ``timeout``).
    """
    dist = torch.distributed
    if _group() is not None:
        return
    backend = kwargs.pop("backend", None) or default_backend()
    if coordinator_address is None and num_processes is None and "init_method" not in kwargs:
        if not all(k in os.environ for k in _TORCHRUN):
            logger.info(
                "single-process mode: no process group and none of torchrun's "
                "environment (%s)", ", ".join(_TORCHRUN)
            )
            return
        dist.init_process_group(backend=backend, **kwargs)
        _bind_card(backend)
        return
    if coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend=backend, world_size=num_processes, rank=process_id, **kwargs
    )
    _bind_card(backend)


def _bind_card(backend: str) -> None:
    """NCCL sends from the current card: make it this rank's
    (``LOCAL_RANK``)."""
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))


def _local_devices(local_devices) -> typing.List[torch.device]:
    if local_devices is not None:
        return [torch.device(d) for d in local_devices]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "global_mesh() without local_devices needs a CUDA device, and "
            "torch.cuda.is_available() is false; pass local_devices=, such as "
            "['cpu', 'cpu']"
        )
    return [torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))]


def _process_devices(local_devices) -> typing.List[list]:
    """Every process's devices, in rank order: this process's as
    ``torch.device`` s, the others' as :class:`Remote` s. Unequal counts
    raise, as the JAX package's layout needs equal ones."""
    mine = _local_devices(local_devices)
    rank = process_index()
    names = gather_objects([str(d) for d in mine])
    counts = [len(n) for n in names]
    if len(set(counts)) != 1:
        raise ValueError(
            f"every process must contribute the same number of devices; they give {counts}"
        )
    return [
        mine if r == rank else [Remote(r, name) for name in devs]
        for r, devs in enumerate(names)
    ]


def global_mesh(axis_name: str = BATCH_AXIS, local_devices=None) -> Mesh:
    """A 1-D mesh over every device of every process, process-major, so
    that a batch axis split over it gives each process a contiguous block
    of slots (what :func:`striped_batches` lays out). Each process
    contributes ``local_devices`` (such as ``["cpu", "cpu"]``), by default
    the card of its ``LOCAL_RANK`` (one rank a card). Every process must
    call it."""
    per_process = _process_devices(local_devices)
    return Mesh([d for devs in per_process for d in devs], (axis_name,))


def dcn_mesh(
    ici_axis: str = "ici", dcn_axis: str = "dcn", local_devices=None
) -> Mesh:
    """A 2-D (process, local device) mesh, ``(dcn_axis, ici_axis)``, for
    mixed splits: each row is one process's devices."""
    per_process = _process_devices(local_devices)
    array = np.empty((len(per_process), len(per_process[0])), dtype=object)
    for r, devs in enumerate(per_process):
        for i, d in enumerate(devs):
            array[r, i] = d
    return Mesh(array, (dcn_axis, ici_axis))


def stripe_indices(
    scan: np.ndarray, num_processes: typing.Optional[int] = None
) -> typing.List[np.ndarray]:
    """The pattern rows of each process: stripes of equal counts along the
    scan's row coordinate (``cluster.stripes_equal_count``), as the JAX
    package cuts them (the original tike's ``MPIio_ptycho`` cuts at equal
    coordinates instead)."""
    from ..cluster import stripes_equal_count

    if num_processes is None:
        num_processes = process_count()
    return stripes_equal_count(np.asarray(scan), num_processes, dim=0)


def stripe_for_process(
    scan: np.ndarray,
    *args: np.ndarray,
    num_processes: typing.Optional[int] = None,
    process_id: typing.Optional[int] = None,
):
    """This process's pattern row indices; with extra arrays
    ``(indices, arg0[indices], ...)``, as the original ``MPIio_ptycho(scan,
    data)``."""
    if process_id is None:
        process_id = process_index()
    idx = stripe_indices(scan, num_processes)[process_id]
    if not args:
        return idx
    return (idx, *(np.asarray(a)[idx] for a in args))


def split_for_process(
    *args: np.ndarray,
    axis: int = 0,
    num_processes: typing.Optional[int] = None,
    process_id: typing.Optional[int] = None,
):
    """This process's contiguous part of each array along ``axis``
    (``np.array_split``; the original ``MPIio_lamino``)."""
    if num_processes is None:
        num_processes = process_count()
    if process_id is None:
        process_id = process_index()
    out = tuple(
        np.array_split(np.asarray(a), num_processes, axis=axis)[process_id]
        for a in args
    )
    return out[0] if len(out) == 1 else out


def striped_batches(
    scan: np.ndarray,
    num_processes: int,
    batch_method: str,
    num_batch: int,
    rng: np.random.Generator,
    local_multiple: int,
):
    """The global stripe-major batch layout of several processes, as
    :func:`tike_tpu.parallel.distributed.striped_batches` lays it out.

    Every process calls it with the full scan and an identically seeded
    ``rng`` and gets the same layout:

    - ``global_order`` (N,): the pattern indices, stripe after stripe, each
      stripe in clustered order;
    - ``batch_idx`` (nb, P Lp) int32 and ``batch_mask``: batch n's slots,
      [stripe 0's | stripe 1's | ...], each stripe padded to the same
      ``Lp`` (a multiple of ``local_multiple``), so that splitting the
      slots over a process-major mesh puts each pattern on its process;
    - ``stripe_slots``: per stripe, its padded (nb, Lp) local rows and mask;
    - ``stripe_start``: each stripe's least row coordinate.
    """
    from ..cluster import batches_padded, by_scan_stripes_contiguous

    order, batches, stripe_start = by_scan_stripes_contiguous(
        scan=np.asarray(scan),
        num_stripes=num_processes,
        batch_method=batch_method,
        num_batch=num_batch,
        rng=rng,
    )
    padded = [batches_padded(b, multiple_of=local_multiple) for b in batches]
    Lp = max(idx.shape[1] for idx, _ in padded)
    Lp = -(-Lp // local_multiple) * local_multiple
    nb = len(batches[0])

    def repad(idx, mask):
        if idx.shape[1] == Lp:
            return idx, mask
        idx2 = np.concatenate(
            [idx, np.repeat(idx[:, :1], Lp - idx.shape[1], axis=1)], axis=1
        )
        mask2 = np.concatenate(
            [mask, np.zeros((nb, Lp - mask.shape[1]), np.float32)], axis=1
        )
        return idx2, mask2

    padded = [repad(idx, mask) for idx, mask in padded]
    offsets = np.cumsum([0] + [len(o) for o in order])[:-1]
    batch_idx = np.concatenate(
        [idx + off for (idx, _), off in zip(padded, offsets)], axis=1
    ).astype(np.int32)
    batch_mask = np.concatenate([m for _, m in padded], axis=1)
    global_order = np.concatenate(order)
    stripe_slots = [(idx, mask) for idx, mask in padded]
    return global_order, batch_idx, batch_mask, stripe_slots, stripe_start


def make_global_batch_data(
    mesh: Mesh, local_block, num_processes: int
) -> typing.List[torch.Tensor]:
    """This process's shards of the batch-major data (nb, P Lp, DET, DET):
    its block ``local_block`` (nb, Lp, DET, DET) split over its shards, on
    their devices (``parallel.put_process_local`` along the slots); nothing
    is gathered."""
    nb, Lp = local_block.shape[:2]
    if mesh.process_count != num_processes:
        raise ValueError(
            f"the mesh spans {mesh.process_count} processes, not {num_processes}"
        )
    return put_process_local(local_block, batch_sharding(mesh, axis=1), nb)


class HostStreamedBatches(StreamedBatches):
    """This process's block (nb, Lp, DET, DET) of the batch-major data in
    host memory (page-locked beside a card), streamed one batch at a time:
    the counterpart of :class:`tike_tpu.parallel.distributed.HostStreamedBatches`.

    ``ShardedBatches.split`` takes it as any host data and hands each of
    this process's shards its run of slots as a
    :class:`~tike_tpu_torch.ptycho.stream.StreamedBatches` of its own (two
    device buffers and a copy stream), so batch k+1 is copied in while
    batch k computes, as on one device. ``shape`` is the global (nb, P Lp,
    DET, DET); ``local`` (and ``host``) the block. ``data[n]`` is batch n
    on this process's shards, streamed in the same way.
    """

    def __init__(self, mesh: Mesh, local_block, num_processes: int):
        home = mesh.local_devices[0]
        host = torch.as_tensor(local_block)
        if home.type == "cuda" and not host.is_pinned():
            host = pinned_batches(
                host.reshape(-1, *host.shape[2:]),
                np.arange(host.shape[0] * host.shape[1]),
                tuple(host.shape[:2]),
                home,
            )
        super().__init__(host, home)
        self.mesh = mesh
        self.local = host
        nb, Lp = host.shape[:2]
        self.shape = (nb, num_processes * Lp, *host.shape[2:])

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, n) -> typing.List[torch.Tensor]:
        from ..ptycho.solvers.epoch import shard_runs

        runs = shard_runs(self.mesh, self, self.shape[1])
        return [next(run.batches([int(n)]))[1] for run in runs]
