"""The mesh, the placements and the collectives of :mod:`tike_tpu_torch.parallel`."""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

__all__ = [
    "BATCH_AXIS",
    "Gather",
    "Mesh",
    "Sharding",
    "Sum",
    "all_gather",
    "all_reduce",
    "batch_sharding",
    "broadcast",
    "fetch_global",
    "home_device",
    "make_mesh",
    "put",
    "put_process_local",
    "put_replicated_global",
    "replicated_sharding",
    "run_local",
    "run_shards",
]

BATCH_AXIS = "batch"


def _device(d) -> torch.device:
    """``d`` as a torch.device; a CUDA device gets the current index, so
    that shards on one card compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """Devices in a 1-D or 2-D array, one a shard, with a name for each
    axis; a device may appear more than once.

    ``devices`` is the object array of ``torch.device`` s, ``shape`` maps
    each axis name to its length (as ``jax.sharding.Mesh.shape`` does),
    ``size`` is the number of shards and :attr:`flat` lists their devices
    in mesh order (row-major).
    """

    def __init__(self, devices, axis_names=(BATCH_AXIS,)):
        array = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if array.ndim != len(axis_names) or array.ndim not in (1, 2) or array.size < 1:
            raise ValueError(
                f"a mesh is a 1-D or 2-D array of devices with a name an axis; got "
                f"shape {array.shape} and names {axis_names}"
            )
        self.devices = np.empty(array.shape, dtype=object)
        for i, d in np.ndenumerate(array):
            self.devices[i] = _device(d)
        self.axis_names = axis_names

    @property
    def shape(self) -> typing.Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat(self) -> typing.List[torch.device]:
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({self.devices.tolist()}, {self.axis_names})"


def home_device(mesh, device) -> torch.device:
    """The device that holds a mesh run's whole tensors (the state, the
    data, the results): the first shard's. ``device``, an entry point's
    argument, must name its type (``"cpu"`` for a mesh of CPU shards)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a tike_tpu_torch.parallel.Mesh (make_mesh), not {type(mesh)}"
        )
    home = mesh.flat[0]
    if device is None or torch.device(device).type != home.type:
        raise ValueError(
            f"the mesh's devices are {home.type} devices but device is {device!r}; "
            f"pass device={home.type!r}"
        )
    return home


def make_mesh(n_devices: typing.Optional[int] = None, devices=None) -> Mesh:
    """A 1-D mesh over the pattern (data-parallel) axis :data:`BATCH_AXIS`:
    ``devices`` (which may repeat a device; ``n_devices`` is then not read),
    or else the visible CUDA devices, the first ``n_devices`` of them where
    given (all of them where fewer are visible), as
    :func:`tike_tpu.parallel.make_mesh` takes ``jax.devices()[:n]``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() without devices needs CUDA devices, and "
                "torch.cuda.is_available() is false; pass devices=, such as "
                "['cpu'] * 4"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(list(devices), (BATCH_AXIS,))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor lies on a mesh: split along tensor axis ``axis`` into
    equal parts in mesh order, or replicated on every shard (``axis`` None)."""

    mesh: Mesh
    axis: typing.Optional[int] = None


def replicated_sharding(mesh: Mesh) -> Sharding:
    """Placement of replicated tensors (psi, probe, solver state)."""
    return Sharding(mesh, None)


def batch_sharding(mesh: Mesh, axis: int = 0) -> Sharding:
    """Placement that splits tensor axis ``axis`` over the mesh."""
    return Sharding(mesh, axis)


def _multi_process_check(what: str) -> None:
    dist = getattr(torch, "distributed", None)
    if (
        dist is not None
        and dist.is_available()
        and dist.is_initialized()
        and dist.get_world_size() > 1
    ):
        raise NotImplementedError(
            f"{what} across {dist.get_world_size()} processes needs the multi-process "
            "layout (tike_tpu.parallel.distributed), which is not ported yet"
        )


def _split(x: torch.Tensor, parts: int, axis: int) -> typing.List[torch.Tensor]:
    length = x.shape[axis]
    if length % parts:
        raise ValueError(
            f"axis {axis} of length {length} does not split into {parts} equal shards"
        )
    return list(torch.split(x, length // parts, dim=axis))


def broadcast(x: torch.Tensor, devices) -> typing.List[torch.Tensor]:
    """``x`` on each of ``devices``: the tensor itself where it lies there
    already, a copy elsewhere."""
    return [x.to(d) for d in devices]


def put(x, sharding: Sharding) -> typing.List[torch.Tensor]:
    """The per-shard tensors of ``x`` (a tensor or an array) under
    ``sharding``, each on its shard's device."""
    x = torch.as_tensor(x)
    devices = sharding.mesh.flat
    if sharding.axis is None:
        return broadcast(x, devices)
    return [p.to(d) for p, d in zip(_split(x, len(devices), sharding.axis), devices)]


def put_process_local(local_block, sharding: Sharding, global_rows: int):
    """Place this process's leading-axis block of a sharded tensor; in one
    process the block is the whole tensor, split as ``sharding`` says."""
    _multi_process_check("put_process_local")
    local = torch.as_tensor(local_block)
    if local.shape[0] != global_rows:
        raise ValueError(
            f"in one process the block holds all {global_rows} rows; got {local.shape[0]}"
        )
    return put(local, sharding)


def put_replicated_global(host, sharding: Sharding):
    """Place an identical full tensor as ``sharding`` says (split or
    replicated)."""
    _multi_process_check("put_replicated_global")
    return put(host, sharding)


def fetch_global(x, axis: int = 0) -> np.ndarray:
    """A host copy of ``x``: a tensor, or the per-shard tensors of a tensor
    split along ``axis``, joined in mesh order."""
    _multi_process_check("fetch_global")
    if isinstance(x, (list, tuple)):
        x = torch.cat([p.to(x[0].device) for p in x], dim=axis)
    return x.detach().cpu().numpy()


def _per_leaf(fn, values: list) -> list:
    """Apply ``fn`` (a list of per-shard tensors -> a list of per-shard
    results) to each leaf of the shards' values, which are tensors, None or
    tuples or lists of them, all of one structure; return the per-shard
    results in that structure."""
    first = values[0]
    if first is None:
        return [None] * len(values)
    if isinstance(first, (tuple, list)):
        leaves = [_per_leaf(fn, [v[i] for v in values]) for i in range(len(first))]
        return [type(first)(leaf[s] for leaf in leaves) for s in range(len(values))]
    return fn(list(values))


def all_reduce(parts: list, devices) -> list:
    """The sum of the shards' partial tensors (or tuples of them), added in
    mesh order on the first shard's device and copied to each shard's
    device (``devices``, in mesh order). With one shard, its part itself."""
    devices = list(devices)

    def reduce(leaf):
        total = leaf[0].to(devices[0])
        for p in leaf[1:]:
            total = total + p.to(devices[0])
        return broadcast(total, devices)

    return _per_leaf(reduce, parts)


def all_gather(parts: list, devices, dim: int = 0) -> list:
    """The shards' tensors (or tuples of them) joined along ``dim`` in mesh
    order on the first shard's device, and copied to each shard's device
    (``devices``, in mesh order)."""
    devices = list(devices)

    def gather(leaf):
        return broadcast(torch.cat([p.to(devices[0]) for p in leaf], dim=dim), devices)

    return _per_leaf(gather, parts)


class Sum(typing.NamedTuple):
    """A shard's partial sum (a tensor, None, or a tuple of them), yielded
    to receive the sum over all shards (:func:`all_reduce`)."""

    value: typing.Any


class Gather(typing.NamedTuple):
    """A shard's part along ``dim``, yielded to receive all shards' parts
    joined in mesh order (:func:`all_gather`)."""

    value: typing.Any
    dim: int = 0


def run_local(steps: typing.Generator):
    """Drive one shard's generator on its own: each :class:`Sum` and
    :class:`Gather` receives its own value back. Returns what the
    generator returns."""
    try:
        request = next(steps)
        while True:
            request = steps.send(request.value)
    except StopIteration as stop:
        return stop.value


def run_shards(devices, steps: typing.Sequence[typing.Generator]) -> list:
    """Drive one generator a shard (on ``devices``, in mesh order) in
    lockstep: each runs to its next request, then the requests, all of one
    kind, are answered together (:func:`all_reduce` or :func:`all_gather`)
    and each generator goes on with its shard's answer. Returns what each
    generator returns. With one shard, the same as :func:`run_local`."""
    devices = list(devices)
    if len(steps) == 1:
        return [run_local(steps[0])]
    answers = [None] * len(steps)
    first = True
    while True:
        requests, done = [], []
        for g, answer in zip(steps, answers):
            try:
                requests.append(next(g) if first else g.send(answer))
            except StopIteration as stop:
                done.append(stop.value)
        first = False
        if done:
            if len(done) != len(steps):
                raise RuntimeError("the shards' steps ended after different numbers of requests")
            return done
        kinds = {type(r) for r in requests}
        if len(kinds) != 1:
            raise RuntimeError(f"the shards made different requests: {sorted(k.__name__ for k in kinds)}")
        values = [r.value for r in requests]
        if isinstance(requests[0], Sum):
            answers = all_reduce(values, devices)
        else:
            answers = all_gather(values, devices, requests[0].dim)
