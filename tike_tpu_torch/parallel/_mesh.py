"""The mesh, the placements and the collectives of :mod:`tike_tpu_torch.parallel`."""

from __future__ import annotations

import dataclasses
import time
import typing

import numpy as np
import torch

__all__ = [
    "BATCH_AXIS",
    "Gather",
    "Mesh",
    "Remote",
    "Sharding",
    "Sum",
    "all_gather",
    "all_reduce",
    "batch_sharding",
    "broadcast",
    "collective_stats",
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


@dataclasses.dataclass(frozen=True)
class Remote:
    """The device of a shard that another process of the process group
    owns: its rank, and the device's name there. This process never
    places a tensor on it; the collectives fetch the shard's part from its
    owner (:mod:`tike_tpu_torch.parallel.distributed`)."""

    rank: int
    device: str


def _is_local(d) -> bool:
    return not isinstance(d, Remote)


def _group():
    """``torch.distributed`` where a process group of it is initialized."""
    dist = getattr(torch, "distributed", None)
    if dist is not None and dist.is_available() and dist.is_initialized():
        return dist
    return None


def process_count() -> int:
    """The number of processes of the group; 1 without a group."""
    dist = _group()
    return 1 if dist is None else dist.get_world_size()


def process_index() -> int:
    """This process's rank; 0 without a group."""
    dist = _group()
    return 0 if dist is None else dist.get_rank()


def gather_objects(value) -> list:
    """Every process's ``value`` (a small picklable object), in rank order;
    ``[value]`` without a group. Every process must call it."""
    dist = _group()
    if dist is None:
        return [value]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def _device(d):
    """``d`` as a torch.device (a :class:`Remote` as it is); a CUDA device
    gets the current index, so that shards on one card compare equal."""
    if isinstance(d, Remote):
        return d
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
    in mesh order (row-major). A mesh across processes
    (:func:`tike_tpu_torch.parallel.distributed.global_mesh`) holds a
    :class:`Remote` for each shard of another process: :attr:`local` and
    :attr:`local_devices` name this process's shards, the only ones it
    runs.
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
        if not self.local:
            raise ValueError("a mesh needs at least one shard of this process")

    @property
    def shape(self) -> typing.Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat(self) -> list:
        return list(self.devices.reshape(-1))

    @property
    def local(self) -> typing.List[int]:
        """The flat indices of this process's shards, in mesh order."""
        return [k for k, d in enumerate(self.flat) if _is_local(d)]

    @property
    def local_devices(self) -> typing.List[torch.device]:
        """The devices of this process's shards, in mesh order."""
        return [d for d in self.flat if _is_local(d)]

    def is_local(self, k: int) -> bool:
        """Whether flat shard ``k`` is this process's."""
        return _is_local(self.flat[k])

    @property
    def process_count(self) -> int:
        """How many processes own shards of the mesh."""
        return 1 + len({d.rank for d in self.flat if not _is_local(d)})

    def __repr__(self) -> str:
        return f"Mesh({self.devices.tolist()}, {self.axis_names})"


def home_device(mesh, device) -> torch.device:
    """The device that holds a mesh run's whole tensors (the state, the
    data, the results): this process's first shard's. ``device``, an entry
    point's argument, must name its type (``"cpu"`` for a mesh of CPU
    shards)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a tike_tpu_torch.parallel.Mesh (make_mesh), not {type(mesh)}"
        )
    home = mesh.local_devices[0]
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
    """This process's per-shard tensors of ``x`` (a tensor or an array,
    whole) under ``sharding``, each on its shard's device, in mesh order."""
    x = torch.as_tensor(x)
    devices = sharding.mesh.flat
    if sharding.axis is None:
        return broadcast(x, sharding.mesh.local_devices)
    parts = _split(x, len(devices), sharding.axis)
    return [p.to(d) for p, d in zip(parts, devices) if _is_local(d)]


def put_process_local(local_block, sharding: Sharding, global_rows: int):
    """Place this process's block of a tensor whose leading axis has
    ``global_rows`` rows, as :func:`tike_tpu.parallel.put_process_local`
    does: the block holds this process's shards' run along the sharded
    axis (the whole tensor where the placement is replicated, or in one
    process), split over its shards."""
    local = torch.as_tensor(local_block)
    mesh = sharding.mesh
    ours = len(mesh.local)
    axis = sharding.axis
    if axis is None or ours == mesh.size:
        if local.shape[0] != global_rows:
            raise ValueError(
                f"the block must hold all {global_rows} rows; got {local.shape[0]}"
            )
        return put(local, sharding)
    whole = global_rows if axis == 0 else local.shape[axis] * mesh.size // ours
    if local.shape[axis] * mesh.size != whole * ours or (axis and local.shape[0] != global_rows):
        raise ValueError(
            f"this process's {ours} of {mesh.size} shards hold {whole * ours // mesh.size} "
            f"of {whole} rows along axis {axis}; the block has shape {tuple(local.shape)}"
        )
    return [p.to(d) for p, d in zip(_split(local, ours, axis), mesh.local_devices)]


def put_replicated_global(host, sharding: Sharding):
    """Place an identical full tensor, present in every process, as
    ``sharding`` says (split or replicated): each process keeps its own
    shards' parts."""
    return put(host, sharding)


def fetch_global(x, axis: int = 0, mesh: typing.Optional[Mesh] = None) -> np.ndarray:
    """A host copy of ``x``: a tensor, or the per-shard tensors of a tensor
    split along ``axis``, joined in mesh order. Where ``mesh`` spans
    several processes, ``x`` holds this process's shards and the others'
    are gathered from them (every process must call this)."""
    if isinstance(x, (list, tuple)):
        devices = mesh.flat if mesh is not None else [p.device for p in x]
        x = all_gather(list(x), devices, dim=axis)[0]
    return x.detach().cpu().numpy()


def _per_leaf(fn, values: list, count: int) -> list:
    """Apply ``fn`` (a list of per-shard tensors -> a list of ``count``
    per-shard results) to each leaf of the shards' values, which are
    tensors, None or tuples or lists of them, all of one structure; return
    the ``count`` per-shard results in that structure."""
    first = values[0]
    if first is None:
        return [None] * count
    if isinstance(first, (tuple, list)):
        leaves = [_per_leaf(fn, [v[i] for v in values], count) for i in range(len(first))]
        return [type(first)(leaf[s] for leaf in leaves) for s in range(count)]
    return fn(list(values))


class CollectiveStats:
    """What this process's collectives across processes cost since the
    last :meth:`reset`: how many exchanges, the bytes each brought in (the
    parts of every process), and their host seconds, which include staging
    copies and the wait for the other processes."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0

    def as_dict(self) -> dict:
        return {"calls": self.calls, "bytes": self.bytes, "ms": 1e3 * self.seconds}


collective_stats = CollectiveStats()


def _leaves(value) -> typing.List[torch.Tensor]:
    """The tensors of a value (a tensor, None, or tuples or lists of
    them), depth first."""
    if value is None:
        return []
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in _leaves(v)]
    return [value]


def _rebuild(template, tensors: typing.Iterator):
    """``template``'s structure with its tensors taken from ``tensors``."""
    if template is None:
        return None
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, tensors) for v in template)
    return next(tensors)


_ALIGN = 16  # bytes: every part starts where any dtype may be viewed


def _with_remote(parts: list, devices: list) -> list:
    """Every shard's part in the order of ``devices``: this process's
    ``parts`` (one per local device, in order) as they are, and each other
    process's fetched from it, on the first local device. Each part has
    the structure and shapes of this process's first, as every request of
    the port's steps does. In one process, ``parts`` itself."""
    local = [d for d in devices if _is_local(d)]
    if len(local) == len(devices):
        return list(parts)
    import torch.distributed as dist

    if len(parts) != len(local):
        raise ValueError(f"{len(parts)} parts for this process's {len(local)} shards")
    world, rank = dist.get_world_size(), dist.get_rank()
    counts = np.bincount(
        [d.rank if not _is_local(d) else rank for d in devices], minlength=world
    )
    if np.any(counts != len(local)):
        raise ValueError(
            "a collective across processes needs the same number of shards of "
            f"every process of the group; the shards' owners count {counts.tolist()}"
        )
    home = local[0]
    # gloo moves what it sends through host memory; stage there explicitly,
    # sent from and received into page-locked buffers beside a card. Its
    # all_gather takes CUDA tensors too (chip_smoke.py phase 23 checks and
    # times both on the card), but neither was the faster in every run on
    # an H100, and this staging is the path the CPU tests run. NCCL sends
    # from the card itself.
    stage = home if dist.get_backend() == "nccl" else torch.device("cpu")
    pinned = stage != home
    if pinned:
        # The staging copies wait for the parts; wait here, so that the
        # seconds counted are the exchange's.
        torch.cuda.synchronize(home)
    started = time.perf_counter()
    chunks = []
    for part in parts:
        for t in _leaves(part):
            b = t.detach().contiguous().reshape(-1).view(torch.uint8)
            chunks.append(b.to(home))
            pad = -b.numel() % _ALIGN
            if pad:
                chunks.append(torch.zeros(pad, dtype=torch.uint8, device=home))
    mine = torch.cat(chunks) if chunks else torch.zeros(0, dtype=torch.uint8, device=home)
    if pinned:
        mine = torch.empty(mine.shape, dtype=torch.uint8, pin_memory=True).copy_(mine)
    everyone = [
        torch.empty(mine.shape, dtype=torch.uint8, device=mine.device, pin_memory=pinned)
        for _ in range(world)
    ]
    dist.all_gather(everyone, mine)
    template = parts[0]
    shapes = [(t.shape, t.dtype) for t in _leaves(template)]

    def unpack(buffer):
        buffer = buffer.to(home, non_blocking=True)
        tensors, offset = [], 0
        for _ in range(len(local)):
            one = []
            for shape, dtype in shapes:
                nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
                one.append(buffer[offset : offset + nbytes].view(dtype).reshape(shape))
                offset += nbytes + (-nbytes % _ALIGN)
            tensors.append(_rebuild(template, iter(one)))
        return tensors

    received = {r: unpack(b) for r, b in enumerate(everyone) if r != rank}
    taken = {r: 0 for r in received}
    out, mine_left = [], iter(parts)
    for d in devices:
        if _is_local(d):
            out.append(next(mine_left))
        else:
            out.append(received[d.rank][taken[d.rank]])
            taken[d.rank] += 1
    collective_stats.calls += 1
    collective_stats.bytes += world * mine.numel()
    collective_stats.seconds += time.perf_counter() - started
    return out


def all_reduce(parts: list, devices) -> list:
    """The sum of the shards' partial tensors (or tuples of them), added in
    mesh order on this process's first device of ``devices`` (the shards'
    devices, in mesh order) and copied to each of this process's shards.
    ``parts`` holds one part a shard of this process. With one shard, its
    part itself. Across processes every process gathers every part and adds
    them in the same order, so all compute the same bits, and the bits of
    one process holding every shard."""
    devices = list(devices)
    local = [d for d in devices if _is_local(d)]
    every = _with_remote(parts, devices)

    def reduce(leaf):
        total = leaf[0].to(local[0])
        for p in leaf[1:]:
            total = total + p.to(local[0])
        return broadcast(total, local)

    return _per_leaf(reduce, every, len(local))


def all_gather(parts: list, devices, dim: int = 0) -> list:
    """The shards' tensors (or tuples of them) joined along ``dim`` in mesh
    order on this process's first device of ``devices`` (in mesh order),
    and copied to each of this process's shards; ``parts`` holds one a
    shard of this process."""
    devices = list(devices)
    local = [d for d in devices if _is_local(d)]
    every = _with_remote(parts, devices)

    def gather(leaf):
        return broadcast(torch.cat([p.to(local[0]) for p in leaf], dim=dim), local)

    return _per_leaf(gather, every, len(local))


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
    """Drive one generator a shard of this process (``steps``, in the order
    of this process's shards among ``devices``, every shard's device in
    mesh order) in lockstep: each runs to its next request, then the
    requests, all of one kind, are answered together (:func:`all_reduce`
    or :func:`all_gather`, across processes where ``devices`` spans
    several) and each generator goes on with its shard's answer. Returns
    what each generator returns, in order: the first is this process's
    first shard's. With one shard, the same as :func:`run_local`."""
    devices = list(devices)
    if len(devices) == 1:
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
