"""The single-process device mesh of tike_tpu_torch.

Counterpart of :mod:`tike_tpu.parallel`, where ``mesh=`` is one process
driving many devices and GSPMD inserts the reductions. Here a :class:`Mesh`
is a list of ``torch.device`` s, one a shard, which may repeat a device (two
shards on one card, or the CPU tests' shards on the CPU): the counterpart
of the JAX tests' virtual CPU devices. A tensor sharded over a mesh is a
list of per-shard tensors, one on each shard's device, in mesh order
(:func:`put`, :func:`fetch_global`); a replicated one is the same tensor
copied to each shard's device.

Each shard's work runs on its device, one shard after another from this
process, and what crosses shards goes through two collectives:

- :func:`all_reduce`, the one reduction: the shards' partial tensors are
  summed in mesh order on the first shard's device, and the sum is copied
  to each shard's device. The order is fixed, so two runs give the same
  bits, and a mesh of one shard returns its partial unchanged;
- :func:`all_gather`: the shards' tensors joined along an axis in mesh
  order, for what is not a sum (a sort over slots, a write through slots).

Work whose reductions fall in the middle of a step (a mini-batch of
ptychography) is written once, as a generator per shard that yields
:class:`Sum` or :class:`Gather` where it needs the other shards' part and
receives the result: :func:`run_shards` drives the shards' generators in
lockstep, and :func:`run_local` drives one on its own, where each
collective returns its own part (what a mesh of one shard computes).

The data-parallel decomposition is that of the JAX package: diffraction
data and scan slots are split over the mesh, the object, probe and solver
state are replicated. :mod:`.striped` splits the object itself into row
stripes, one a shard, whose epochs meet at the same requests.

Several processes (:mod:`.distributed`, the counterpart of
``tike_tpu.parallel.distributed``) share one global mesh, process-major,
in which another process's shard is a :class:`Remote`: each process runs
its own shards, and the collectives fetch the other processes' parts
through ``torch.distributed`` and add every part in mesh order, so all
processes compute the same bits, and the bits of one process holding
every shard. :data:`collective_stats` counts those exchanges.
"""

from ._mesh import (  # noqa: F401
    BATCH_AXIS,
    Gather,
    Mesh,
    Remote,
    Sharding,
    Sum,
    all_gather,
    all_reduce,
    batch_sharding,
    broadcast,
    collective_stats,
    fetch_global,
    home_device,
    make_mesh,
    put,
    put_process_local,
    put_replicated_global,
    replicated_sharding,
    run_local,
    run_shards,
)
from ._mesh import __all__  # noqa: F401
