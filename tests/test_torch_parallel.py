"""The port's single-process mesh (``tike_tpu_torch.parallel``) against
tike_tpu's: the mesh and the placements, the reduction's order and its
repeatability, the lockstep of the shards' steps, and ``swap_edges`` on an
8-device mesh (the conftest's virtual CPU devices) at 1e-6, with the
reference's error cases.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import tike_tpu.parallel as jpar
import tike_tpu.parallel.halo as jhalo

import tike_tpu_torch.parallel as tpar
import tike_tpu_torch.parallel.halo as thalo

from ._torch_parity import crandn, rng


def cpu_mesh(size):
    return tpar.make_mesh(devices=["cpu"] * size)


def test_make_mesh_and_placements():
    mesh = cpu_mesh(4)
    assert mesh.axis_names == (tpar.BATCH_AXIS,) == (jpar.BATCH_AXIS,)
    assert mesh.size == 4 and mesh.shape == {"batch": 4}
    assert mesh.flat == [torch.device("cpu")] * 4
    two = tpar.Mesh(np.array(["cpu"] * 8).reshape(2, 4), ("d", "v"))
    assert two.shape == {"d": 2, "v": 4} and two.size == 8
    x = torch.arange(24.0).reshape(2, 12)
    parts = tpar.put(x, tpar.batch_sharding(mesh, axis=1))
    assert [tuple(p.shape) for p in parts] == [(2, 3)] * 4
    np.testing.assert_array_equal(tpar.fetch_global(parts, axis=1), x.numpy())
    same = tpar.put(x, tpar.replicated_sharding(mesh))
    assert all(p is x for p in same)  # on its device already: no copy
    np.testing.assert_array_equal(
        tpar.fetch_global(
            tpar.put_process_local(x.numpy(), tpar.batch_sharding(mesh, axis=1), 2), axis=1
        ),
        x.numpy(),
    )
    np.testing.assert_array_equal(
        tpar.put_replicated_global(x.numpy(), tpar.replicated_sharding(mesh))[3], x.numpy()
    )
    with pytest.raises(ValueError, match="equal shards"):
        tpar.put(torch.zeros(10), tpar.batch_sharding(mesh))
    # As tike_tpu's make_mesh, n_devices is not read where devices are given.
    assert tpar.make_mesh(3, devices=["cpu", "cpu"]).size == 2
    with pytest.raises(ValueError, match="1-D or 2-D"):
        tpar.Mesh(["cpu"] * 2, ("a", "b"))


def test_make_mesh_without_devices_takes_the_cards(monkeypatch):
    """No card: a refusal, never the CPU unasked. Cards: the first
    ``n_devices`` of them, or all where fewer are visible, as
    tike_tpu's ``make_mesh`` takes ``jax.devices()[:n]``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        tpar.make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tpar.make_mesh().flat == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert tpar.make_mesh(1).flat == [torch.device("cuda", 0)]
    assert tpar.make_mesh(8).size == 2
    assert jpar.make_mesh(64).size == len(jax.devices())


def test_make_mesh_ignores_n_devices_where_devices_are_given():
    assert tpar.make_mesh(8, devices=["cpu"] * 3).size == 3
    assert jpar.make_mesh(8, devices=jax.devices()[:3]).size == 3


def test_all_reduce_adds_in_mesh_order_and_repeats():
    """The sum is taken on the first shard, in mesh order: float32 parts
    that cancel show it (1e8 + 1 - 1e8 + 1 is 1, not 2), a second run
    gives the same bits, and a tuple with None leaves reduces leaf by
    leaf. One shard returns its part itself."""
    devices = cpu_mesh(4).flat
    parts = [torch.tensor([1e8]), torch.tensor([1.0]), torch.tensor([-1e8]), torch.tensor([1.0])]
    out = tpar.all_reduce(parts, devices)
    f = np.float32
    assert float(out[0]) == float(((f(1e8) + f(1)) - f(1e8)) + f(1)) == 1.0
    assert all(torch.equal(o, out[0]) for o in out)
    gen = rng(3)
    big = [(torch.as_tensor(crandn(gen, 64, 64)), None) for _ in range(4)]
    a, b = tpar.all_reduce(big, devices), tpar.all_reduce(big, devices)
    assert torch.equal(a[0][0], b[0][0]) and a[2][1] is None
    want = ((big[0][0] + big[1][0]) + big[2][0]) + big[3][0]
    assert torch.equal(a[1][0], want)
    one = [torch.ones(3)]
    assert tpar.all_reduce(one, devices[:1])[0] is one[0]
    gathered = tpar.all_gather([torch.full((2,), float(s)) for s in range(4)], devices)
    np.testing.assert_array_equal(gathered[3].numpy(), np.repeat(np.arange(4.0), 2))


def _steps(x):
    """A shard's steps: a sum, a gather, then the sum of the gathered."""
    total = yield tpar.Sum(x.sum())
    whole = yield tpar.Gather(x * total)
    return whole.sum()


def test_run_shards_drives_the_shards_in_lockstep():
    xs = [torch.arange(3.0) + 3 * s for s in range(4)]
    got = tpar.run_shards(cpu_mesh(4).flat, [_steps(x) for x in xs])
    total = sum(float(x.sum()) for x in xs)
    assert [float(g) for g in got] == [float(torch.cat(xs).sum() * total)] * 4
    # One shard alone is the shard's own collectives.
    assert float(tpar.run_local(_steps(xs[0]))) == float(xs[0].sum() ** 2)

    def uneven(s):
        yield tpar.Sum(torch.ones(1))
        if s:
            yield tpar.Sum(torch.ones(1))

    with pytest.raises(RuntimeError, match="different numbers"):
        tpar.run_shards(cpu_mesh(2).flat, [uneven(0), uneven(1)])

    def mixed(s):
        yield (tpar.Sum if s else tpar.Gather)(torch.ones(1))

    with pytest.raises(RuntimeError, match="different requests"):
        tpar.run_shards(cpu_mesh(2).flat, [mixed(0), mixed(1)])


def _jax_swap(psi, mesh, overlap):
    sharded = jax.device_put(
        psi, NamedSharding(mesh, PartitionSpec(None, jpar.BATCH_AXIS, None))
    )
    return np.asarray(jax.device_get(jhalo.swap_edges(sharded, mesh, overlap)))


@pytest.mark.parametrize("overlap", [0, 1, 3, 8])
def test_swap_edges_matches_jax_on_8_devices(overlap):
    """Every stripe of 8 against tike_tpu's on ``make_mesh(8)``, 1e-6; an
    overlap of a whole stripe writes the bottom blend last, as there."""
    psi = crandn(rng(5), 2, 8 * 8, 16)
    want = _jax_swap(psi, jpar.make_mesh(8), overlap)
    mesh = cpu_mesh(8)
    stripes = tpar.put(psi, tpar.batch_sharding(mesh, axis=1))
    got = tpar.fetch_global(thalo.swap_edges(stripes, mesh, overlap), axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if 2 * overlap <= 8:  # else stripe 0's bottom blend reaches its top rows
        np.testing.assert_array_equal(got[:, :max(overlap, 1)], psi[:, :max(overlap, 1)])
    ramp = thalo._blend_ramp(3).numpy()
    np.testing.assert_allclose(ramp, np.asarray(jhalo._blend_ramp(3)), rtol=1e-7)


def test_swap_edges_refuses_what_the_reference_refuses():
    """A height that does not split over the mesh, and a halo wider than a
    stripe, raise (``tests/parallel/test_collectives.py``)."""
    mesh = cpu_mesh(8)
    with pytest.raises(ValueError, match="equal shards"):
        tpar.put(np.ones((1, 8 * 8 + 4, 8), np.complex64), tpar.batch_sharding(mesh, axis=1))
    stripes = tpar.put(np.ones((1, 4 * 8, 8), np.complex64), tpar.batch_sharding(mesh, axis=1))
    with pytest.raises(ValueError, match="wider than a stripe"):
        thalo.swap_edges(stripes, mesh, 5)
    with pytest.raises(ValueError, match="stripes for a mesh"):
        thalo.swap_edges(stripes[:4], mesh, 1)
