"""Laminography on a mesh: the port's Bucket volume slabs (``obj_split``, a
1-D or 2-D mesh) and USFFT theta split against tike_tpu's on meshes of the
same shape (the conftest's virtual CPU devices), and the plain versions'
slab argument against the full lattice.

The operators are held at 1e-5, the bounds that
``tests/parallel/test_lamino_mesh.py`` sets for tike_tpu's own sharded
operators; the reconstructions with tike_tpu's own criteria there (the
Dai-Yuan line search turns a reduction's last bits into another
trajectory, so Bucket runs are held on convergence, and the USFFT costs at
1e-3 relative).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as P

import tike_tpu.lamino as jl
import tike_tpu.lamino.bucket as jlb
import tike_tpu.ops.bucket as jb
import tike_tpu.parallel as jpar

import tike_tpu_torch.lamino as tl
import tike_tpu_torch.lamino.bucket as tlb
import tike_tpu_torch.ops.bucket as tb
import tike_tpu_torch.parallel as tpar

from ._torch_parity import assert_close

TILT = np.pi / 3


def _problem(n=16, ntheta=6, seed=5):
    """tests/parallel/test_lamino_mesh.py's problem."""
    gen = np.random.default_rng(seed)
    obj = (gen.standard_normal((n, n, n)) + 1j * gen.standard_normal((n, n, n))).astype(
        np.complex64
    ) * 0.1
    theta = np.linspace(0, 2 * np.pi, ntheta, endpoint=False).astype(np.float32)
    return obj, theta


def cpu_mesh(size):
    return tpar.make_mesh(devices=["cpu"] * size)


def cpu_mesh_2d():
    return tpar.Mesh(np.array(["cpu"] * 8).reshape(2, 4), ("d", "v"))


def jax_mesh_2d():
    return JaxMesh(np.asarray(jax.devices()).reshape(2, 4), ("d", "v"))


def test_sharded_bucket_ops_match_jax():
    """fwd and adj on 4 x-slabs against tike_tpu's shard_map pair, 1e-5."""
    obj, theta = _problem()
    jcfg = jb.BucketConfig(n=16, tilt=float(TILT), precision=2)
    tcfg = tb.BucketConfig(n=16, tilt=float(TILT), precision=2)
    jmesh = jpar.make_mesh(4)
    axis = jmesh.axis_names[0]
    grid4 = jax.device_put(jb.make_grid_full(16), NamedSharding(jmesh, P(axis)))
    jfwd, jadj, _, _, _ = jb.sharded_bucket_ops(jcfg, jmesh, axis)
    want_fwd = np.asarray(jfwd(jax.device_put(obj, NamedSharding(jmesh, P(axis))),
                               jax.device_put(theta, NamedSharding(jmesh, P())), grid4))
    tfwd, tadj, _, _, _ = tb.sharded_bucket_ops(tcfg, cpu_mesh(4), tpar.BATCH_AXIS)
    u, th = torch.as_tensor(obj), torch.as_tensor(theta)
    got_fwd = tfwd(u, th)
    assert_close(got_fwd, want_fwd, rtol=1e-5, atol=1e-6)
    data = want_fwd
    want_adj = np.asarray(jadj(jax.device_put(data, NamedSharding(jmesh, P())),
                               jax.device_put(theta, NamedSharding(jmesh, P())), grid4))
    got_adj = tadj(torch.as_tensor(data.copy()), th)
    assert_close(got_adj, want_adj, rtol=1e-5, atol=1e-6)
    # Owner-local adjoint: the slabs' gathers are the single device's, bit for bit.
    np.testing.assert_array_equal(
        got_adj.numpy(),
        tb.bucket_adj(tcfg, torch.as_tensor(data.copy()), th).reshape(16, 16, 16).numpy(),
    )


def test_sharded_bucket_ops_2d_match_jax():
    """The five callables on a 2 x 4 (data x volume) mesh against
    tike_tpu's, 1e-5: projections summed within a data group, gradients
    across the groups."""
    obj, theta = _problem()
    jcfg = jb.BucketConfig(n=16, tilt=float(TILT), precision=2)
    tcfg = tb.BucketConfig(n=16, tilt=float(TILT), precision=2)
    jmesh = jax_mesh_2d()
    vol, dat = NamedSharding(jmesh, P("v")), NamedSharding(jmesh, P("d"))
    grid4 = jax.device_put(jb.make_grid_full(16), vol)
    u_j, th_j = jax.device_put(obj, vol), jax.device_put(theta, dat)
    jf, ja, jc, jg, js = jb.sharded_bucket_ops_2d(jcfg, jmesh, "d", "v")
    tf, ta, tc, tg, ts = tb.sharded_bucket_ops_2d(tcfg, cpu_mesh_2d(), "d", "v")
    u, th = torch.as_tensor(obj), torch.as_tensor(theta)
    want_fwd = np.asarray(jf(u_j, th_j, grid4))
    assert_close(tf(u, th), want_fwd, rtol=1e-5, atol=1e-6)
    data = want_fwd * 0.9
    data_j, data_t = jax.device_put(data, dat), torch.as_tensor(data)
    assert_close(ta(data_t, th), np.asarray(ja(data_j, th_j, grid4)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tc(data_t, u, th)), float(jc(data_j, u_j, th_j, grid4)),
                               rtol=1e-5)
    assert_close(tg(data_t, u, th), np.asarray(jg(data_j, u_j, th_j, grid4)), rtol=1e-5,
                 atol=1e-6)
    np.testing.assert_allclose(float(ts(u, th)), float(js(u_j, th_j, grid4)), rtol=1e-5)
    with pytest.raises(ValueError, match="evenly divide the number of angles"):
        tf(u, th[:5])
    with pytest.raises(ValueError, match="take no grid"):
        tc(data_t, u, th, torch.zeros(1))


@pytest.mark.parametrize("n, size", [(16, 2), (16, 4), (13, 3)])
def test_plain_slabs_match_the_full_lattice(n, size):
    """The plain versions' ``slab=(x0, rows)`` against the full lattice: the
    slabs' forwards sum to the lattice's (1e-5 of the largest value; the
    order of the sums differs), each slab's adjoint is its rows of the
    lattice's, bit for bit, and a slab equals the caller's grid of the same
    voxels (``make_grid(n, size, rank)``), bit for bit."""
    cfg = tb.BucketConfig(n=n, tilt=float(TILT), precision=2)
    obj, theta = _problem(n=n, ntheta=5)
    u, th = torch.as_tensor(obj), torch.as_tensor(theta)
    d = tb.bucket_fwd(cfg, u, th)
    full_adj = tb.bucket_adj(cfg, d, th).reshape(n, n, n)
    total = torch.zeros_like(d)
    for rank in range(size):
        x0, rows = tb.slab_of(n, size, rank)
        part = tb.bucket_fwd_plain(cfg, u[x0 : x0 + rows], th, slab=(x0, rows))
        grid = tb.make_grid(n, size, rank)
        assert torch.equal(part, tb.bucket_fwd_plain(cfg, u[x0 : x0 + rows], th, grid))
        total = total + part
        adj = tb.bucket_adj_plain(cfg, d, th, slab=(x0, rows))
        assert torch.equal(adj.reshape(rows, n, n), full_adj[x0 : x0 + rows])
        assert torch.equal(adj, tb.bucket_adj_plain(cfg, d, th, grid))
    assert_close(total, d, rtol=1e-5, atol=1e-5, scale=True)
    with pytest.raises(ValueError, match="a grid or a slab"):
        tb.bucket_adj_plain(cfg, d, th, tb.make_grid(n), slab=(0, n))
    with pytest.raises(ValueError, match="run of rows"):
        tb.bucket_adj_plain(cfg, d, th, slab=(n - 1, 2))


def _converged(single, split):
    """tests/parallel/test_lamino_mesh.py's criteria."""
    for r in (single, split):
        assert np.all(np.isfinite(r["cost"]))
        assert r["cost"][-1] < r["cost"][0]
    start = max(single["cost"][0], split["cost"][0])
    assert split["cost"][-1] < 0.5 * start
    a, b = split["obj"], single["obj"]
    corr = np.abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
    assert corr > 0.9, corr


@pytest.mark.parametrize("how", ["obj_split", "mesh_2d"])
def test_bucket_reconstruct_on_a_mesh(how):
    """``obj_split=4`` and a 2 x 4 mesh: against the port's single device
    with tike_tpu's own criteria (2 outer iterations of 3 CG steps, where
    the line search's decisions part the trajectories); and at
    ``cg_iter=1``, where no decision can part them, against tike_tpu's mesh
    run of the same kind: costs and volume at 1e-5."""
    obj, theta = _problem()
    data = tlb.simulate(obj, theta, TILT, eps=1.0, device="cpu")
    if how == "obj_split":
        jmesh, tmesh = dict(obj_split=4), dict(obj_split=4)
    else:
        jmesh, tmesh = dict(mesh=jax_mesh_2d()), dict(mesh=cpu_mesh_2d())
    kwargs = dict(data=data, theta=theta, tilt=TILT, num_iter=2, cg_iter=3, eps=1.0)
    _converged(tlb.reconstruct(**kwargs, device="cpu"), tlb.reconstruct(**kwargs, **tmesh,
                                                                         device="cpu"))
    kwargs["cg_iter"] = 1
    want = jlb.reconstruct(**kwargs, **jmesh)
    got = tlb.reconstruct(**kwargs, **tmesh, device="cpu")
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-5)
    assert_close(got["obj"], want["obj"], rtol=1e-5, atol=1e-5, scale=True)


@pytest.mark.parametrize("algorithm, cg_iter", [("cgrad", 1), ("cgls", 2)])
def test_usfft_theta_mesh_matches_jax(algorithm, cg_iter):
    """USFFT laminography with theta split over 4 shards against tike_tpu's
    on ``make_mesh(4)`` (n = 16, 8 angles, upsample 2): costs at rtol 1e-3
    and the volume at rtol 1e-3, atol 1e-5 (tike_tpu's own bounds); the
    port's mesh against its single device at 1e-5, and a one-shard mesh
    bit for bit. cgrad at ``cg_iter=1``: from the second step its line
    search decides on ties (ROADMAP.md section 3)."""
    obj, theta = _problem(n=16, ntheta=8)
    data = tl.simulate(obj, theta, TILT, upsample=2, device="cpu")
    kwargs = dict(data=data, theta=theta, tilt=TILT, algorithm=algorithm, num_iter=2,
                  cg_iter=cg_iter, upsample=2)
    want = jl.reconstruct(mesh=jpar.make_mesh(4), **kwargs)
    got = tl.reconstruct(mesh=cpu_mesh(4), device="cpu", **kwargs)
    single = tl.reconstruct(device="cpu", **kwargs)
    one = tl.reconstruct(mesh=cpu_mesh(1), device="cpu", **kwargs)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-3)
    np.testing.assert_allclose(got["obj"], want["obj"], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got["cost"], single["cost"], rtol=1e-5)
    np.testing.assert_array_equal(one["obj"], single["obj"])
    with pytest.raises(ValueError, match="divide the 8 angles"):
        tl.reconstruct(mesh=cpu_mesh(3), device="cpu", **kwargs)
    with pytest.raises(ValueError, match="MeshLaminoPlan"):
        from tike_tpu_torch.ops.lamino import LaminoConfig, LaminoPlan

        plan = LaminoPlan(LaminoConfig(n=16, tilt=TILT, upsample=2), torch.as_tensor(theta))
        tl.reconstruct(mesh=cpu_mesh(4), device="cpu", plan=plan, **kwargs)
