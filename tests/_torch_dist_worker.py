"""One process of the port's two-process runs, and the scenarios they run.

Run as::

    python tests/_torch_dist_worker.py RANK WORLD STORE OUT SCENARIOS \\
        [--device cpu] [--local 2]

Each of WORLD processes joins a gloo group through the file STORE
(``init_method="file://STORE"``), builds the global mesh of ``--local``
shards a process on ``--device`` (``parallel.distributed.global_mesh``),
runs the comma-separated SCENARIOS through the production multi-process
branches, and saves their results to ``OUT.RANK.npz``; it prints nothing
else of them. :func:`run_scenario` with a one-process mesh of the same
size runs the same global program in one process, which is what the
results are held to. The scenarios are those of
``scripts/_mp_suite_worker.py``, the JAX package's two-process matrix, on
the port, with one more (``dp_lstsq_opr_pos``). No JAX is imported.
"""

from __future__ import annotations

import argparse
import datetime
import sys
import traceback

import numpy as np
import torch

# (name, layout, algorithm, features)
SCENARIOS = [
    ("dp_rpie_compact", "replicated", "rpie", {}),
    ("dp_lstsq_wobbly", "replicated", "lstsq", {"wobbly": True}),
    ("dp_rpie_eigen", "replicated", "rpie", {"eigen": True}),
    ("dp_rpie_streamed", "replicated", "rpie", {"stream": True}),
    ("dp_lstsq_opr_pos", "replicated", "lstsq",
     {"eigen": True, "positions": True, "regularize": True}),
    ("striped_rpie", "striped", "rpie", {"rescale": True}),
    ("striped_rpie_streamed", "striped", "rpie", {"stream": True}),
    # Every position in process 0's stripes: process 1 holds no pattern,
    # and the rescale's decision to enter its collective must agree.
    ("striped_rpie_degenerate", "striped", "rpie", {"rescale": True, "clustered": True}),
    ("striped_lstsq_opr_pos", "striped", "lstsq", {"eigen": True, "positions": True}),
    ("lamino_cgrad_theta", "lamino", "cgrad", {}),
    ("lamino_cgls_theta", "lamino", "cgls", {}),
    ("lamino_cgrad_theta_gaussian", "lamino", "cgrad", {"kernel": "gaussian", "cg_iter": 1}),
    ("lamino_cgls_theta_gaussian", "lamino", "cgls", {"kernel": "gaussian", "cg_iter": 1}),
    ("lamino_bucket_volsplit", "bucket", "bucket", {}),
]
NAMES = {s[0]: s for s in SCENARIOS}


def build_problem(device, seed=11, h=128, p=16, n=120, nmodes=2, clustered=False,
                  random_probe=False):
    """The two-process matrix's problem, simulated by the port. With
    ``random_probe`` the probe's modes are complex noise, as in
    ``tests/parallel/_dist_worker.py``: the smooth Hermite modes and a
    constant start leave far-field pixels near 0, where two FFT libraries'
    rounding parts the packages by about 1e-3 (ROADMAP.md, parity
    gotchas), so the comparison with tike_tpu takes these."""
    import tike_tpu_torch.ptycho as tp

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:h] / h
    psi = (
        np.exp(1j * 0.5 * np.sin(5 * yy) * np.cos(3 * xx)) * (0.9 + 0.1 * np.cos(7 * xx))
    ).astype(np.complex64)[None]
    if random_probe:
        probe = (
            rng.standard_normal((1, 1, nmodes, p, p))
            + 1j * rng.standard_normal((1, 1, nmodes, p, p))
        ).astype(np.complex64)
    else:
        probe = (tp.gaussian(p) * np.exp(1j * 0.2 * tp.gaussian(p)))[None, None, None]
        probe = np.asarray(tp.add_modes_cartesian_hermite(probe.astype(np.complex64), nmodes))
        probe = probe.astype(np.complex64)
    scan = np.stack(
        [rng.uniform(2, h - p - 3, n), rng.uniform(2, h - p - 3, n)], -1
    ).astype(np.float32)
    if clustered:
        rng = np.random.default_rng(5)
        scan = np.stack(
            [rng.uniform(2, h // 4, n), rng.uniform(2, h - p - 3, n)], -1
        ).astype(np.float32)
    data = tp.simulate(p, probe, scan, psi, device=device).astype(np.float32)
    return data, scan, probe, psi.shape


def _parameters(scan, probe, psi_shape, algo, feat, tp=None):
    """The scenario's parameters, of ``tp`` (the port's ``ptycho``, or
    another package's of the same API)."""
    if tp is None:
        import tike_tpu_torch.ptycho as tp

    n, m = scan.shape[0], probe.shape[-3]
    kwargs = {}
    if feat.get("eigen"):
        weights = np.zeros((n, 2, m), np.float32)
        weights[:, 0, :] = 1.0
        kwargs["eigen_probe"] = 0.01 * probe[:, :1, :1]
        kwargs["eigen_weights"] = weights
    if feat.get("positions"):
        kwargs["position_options"] = tp.PositionOptions(
            initial_scan=scan,
            update_magnitude_limit=0.2,
            use_position_regularization=bool(feat.get("regularize")),
        )
    options = tp.RpieOptions if algo == "rpie" else tp.LstsqOptions
    return tp.PtychoParameters(
        psi=np.full(psi_shape, 0.5 + 0j, np.complex64),
        probe=probe.copy(),
        scan=scan.copy(),
        algorithm_options=options(
            num_iter=3,
            num_batch=2,
            batch_method="wobbly_center" if feat.get("wobbly") else "compact",
        ),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(
            init_rescale_from_measurements=bool(feat.get("rescale"))
        ),
        **kwargs,
    )


def _ptycho(layout, algo, feat, mesh, device, single, random_probe=False):
    import tike_tpu_torch.parallel.distributed as dist
    import tike_tpu_torch.parallel.striped as striped
    import tike_tpu_torch.ptycho as tp

    data, scan, probe, psi_shape = build_problem(
        device, clustered=bool(feat.get("clustered")), random_probe=random_probe
    )
    params = _parameters(scan, probe, psi_shape, algo, feat)
    store = not feat.get("stream")
    if layout == "striped":
        if not single:
            data = data[striped.striped_local_indices(scan, psi_shape[-2:], probe.shape[-1], mesh)]
        # No seed: the layout across processes draws from 0, which the
        # one-process run is given.
        kw = dict(random_seed=0) if single else {}
        context = tp.Reconstruction(
            data, params, mesh=mesh, object_sharding="striped",
            store_data_on_device=store, device=device, **kw,
        )
    else:
        if single:
            kw = dict(_force_stripes=2)
        else:
            data, kw = data[dist.stripe_for_process(scan)], {}
        context = tp.Reconstruction(
            data, params, mesh=mesh, random_seed=0, store_data_on_device=store,
            device=device, **kw,
        )
    with context:
        context.iterate(params.algorithm_options.num_iter)
        result = context.get_result()
    out = {
        "psi": np.asarray(result.psi),
        "probe": np.asarray(result.probe),
        "scan": np.asarray(result.scan),
        "costs": np.asarray([c[0] for c in result.algorithm_options.costs], np.float64),
    }
    if result.eigen_weights is not None:
        out["eigen_weights"] = np.asarray(result.eigen_weights)
    return out


def _volume(n):
    rng = np.random.default_rng(0)
    obj = (rng.standard_normal((n, n, n)) + 1j * rng.standard_normal((n, n, n))).astype(
        np.complex64
    )
    return (obj * np.exp(-((np.mgrid[0:n, 0:n, 0:n] - n / 2) ** 2).sum(0) / (n / 3) ** 2)).astype(
        np.complex64
    )


def _lamino(mesh, device, single, processes, algorithm, n=16, ntheta=8, kernel="kb",
            **options):
    import tike_tpu_torch.lamino as tl
    import tike_tpu_torch.parallel.distributed as dist

    theta = np.linspace(0, np.pi, ntheta, endpoint=False).astype(np.float32)
    data = tl.simulate(_volume(n), theta, np.pi / 3, eps=1e-3, upsample=2, kernel=kernel,
                       device=device)
    if not single:
        data, theta = dist.split_for_process(data, theta, num_processes=processes)
    result = tl.reconstruct(
        data, theta, np.pi / 3, algorithm, num_iter=4, eps=1e-3, upsample=2, kernel=kernel,
        mesh=mesh, device=device, **options,
    )
    return {"psi": result["obj"], "costs": np.asarray(result["cost"], np.float64)}


def _bucket(mesh, device):
    import tike_tpu_torch.lamino.bucket as bucket

    n, ntheta = 16, 8
    theta = np.linspace(0, np.pi, ntheta, endpoint=False).astype(np.float32)
    # Simulated on the CPU: on the card the Bucket forward's float atomics
    # would give each process other last bits of the data.
    data = bucket.simulate(_volume(n), theta, np.pi / 2, eps=1.0, device="cpu")
    result = bucket.reconstruct(
        data, theta, np.pi / 2, num_iter=4, eps=1.0, mesh=mesh, device=device
    )
    return {"psi": result["obj"], "costs": np.asarray(result["cost"], np.float64)}


def run_scenario(name, mesh, device, single, processes=2, random_probe=False):
    """Scenario ``name`` on ``mesh``: with ``single``, in one process that
    holds every shard (the full data; ``_force_stripes`` for the
    replicated layout), else as one of ``processes`` processes of a mesh
    across them. Returns its arrays and costs."""
    _, layout, algo, feat = NAMES[name]
    if layout == "lamino":
        return _lamino(mesh, device, single, processes, algo, **feat)
    if layout == "bucket":
        return _bucket(mesh, device)
    return _ptycho(layout, algo, feat, mesh, device, single, random_probe)


def launch(scenarios, workdir, device="cpu", local=2, world=2, timeout=120.0):
    """Run ``scenarios`` (names, or ``"api"``) in ``world`` worker
    processes of this module and return each rank's results (a dict of
    arrays). The workers meet through a file store under ``workdir``;
    each must end within ``timeout`` seconds, and one that fails or hangs
    fails the call with its output."""
    import os
    import pathlib
    import subprocess

    workdir = pathlib.Path(workdir)
    store, out = workdir / "store", workdir / "out"
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, str(rank), str(world), str(store), str(out),
             ",".join(scenarios), "--device", device, "--local", str(local),
             "--timeout", str(max(10.0, timeout - 10.0))],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for rank in range(world)
    ]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=timeout)[0].decode())
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        if proc.returncode:
            raise RuntimeError(f"worker {rank} exited with {proc.returncode}:\n{log[-4000:]}")
    return [dict(np.load(f"{out}.{rank}.npz")) for rank in range(world)]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("rank", type=int)
    parser.add_argument("world", type=int)
    parser.add_argument("store")
    parser.add_argument("out")
    parser.add_argument("scenarios")
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--local", type=int, default=2)
    parser.add_argument("--timeout", type=float, default=60.0)
    args = parser.parse_args(argv)
    torch.set_num_threads(1)
    import tike_tpu_torch.parallel as par
    import tike_tpu_torch.parallel.distributed as dist

    dist.initialize(
        init_method=f"file://{args.store}", num_processes=args.world, process_id=args.rank,
        backend="gloo", timeout=datetime.timedelta(seconds=args.timeout),
    )
    mesh = dist.global_mesh(local_devices=[args.device] * args.local)
    results = {}
    for name in args.scenarios.split(","):
        if name == "api":
            results.update(api_checks(args.device, args.local))
            continue
        for key, value in run_scenario(name, mesh, args.device, False, args.world).items():
            results[f"{name}/{key}"] = value
        results[f"{name}/collectives"] = np.asarray(
            [par.collective_stats.calls, par.collective_stats.bytes]
        )
        par.collective_stats.reset()
    np.savez(f"{args.out}.{args.rank}.npz", **results)
    torch.distributed.destroy_process_group()


def api_checks(device, local):
    """The module's functions across the processes: a second
    ``initialize`` is a no-op, the meshes' shapes and owners, the
    placements and their fetch, a reduction, ``halo.swap_edges`` of stripes
    of both processes, and unequal device counts refused."""
    import tike_tpu_torch.parallel as par
    import tike_tpu_torch.parallel.distributed as dist
    import tike_tpu_torch.parallel.halo as halo

    rank, world = dist.process_index(), dist.process_count()
    group = torch.distributed.group.WORLD
    dist.initialize(init_method="file:///nonexistent", num_processes=world, process_id=rank)
    assert torch.distributed.group.WORLD is group
    mesh = dist.global_mesh(local_devices=[device] * local)
    assert mesh.size == world * local and mesh.process_count == world
    assert mesh.local == list(range(rank * local, (rank + 1) * local))
    assert all(isinstance(d, par.Remote) != mesh.is_local(k) for k, d in enumerate(mesh.flat))
    grid = dist.dcn_mesh(local_devices=[device] * local)
    assert grid.shape == {"dcn": world, "ici": local}
    assert [k // local for k in grid.local] == [rank] * local
    whole = torch.arange(world * local * 6.0).reshape(world * local * 2, 3)
    parts = par.put_replicated_global(whole, par.batch_sharding(mesh))
    assert len(parts) == local
    mine = whole[rank * local * 2 : (rank + 1) * local * 2]
    placed = par.put_process_local(mine, par.batch_sharding(mesh), whole.shape[0])
    assert all(torch.equal(a, b) for a, b in zip(parts, placed))
    fetched = par.fetch_global(placed, mesh=mesh)
    replicated = par.put_replicated_global(whole, par.replicated_sharding(mesh))
    summed = par.all_reduce([p.sum(0) for p in placed], mesh.flat)[0]
    # Batch-major data (nb 2, world * local * 3 slots, 2): this process's block.
    batches = torch.arange(2 * world * local * 3 * 2.0).reshape(2, world * local * 3, 2)
    block = batches[:, rank * local * 3 : (rank + 1) * local * 3]
    resident = dist.make_global_batch_data(mesh, block, world)
    streamed = dist.HostStreamedBatches(mesh, block, world)
    assert streamed.shape == tuple(batches.shape) and len(streamed) == 2
    assert all(torch.equal(a, b[1]) for a, b in zip(streamed[1], resident))
    psi = torch.arange(2 * world * local * 4 * 3.0).reshape(1, world * local * 4, 6)
    seams = halo.swap_edges(par.put(psi, par.batch_sharding(mesh, axis=1)), mesh, 2)
    refused = ""
    try:
        dist.global_mesh(local_devices=[device] * (1 + rank))
    except ValueError as error:
        refused = str(error)
    return {
        "api/fetched": fetched,
        "api/replicated": par.fetch_global(replicated[0]),
        "api/summed": summed.numpy(),
        "api/batches": par.fetch_global(resident, axis=1, mesh=mesh),
        "api/swapped": par.fetch_global(seams, axis=1, mesh=mesh),
        "api/refused": np.asarray(refused),
    }


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        sys.exit(1)
