"""The multi-process layout in one process of each package, shared by the
files that hold it to tike_tpu: ``Reconstruction(..., _force_stripes=2)``
on 4 CPU shards against tike_tpu's on 4 of the conftest's virtual CPU
devices, on ``tests/parallel/_dist_worker.py``'s problem
(:func:`run_force_stripes`), and the two-process matrix's ptychography
scenarios in one process of each package (``_force_stripes=2``, or the
striped object from seed 0), on the matrix's problem with a noise probe
(``_torch_dist_worker.build_problem(random_probe=True)``), at
``_torch_parity.SLICE_TOL`` (:func:`check_scenario_against_jax`)."""

import jax
import numpy as np
from jax.sharding import Mesh as JaxMesh

import tike_tpu.ptycho as jp

import tike_tpu_torch.parallel as tpar
import tike_tpu_torch.ptycho as tp
from tike_tpu_torch import convert
from tike_tpu_torch.ptycho.solvers.epoch import ShardedBatches
from tike_tpu_torch.ptycho.stream import StreamedBatches

from . import _torch_parity as H
from ._torch_dist_worker import NAMES, _parameters, build_problem, run_scenario


def jax_run(name):
    _, layout, algo, feat = NAMES[name]
    data, scan, probe, psi_shape = build_problem(
        "cpu", clustered=bool(feat.get("clustered")), random_probe=True
    )
    params = _parameters(scan, probe, psi_shape, algo, feat, jp)
    mesh = JaxMesh(np.asarray(jax.devices()[:4]), ("batch",))
    kw = dict(object_sharding="striped") if layout == "striped" else dict(_force_stripes=2)
    with jp.Reconstruction(
        data, params, mesh=mesh, random_seed=0, store_data_on_device=not feat.get("stream"),
        **kw,
    ) as context:
        context.iterate(params.algorithm_options.num_iter)
        return convert.parameters_to_numpy(context.get_result())


def check_scenario_against_jax(name):
    got = run_scenario(name, tpar.make_mesh(devices=["cpu"] * 4), "cpu", True, random_probe=True)
    want = jax_run(name)
    np.testing.assert_allclose(got["costs"], [c[0] for c in want["costs"]], rtol=H.SLICE_TOL)
    keys = ["psi", "probe", "scan"] + (["eigen_weights"] if "eigen_weights" in got else [])
    for key in keys:
        H.assert_close(got[key], want[key], rtol=H.SLICE_TOL, atol=H.SLICE_TOL, scale=True)


EPOCHS = 3


def emulation_parameters(pkg, problem, solver, **algo):
    """``tests/parallel/test_distributed.py``'s parameters, of ``pkg``."""
    _, scan, probe, psi_shape = problem
    algo = (pkg.RpieOptions if solver == "rpie" else pkg.LstsqOptions)(
        num_iter=EPOCHS, num_batch=3, batch_method="compact", **algo
    )
    return pkg.PtychoParameters(
        psi=np.full(psi_shape, 0.8 + 0j, dtype=np.complex64),
        probe=probe.copy(),
        scan=scan.copy(),
        algorithm_options=algo,
        object_options=pkg.ObjectOptions(),
        probe_options=pkg.ProbeOptions(),
    )


def run_force_stripes(pkg, problem, solver, store, algo=None):
    """EPOCHS epochs of ``Reconstruction(..., _force_stripes=2)`` of
    ``pkg`` on its 4-shard mesh, from seed 0; the result as numpy."""
    data = problem[0]
    if pkg is tp:
        mesh, kw = tpar.make_mesh(devices=["cpu"] * 4), dict(device="cpu")
    else:
        mesh, kw = JaxMesh(np.asarray(jax.devices()[:4]), ("batch",)), {}
    with pkg.Reconstruction(
        data, emulation_parameters(pkg, problem, solver, **(algo or {})), mesh=mesh,
        random_seed=0, store_data_on_device=store, _force_stripes=2, **kw
    ) as context:
        if pkg is tp:
            assert isinstance(context.data, ShardedBatches)
            assert all(isinstance(d, StreamedBatches) != store for d in context.data.data)
        context.iterate(EPOCHS)
        return convert.parameters_to_numpy(context.get_result())


def emulation_runs(problem, solver):
    """store -> (the port's run, tike_tpu's run); "loop" -> the port's
    resident run on the per-epoch path, which streaming takes (a finite
    ``time_limit`` sends it there)."""
    out = {
        store: (run_force_stripes(tp, problem, solver, store),
                run_force_stripes(jp, problem, solver, store))
        for store in (True, False)
    }
    out["loop"] = run_force_stripes(tp, problem, solver, True, dict(time_limit=1e9))
    return out


def check_emulation(runs, store):
    got, want = runs[store]
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=H.SLICE_TOL)
    assert got["costs"][-1][0] < got["costs"][0][0]
    for key in ("psi", "probe", "scan"):
        H.assert_close(got[key], want[key], rtol=H.SLICE_TOL, atol=H.SLICE_TOL, scale=True)


def check_streamed_is_resident(runs):
    resident, streamed = runs["loop"], runs[False][0]
    assert resident["costs"] == streamed["costs"]
    for key in ("psi", "probe", "scan"):
        np.testing.assert_array_equal(resident[key], streamed[key])
