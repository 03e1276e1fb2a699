"""Data-parallel ptychography across two processes.

Two gloo processes of ``tests/_torch_dist_worker.py`` (two CPU shards each,
started once for the file) run ``tike_tpu_torch.ptycho.Reconstruction(...,
mesh=distributed.global_mesh(...))``, each from its
``distributed.stripe_for_process`` patterns: the JAX package's two-process
matrix (``scripts/_mp_suite_worker.py``) for the replicated object, with
LSQML, eigen probes and weights, position correction with the affine
regularization (the per-epoch path) and host streaming. The two processes
agree bit for bit, and equal one process that runs the same global program
on 4 CPU shards (``_force_stripes=2``), which
``tests/test_torch_distributed_emulation.py`` holds to tike_tpu's; the
costs fall, and the processes exchanged their parts.


The port's one-process run of each scenario is held to tike_tpu's at 1e-5
(``tests/_torch_dist_jax.py``, on the problem with a noise probe);
``dp_lstsq_opr_pos``, whose tike_tpu run takes its slow per-epoch path, is
held so in ``tests/test_torch_distributed_opr.py``."""

import numpy as np
import pytest

import tike_tpu_torch.parallel as tpar

from . import _torch_parity  # noqa: F401  (one intra-op thread)
from ._torch_dist_jax import check_scenario_against_jax
from ._torch_dist_worker import SCENARIOS, launch, run_scenario

NAMES = [s[0] for s in SCENARIOS if s[1] == "replicated"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch(NAMES, tmp_path_factory.mktemp("dist"), timeout=120)


@pytest.mark.parametrize("name", NAMES)
def test_two_processes_are_one_process(ranks, name):
    r0, r1 = ranks
    one = run_scenario(name, tpar.make_mesh(devices=["cpu"] * 4), "cpu", True)
    assert sorted(one) == sorted(k.split("/")[1] for k in r0 if k.startswith(name + "/")
                                 and not k.endswith("/collectives"))
    for key, value in one.items():
        np.testing.assert_array_equal(r0[f"{name}/{key}"], r1[f"{name}/{key}"])
        np.testing.assert_array_equal(r0[f"{name}/{key}"], value)
    costs = one["costs"]
    assert np.all(np.isfinite(costs)) and costs[-1] < costs[0]
    calls, nbytes = r0[f"{name}/collectives"]
    assert calls > 0 and nbytes > 0


@pytest.mark.parametrize("name", ["dp_rpie_compact", "dp_lstsq_wobbly", "dp_rpie_eigen", "dp_rpie_streamed"])
def test_one_process_matches_jax(name):
    check_scenario_against_jax(name)
