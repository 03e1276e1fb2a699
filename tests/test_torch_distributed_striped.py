"""The striped object across two processes.

Two gloo processes of ``tests/_torch_dist_worker.py`` (two CPU shards, so
two stripes, each; started once for the file) run
``Reconstruction(..., mesh=distributed.global_mesh(...),
object_sharding="striped")``, each from its
``striped.striped_local_indices`` patterns and without a seed: the JAX
package's two-process matrix for the striped object (the probe rescaled
from the processes' sampled patterns; streamed; every position in process
0's stripes, so that process 1 holds no pattern; LSQML with eigen weights
and position correction). The two processes agree bit for bit and equal one
process that runs the 4 stripes from seed 0; the costs fall.


The port's one-process run of each scenario is held to tike_tpu's at 1e-5
(``tests/_torch_dist_jax.py``, on the problem with a noise probe), but for
``striped_lstsq_opr_pos``: its stripes pad their batches, and tike_tpu
then drops the eigen-weight update of each position a padded slot repeats
(ROADMAP.md §3); ``tests/test_torch_striped.py::test_striped_opr_lstsq_matches_jax``
holds that path on stripes that need no padding."""

import numpy as np
import pytest

import tike_tpu_torch.parallel as tpar

from . import _torch_parity  # noqa: F401  (one intra-op thread)
from ._torch_dist_jax import check_scenario_against_jax
from ._torch_dist_worker import SCENARIOS, launch, run_scenario

NAMES = [s[0] for s in SCENARIOS if s[1] == "striped"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch(NAMES, tmp_path_factory.mktemp("dist"), timeout=120)


@pytest.mark.parametrize("name", NAMES)
def test_two_processes_are_one_process(ranks, name):
    r0, r1 = ranks
    one = run_scenario(name, tpar.make_mesh(devices=["cpu"] * 4), "cpu", True)
    for key, value in one.items():
        np.testing.assert_array_equal(r0[f"{name}/{key}"], r1[f"{name}/{key}"])
        np.testing.assert_array_equal(r0[f"{name}/{key}"], value)
    costs = one["costs"]
    assert np.all(np.isfinite(costs)) and costs[-1] < costs[0]
    calls, nbytes = r0[f"{name}/collectives"]
    assert calls > 0 and nbytes > 0


@pytest.mark.parametrize("name", ["striped_rpie", "striped_rpie_streamed", "striped_rpie_degenerate"])
def test_one_process_matches_jax(name):
    check_scenario_against_jax(name)
