"""Laminography across two processes.

Two gloo processes of ``tests/_torch_dist_worker.py`` (two CPU shards each,
started once for the file) run theta-split USFFT cgrad and CGLS, with the
Kaiser-Bessel window and (at cg_iter 1) the Gaussian, each process from its
contiguous run of the angles and projections
(``distributed.split_for_process``), and Bucket laminography with the
volume's x-slabs over both processes' shards. Each process's volume and
costs equal the other's and those of one process holding the 4 shards, bit
for bit, and the costs fall.
"""

import numpy as np
import pytest

import tike_tpu_torch.parallel as tpar

from . import _torch_parity  # noqa: F401  (one intra-op thread)
from ._torch_dist_worker import launch, run_scenario

LAMINO = [
    "lamino_cgrad_theta", "lamino_cgls_theta", "lamino_cgrad_theta_gaussian",
    "lamino_cgls_theta_gaussian", "lamino_bucket_volsplit",
]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch(LAMINO, tmp_path_factory.mktemp("dist"), timeout=120)


@pytest.mark.parametrize("name", LAMINO)
def test_lamino_across_two_processes_is_one_process(ranks, name):
    r0, r1 = ranks
    one = run_scenario(name, tpar.make_mesh(devices=["cpu"] * 4), "cpu", True)
    for key in ("psi", "costs"):
        np.testing.assert_array_equal(r0[f"{name}/{key}"], r1[f"{name}/{key}"])
        np.testing.assert_array_equal(r0[f"{name}/{key}"], one[key])
    costs = one["costs"]
    assert np.all(np.isfinite(costs)) and costs[-1] < costs[0]
    calls, nbytes = r0[f"{name}/collectives"]
    assert calls > 0 and nbytes > 0
