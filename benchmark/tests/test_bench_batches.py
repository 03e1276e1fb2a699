"""The benchmark's own compact batches: the same as the program's from
the same scan and seed, and the check counts a program batching otherwise
as a fault."""

import json

import numpy as np
import pytest

import tiny
from families import ptycho as family
from reference import batches

CELLS = [w["name"] for w in json.loads((tiny.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("n, k, seed", [(48, 4, 1), (203, 7, 2**31 + 3), (1001, 10, 5), (2500, 10, 0)])
def test_own_batches_are_the_program_s(n, k, seed):
    from tike_tpu_torch import cluster

    scan = np.random.default_rng(seed).uniform(2, 300, (n, 2)).astype(np.float32)
    want = cluster.compact(scan, k, rng=np.random.default_rng(seed))
    got = batches.compact(scan, k, seed)
    assert len(got) == len(want) == k
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_own_batches_partition_the_scan():
    scan = np.random.default_rng(4).uniform(0, 50, (97, 2))
    got = batches.compact(scan, 6, 4)
    assert sorted(len(b) for b in got) == [16] * 5 + [17]
    assert np.array_equal(np.sort(np.concatenate(got)), np.arange(97))


@pytest.mark.parametrize("workload", CELLS[:1])
def test_program_batching_otherwise_is_not_correct(workload):
    spec = tiny.spec(workload)
    session = family.setup(spec["config"], spec["traffic"], 6, "cpu", spec["limits"])
    session.close()
    assert session.check()["schedule_faults"]["value"] == 0
    first, second = session.program_batches[:2]
    session.program_batches[0] = np.sort(np.concatenate([first[1:], second[:1]]))
    session.program_batches[1] = np.sort(np.concatenate([second[1:], first[:1]]))
    numbers = session.check()
    assert numbers["schedule_faults"]["value"] == 2
    assert numbers["correct"] is False
