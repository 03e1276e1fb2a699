"""Two processes on the card: the data-parallel and striped layouts across
two gloo processes, each with one shard on ``cuda:0``, against one process
that runs the same global program on ``[cuda:0, cuda:0]`` (``chip_smoke.py``
phase 23a's check at the two-process matrix's size).

NCCL refuses two ranks on one card, so the processes use gloo, which the
collectives stage through page-locked host memory. The kernels are built
before the workers start, so that no two processes compile at once. Every
test here needs a CUDA card and ``nvcc``, is marked ``cuda``, and skips
without a card; whether there is one is decided inside the fixture, so
every worker collects the same tests. On a machine with a card, from the
root of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_distributed_cuda.py -q
"""

import numpy as np
import pytest
import torch

import tike_tpu_torch.parallel as tpar
from tike_tpu_torch import kernels

from ._torch_dist_worker import launch, run_scenario

pytestmark = pytest.mark.cuda

NAMES = ["dp_rpie_compact", "dp_lstsq_wobbly", "dp_rpie_streamed", "striped_rpie",
         "striped_rpie_degenerate", "lamino_cgrad_theta", "lamino_bucket_volsplit"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_all(["patch", "usfft", "bucket"])
    return launch(NAMES, tmp_path_factory.mktemp("dist"), device="cuda", local=1, timeout=300)


@pytest.mark.parametrize("name", NAMES)
def test_two_processes_on_the_card_are_one_process(ranks, name):
    r0, r1 = ranks
    one = run_scenario(name, tpar.make_mesh(devices=["cuda:0"] * 2), "cuda", True)
    for key, value in one.items():
        np.testing.assert_array_equal(r0[f"{name}/{key}"], r1[f"{name}/{key}"])
        if name == "lamino_bucket_volsplit":
            # The Bucket forward's float atomics are not repeatable in the
            # last bits (ROADMAP.md §3), and 4 outer iterations carry that:
            # held at the golden protocol's 1e-3 of the largest value (1.5e-4
            # measured on the H100 for the volume).
            scale = np.max(np.abs(value))
            np.testing.assert_allclose(r0[f"{name}/{key}"], value, rtol=1e-3, atol=1e-3 * scale)
        else:
            np.testing.assert_array_equal(r0[f"{name}/{key}"], value)
    costs = one["costs"]
    assert np.all(np.isfinite(costs)) and costs[-1] < costs[0]
