"""``tike_tpu_torch.parallel.distributed`` in two processes.

Two gloo processes of ``tests/_torch_dist_worker.py``, two CPU shards each,
started once for the file: the module's functions across them (a second
``initialize`` is a no-op, the shapes and owners of ``global_mesh`` and
``dcn_mesh``, the placements and their fetch, a reduction, the batch-major
data placed (``make_global_batch_data``) and streamed
(``HostStreamedBatches``) from each process's block, unequal device counts
refused, ``halo.swap_edges`` of both processes' stripes, which
equals one process's on the 4 shards). The backend's choice and the
single-process fallback run here in one process.
"""

import numpy as np
import pytest
import torch

import tike_tpu_torch.parallel as tpar
import tike_tpu_torch.parallel.distributed as tdist
import tike_tpu_torch.parallel.halo as thalo

from . import _torch_parity  # noqa: F401  (one intra-op thread)
from ._torch_dist_worker import launch


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch(["api"], tmp_path_factory.mktemp("dist"), timeout=120)


def test_api_across_two_processes(ranks):
    whole = np.arange(2 * 2 * 6.0).reshape(8, 3)
    for r in ranks:
        np.testing.assert_array_equal(r["api/fetched"], whole)
        np.testing.assert_array_equal(r["api/replicated"], whole)
        np.testing.assert_array_equal(
            r["api/summed"], whole.reshape(4, 2, 3).sum(1).sum(0)
        )
        assert "same number of devices" in str(r["api/refused"])
        np.testing.assert_array_equal(
            r["api/batches"], np.arange(2 * 4 * 3 * 2.0).reshape(2, 12, 2)
        )
    psi = torch.arange(2 * 4 * 4 * 3.0).reshape(1, 16, 6)
    one = tpar.make_mesh(devices=["cpu"] * 4)
    want = tpar.fetch_global(thalo.swap_edges(tpar.put(psi, tpar.batch_sharding(one, axis=1)),
                                              one, 2), axis=1)
    for r in ranks:
        np.testing.assert_array_equal(r["api/swapped"], want)


def test_initialize_without_a_group_stays_single(monkeypatch, caplog):
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    with caplog.at_level("INFO", logger=tdist.__name__):
        tdist.initialize()
    assert not torch.distributed.is_initialized()
    assert "single-process mode" in caplog.text
    assert tdist.process_count() == 1 and tdist.process_index() == 0
    assert tdist.gather_objects(3) == [3]
    mesh = tdist.global_mesh(local_devices=["cpu", "cpu"])
    assert mesh.flat == [torch.device("cpu")] * 2 and mesh.process_count == 1
    assert tdist.dcn_mesh(local_devices=["cpu"]).shape == {"dcn": 1, "ici": 1}


def test_backend_and_card_selection(monkeypatch):
    """NCCL where CUDA is available (one rank a card, the card of
    ``LOCAL_RANK``), gloo on the CPU; ``backend=`` overrides."""
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.append(("card", i)))
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tdist.default_backend() == "nccl"
    tdist.initialize("localhost:1234", 4, 3)
    assert calls[0] == dict(backend="nccl", world_size=4, rank=3,
                            init_method="tcp://localhost:1234")
    assert calls[1] == ("card", 3)
    assert tdist._local_devices(None) == [torch.device("cuda", 3)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tdist.default_backend() == "gloo"
    tdist.initialize("localhost:1234", 2, 0, backend="gloo")
    assert calls[2]["backend"] == "gloo" and len(calls) == 3
    with pytest.raises(RuntimeError, match="local_devices="):
        tdist._local_devices(None)


def test_a_mesh_needs_a_shard_of_this_process():
    with pytest.raises(ValueError, match="at least one shard"):
        tpar.Mesh([tpar.Remote(1, "cpu")])
