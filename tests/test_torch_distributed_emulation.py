"""The multi-process layout in one process, against tike_tpu's: rPIE, and
the layout's functions.

``Reconstruction(..., _force_stripes=2)`` on a mesh of 4 CPU shards lays
the patterns out as two processes would (``distributed.striped_batches``:
two stripes along the row coordinate, each batch's slots stripe after
stripe) and runs the same global program. tike_tpu's hook of that name on
4 of the conftest's virtual CPU devices is held to its own two-process run
by ``tests/parallel/test_distributed.py``; here the port's emulation is
held to tike_tpu's at ``_torch_parity.SLICE_TOL`` (1e-5 of the largest
value), rPIE, resident and host-streamed, on that test's problem
(``tests/parallel/_dist_worker.py``), and the port's streamed run to its
resident run bit for bit (``tests/_torch_dist_jax.py``). The layout's
functions are held to tike_tpu's exactly; LSQML is in
``tests/test_torch_distributed_emulation_lstsq.py``.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

import tike_tpu.parallel.distributed as jdist
import tike_tpu.parallel.striped as jstriped
import tike_tpu.ptycho as jp

import tike_tpu_torch.parallel as tpar
import tike_tpu_torch.parallel.distributed as tdist
import tike_tpu_torch.parallel.striped as tstriped
import tike_tpu_torch.ptycho as tp
from tike_tpu_torch import convert

from . import _torch_dist_jax as D
from .parallel._dist_worker import build_problem


@pytest.fixture(scope="module")
def problem():
    return build_problem()


@pytest.fixture(scope="module")
def runs(problem):
    return D.emulation_runs(problem, "rpie")


@pytest.mark.parametrize("store", [True, False], ids=["resident", "streamed"])
def test_force_stripes_matches_jax(runs, store):
    D.check_emulation(runs, store)


def test_force_stripes_streamed_is_resident_bit_for_bit(runs):
    D.check_streamed_is_resident(runs)


def test_force_stripes_refuses_a_mesh_it_does_not_divide(problem):
    with pytest.raises(ValueError, match="multiple of the process count"):
        with tp.Reconstruction(
            problem[0], convert.parameters_from_jax(D.emulation_parameters(jp, problem, "rpie")),
            mesh=tpar.make_mesh(devices=["cpu"] * 3), device="cpu", _force_stripes=2,
        ):
            pass


def _scan(seed=3, n=101):
    return np.random.default_rng(seed).uniform(0, 100, size=(n, 2)).astype(np.float32)


@pytest.mark.parametrize("procs", [1, 2, 3, 4])
def test_stripes_match_jax(procs):
    scan = _scan()
    for want, got in zip(jdist.stripe_indices(scan, procs), tdist.stripe_indices(scan, procs)):
        np.testing.assert_array_equal(got, want)
    data = np.arange(101 * 3.0).reshape(101, 3)
    for pid in range(procs):
        want = jdist.stripe_for_process(scan, data, num_processes=procs, process_id=pid)
        got = tdist.stripe_for_process(scan, data, num_processes=procs, process_id=pid)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            tdist.split_for_process(data, num_processes=procs, process_id=pid),
            jdist.split_for_process(data, num_processes=procs, process_id=pid),
        )


@pytest.mark.parametrize("method", ["compact", "wobbly_center"])
@pytest.mark.parametrize("procs, multiple", [(2, 2), (3, 1), (2, 4)])
def test_striped_batches_match_jax(procs, multiple, method):
    scan = _scan(5, 90)
    want = jdist.striped_batches(scan, procs, method, 3, np.random.default_rng(0), multiple)
    got = tdist.striped_batches(scan, procs, method, 3, np.random.default_rng(0), multiple)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for (ia, ma), (ib, mb) in zip(got[3], want[3]):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ma, mb)
    np.testing.assert_array_equal(got[4], want[4])


def test_striped_local_indices_and_multihost_rescale_match_jax(problem):
    """On one process's 4-shard mesh every stripe is this process's, in
    both packages; the multi-process rescale over this process's block
    equals tike_tpu's and the one-process estimate."""
    data, scan, probe, psi_shape = problem
    tmesh = tpar.make_mesh(devices=["cpu"] * 4)
    jmesh = JaxMesh(np.asarray(jax.devices()[:4]), ("batch",))
    got = tstriped.striped_local_indices(scan, psi_shape[-2:], probe.shape[-1], tmesh)
    want = jstriped.striped_local_indices(scan, psi_shape[-2:], probe.shape[-1], jmesh)
    np.testing.assert_array_equal(got, want)
    psi = np.full(psi_shape, 0.8 + 0j, np.complex64)
    rows = np.arange(0, len(scan), 2)
    args = (data[rows], rows, psi, probe, scan)
    got = tstriped.estimate_probe_rescale_multihost(*args, sample=16, rng=np.random.default_rng(1))
    want = jstriped.estimate_probe_rescale_multihost(*args, sample=16, rng=np.random.default_rng(1))
    assert got == want
    full = tstriped.estimate_probe_rescale_multihost(
        data, np.arange(len(scan)), psi, probe, scan, rng=np.random.default_rng(2)
    )
    assert full == tstriped.estimate_probe_rescale(data, psi, probe, scan, rng=np.random.default_rng(2))
