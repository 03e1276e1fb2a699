"""Host streaming on a one-process mesh (``store_data_on_device=False``
with ``mesh=``): each shard's run of the batch's slots copied from the
host to its device, batch by batch.

The port's streamed mesh against its resident mesh on the same path (the
per-epoch loop, which streaming takes, forced on the resident run by a
finite ``time_limit``): bit for bit. And against tike_tpu's streamed mesh
of the same size on the conftest's virtual CPU devices, from the same
seed: ``_torch_parity.SLICE_TOL`` (1e-5 of the largest value), the
tolerance of the single-device slices.
"""

import numpy as np
import pytest

import tike_tpu.parallel as jpar
import tike_tpu.ptycho as jp

import tike_tpu_torch.parallel as tpar
import tike_tpu_torch.ptycho as tp
from tike_tpu_torch import convert
from tike_tpu_torch.ptycho.solvers.epoch import ShardedBatches
from tike_tpu_torch.ptycho.stream import StreamedBatches

from . import _torch_parity as H

Hh, P, DET, NPOS = 160, 16, 24, 120

CASES = {
    "rpie": ("rpie", dict(batch_method="wobbly_center")),
    "lstsq": ("lstsq", dict(batch_method="compact")),
}


@pytest.fixture(scope="module")
def slice_data():
    scan, psi, probe, psi0 = H.slice_inputs(h=Hh, p=P, det=DET, npos=NPOS)
    data = np.asarray(jp.simulate(DET, probe, scan, psi))
    return scan, probe, psi0, data


def _params(pkg, slice_data, case, **algo):
    scan, probe, psi0, _ = slice_data
    solver, batching = CASES[case]
    return H.epoch_loop_parameters(pkg, scan, probe, psi0, solver, {**batching, **algo})


def _run(pkg, data, params, mesh, store, epochs=2):
    kw = dict(device="cpu") if pkg is tp else {}
    with pkg.Reconstruction(
        data, params, mesh=mesh, store_data_on_device=store, random_seed=0, **kw
    ) as context:
        assert not context._fused_eligible()
        if pkg is tp and store is False:
            assert isinstance(context.data, ShardedBatches)
            assert all(isinstance(d, StreamedBatches) for d in context.data.data)
        context.iterate(epochs)
        return convert.parameters_to_numpy(context.get_result())


@pytest.mark.parametrize("case", sorted(CASES))
def test_streamed_mesh_is_the_resident_mesh_bit_for_bit(slice_data, case):
    data = slice_data[3]
    mesh = tpar.make_mesh(devices=["cpu"] * 4)
    streamed = _run(tp, data, convert.parameters_from_jax(_params(jp, slice_data, case)),
                    mesh, False)
    resident = _run(
        tp, data,
        convert.parameters_from_jax(_params(jp, slice_data, case, time_limit=1e9)),
        mesh, True,
    )
    assert streamed["costs"] == resident["costs"]
    for key in ("psi", "probe", "scan"):
        np.testing.assert_array_equal(streamed[key], resident[key])


@pytest.mark.parametrize("case", sorted(CASES))
def test_streamed_mesh_matches_jax(slice_data, case):
    data = slice_data[3]
    jparams = _params(jp, slice_data, case)
    tparams = convert.parameters_from_jax(jparams)
    want = _run(jp, data, jparams, jpar.make_mesh(4), False)
    got = _run(tp, data, tparams, tpar.make_mesh(devices=["cpu"] * 4), False)
    H.check_epoch_run(got, want)
