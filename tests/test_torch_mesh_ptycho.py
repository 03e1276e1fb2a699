"""Data-parallel ptychography on a mesh: the port's ``mesh=`` against
tike_tpu's on a mesh of the same size (the conftest's virtual CPU
devices), where the padding of the batches to a multiple of the mesh's
size is the same; a one-shard mesh against no mesh, bit for bit; and
``num_gpu``/``use_mpi``, accepted and not read in both packages.

The same numpy inputs from a seed go to both packages; each test states
its tolerance (``_torch_parity.SLICE_TOL``, 1e-5 of the largest value,
that of the single-device slices, unless it says otherwise).
"""

import numpy as np
import pytest
import torch

import tike_tpu.ptycho as jp
import tike_tpu.parallel as jpar

import tike_tpu_torch.parallel as tpar
import tike_tpu_torch.ptycho as tp
from tike_tpu_torch import convert

from . import _torch_parity as H

Hh, P, DET, NPOS = 160, 16, 24, 120


@pytest.fixture(scope="module")
def slice_data():
    scan, psi, probe, psi0 = H.slice_inputs(h=Hh, p=P, det=DET, npos=NPOS)
    data = np.asarray(jp.simulate(DET, probe, scan, psi))
    return scan, probe, psi0, data


def cpu_mesh(size: int) -> tpar.Mesh:
    return tpar.make_mesh(devices=["cpu"] * size)


def run(pkg, data, params, epochs, **kwargs):
    """``epochs`` of ``pkg.Reconstruction`` from ``params`` (seed 0), as
    ``convert.parameters_to_numpy``, and whether the fused path ran."""
    if pkg is tp:
        kwargs.setdefault("device", "cpu")
    with pkg.Reconstruction(data, params, random_seed=0, **kwargs) as context:
        fused = context._fused_eligible()
        context.iterate(epochs)
        return convert.parameters_to_numpy(context.get_result()), fused


@pytest.mark.parametrize(
    "case", ["lstsq_compact_checked", "lstsq_wobbly_momentum", "rpie_eigen"]
)
def test_fused_mesh_of_8_matches_jax(slice_data, case):
    """LSQML and rPIE through ``Reconstruction``'s fused path on 8 shards,
    against tike_tpu's on ``make_mesh(8)``: costs, fields, eigen and moment
    states at the single-device slices' tolerances
    (``_torch_parity.check_fused_slice``: 1e-5, moments 1e-4)."""
    scan, probe, psi0, data = slice_data
    data = H.fused_case_data(data, case)
    jparams = H.fused_parameters(jp, scan, probe, psi0, case, DET)
    tparams = convert.parameters_from_jax(jparams)
    want, jfused = run(jp, data, jparams, 3, mesh=jpar.make_mesh(8))
    got, fused = run(tp, data, tparams, 3, mesh=cpu_mesh(8))
    assert fused and jfused
    H.check_fused_slice(got, want, case)


def test_padding_to_the_mesh_moves_lstsq_as_in_jax(slice_data):
    """4 batches of 30 positions pad to 32 slots on 8 shards: the padded
    slots' step-size terms enter LSQML's slot means in both packages, so
    the mesh moves the result away from no mesh by more than rounding, and
    the port's mesh matches tike_tpu's of the same size (1e-5)."""
    scan, probe, psi0, data = slice_data
    case = "lstsq_compact_checked"
    jparams = H.fused_parameters(jp, scan, probe, psi0, case, DET)
    jparams.algorithm_options.num_batch = 4
    single, _ = run(tp, data, convert.parameters_from_jax(jparams), 3)
    got, _ = run(tp, data, convert.parameters_from_jax(jparams), 3, mesh=cpu_mesh(8))
    want, _ = run(jp, data, jparams, 3, mesh=jpar.make_mesh(8))
    H.check_fused_slice(got, want, case)
    assert not np.allclose(got["costs"], single["costs"], rtol=1e-6, atol=0)


@pytest.mark.parametrize("which", ["position", "eigen"])
def test_per_epoch_mesh_of_4_matches_jax(slice_data, monkeypatch, which):
    """The per-epoch path on 4 shards against tike_tpu's on ``make_mesh(4)``:
    LSQML with position correction and its affine regularization (each
    package's fit drawing from the same generator), and LSQML with an eigen
    probe and a finite ``time_limit``; 2 epochs at 1e-5, positions within
    1e-4 px."""
    scan, probe, psi0, data = slice_data
    H.seed_jax_position_fit(monkeypatch)
    if which == "position":
        jparams = H.epoch_loop_parameters(
            jp, scan, probe, psi0, "lstsq", dict(batch_method="compact"),
            position=dict(use_position_regularization=True),
        )
    else:
        jparams = H.fused_parameters(jp, scan, probe, psi0, "rpie_eigen", DET)
        jparams.algorithm_options = jp.LstsqOptions(
            num_batch=3, rescale_period=2, batch_method="compact", time_limit=1e9
        )
    tparams = convert.parameters_from_jax(jparams)
    want, jfused = run(jp, data, jparams, 2, mesh=jpar.make_mesh(4))
    got, fused = run(tp, data, tparams, 2, mesh=cpu_mesh(4))
    assert not fused and not jfused
    H.check_epoch_run(got, want)


@pytest.mark.filterwarnings("ignore:Cropping diffraction patterns")
def test_multigrid_on_a_mesh_matches_jax(slice_data):
    """``reconstruct_multigrid`` with a mesh of 4 at two levels (one batch,
    which the JAX package's unseeded clustering draws nothing for; the
    Lanczos probe resize, with which the single-device multigrid agrees at
    1e-5, ``tests/test_torch_multigrid.py``), against tike_tpu's on
    ``make_mesh(4)``: 1e-5 of the largest value."""
    import tike_tpu.ptycho.solvers.options as jopts
    import tike_tpu_torch.ptycho.solvers.options as topts

    scan, probe, psi0, data = slice_data
    jparams = H.epoch_loop_parameters(
        jp, scan, probe, psi0, "lstsq", dict(batch_method="compact", num_batch=1, num_iter=2)
    )
    tparams = convert.parameters_from_jax(jparams)
    want = convert.parameters_to_numpy(
        jp.reconstruct_multigrid(
            data, jparams, num_levels=2, interp=jopts._resize_lanczos, mesh=jpar.make_mesh(4)
        )
    )
    got = convert.parameters_to_numpy(
        tp.reconstruct_multigrid(
            data, tparams, num_levels=2, interp=topts._resize_lanczos, mesh=cpu_mesh(4),
            device="cpu", random_seed=0,
        )
    )
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=H.SLICE_TOL)
    for key in ("psi", "probe", "scan"):
        H.assert_close(got[key], want[key], rtol=H.SLICE_TOL, atol=H.SLICE_TOL, scale=True)


@pytest.mark.parametrize("case", ["lstsq_wobbly_momentum", "rpie_eigen"])
def test_one_shard_mesh_is_no_mesh_bit_for_bit(slice_data, case):
    """With nothing to reduce the mesh adds nothing: a mesh of one CPU
    shard gives the bits of ``mesh=None``, on the fused and the per-epoch
    path (position correction with the affine fit)."""
    scan, probe, psi0, data = slice_data
    params = convert.parameters_from_jax(H.fused_parameters(jp, scan, probe, psi0, case, DET))
    none, _ = run(tp, data, params, 2)
    one, _ = run(tp, data, params, 2, mesh=cpu_mesh(1))
    params.position_options = tp.PositionOptions(
        initial_scan=scan, use_position_regularization=True
    )
    none_pe, fused_pe = run(tp, data, params, 2)
    one_pe, _ = run(tp, data, params, 2, mesh=cpu_mesh(1))
    assert not fused_pe or case.startswith("rpie")
    for a, b in ((one, none), (one_pe, none_pe)):
        assert a["costs"] == b["costs"]
        for key in ("psi", "probe", "scan", "eigen_probe", "eigen_weights"):
            if b[key] is None:
                assert a[key] is None
            else:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.filterwarnings("ignore:Cropping diffraction patterns")
def test_num_gpu_and_use_mpi_are_accepted_and_not_read(slice_data):
    """``num_gpu=2, use_mpi=True`` and ``num_gpu=1`` give the same bits,
    and match tike_tpu's run with the same arguments (1e-5), through
    ``reconstruct`` and ``reconstruct_multigrid``."""
    scan, probe, psi0, data = slice_data
    case = "lstsq_wobbly_momentum"
    jparams = H.fused_parameters(jp, scan, probe, psi0, case, DET)
    jparams.algorithm_options.num_iter = 2
    out = {}
    for kw in (dict(num_gpu=2, use_mpi=True), dict(num_gpu=1)):
        key = tuple(kw.items())
        out[key] = convert.parameters_to_numpy(
            tp.reconstruct(data, convert.parameters_from_jax(jparams), device="cpu",
                           random_seed=0, **kw)
        )
    a, b = out.values()
    assert a["costs"] == b["costs"]
    for key in ("psi", "probe", "scan"):
        np.testing.assert_array_equal(a[key], b[key])
    with jp.Reconstruction(data, jparams, 2, True, random_seed=0) as context:
        context.iterate(2)
        want = convert.parameters_to_numpy(context.get_result())
    np.testing.assert_allclose(a["costs"], want["costs"], rtol=H.SLICE_TOL)
    for key in ("psi", "probe"):
        H.assert_close(a[key], want[key], rtol=H.SLICE_TOL, atol=H.SLICE_TOL, scale=True)
    grid = dict(num_levels=1, device="cpu", random_seed=0)
    np.testing.assert_array_equal(
        tp.reconstruct_multigrid(data, convert.parameters_from_jax(jparams), 2, True, **grid).psi,
        tp.reconstruct_multigrid(data, convert.parameters_from_jax(jparams), 1, False, **grid).psi,
    )


def test_what_a_mesh_still_refuses(slice_data):
    """A mesh that is not a ``parallel.Mesh``, and a device of another type
    than the mesh's, raise before anything runs."""
    scan, probe, psi0, data = slice_data
    params = convert.parameters_from_jax(
        H.fused_parameters(jp, scan, probe, psi0, "lstsq_wobbly_momentum", DET)
    )
    with pytest.raises(TypeError, match="parallel.Mesh"):
        tp.Reconstruction(data, params, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="cpu devices"):
        tp.Reconstruction(data, params, mesh=cpu_mesh(2))
    assert torch.device("cpu") == cpu_mesh(2).flat[1]
