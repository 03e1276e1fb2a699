"""The striped object (``object_sharding="striped"``) against tike_tpu's.

The port's striped ``Reconstruction`` on a mesh of k CPU shards against
tike_tpu's on ``make_mesh(k)`` (the conftest's virtual CPU devices), from
the same numpy inputs and seed: costs, psi, probe and the eigen state at
``_torch_parity.SLICE_TOL`` (1e-5 of the largest value), the tolerance of
the single-device slices (measured: 2.5e-7 to 4.3e-7 for psi after 3
epochs). 8 stripes of the 160-row object give hs = 20 and halo = 25, so
2 halo > hs and the seams overlap (the top seam is written last).

Then the cases of ``tests/parallel/test_striped.py`` that compare with the
replicated path, at tier-1 sizes: LSQML with 3 modes, rPIE through the
functional API and OPR, each also at tike_tpu's tolerance.
"""

import numpy as np
import pytest

import tike_tpu.parallel as jpar
import tike_tpu.parallel.striped as jstriped
import tike_tpu.ptycho as jp

import tike_tpu_torch.parallel as tpar
import tike_tpu_torch.parallel.striped as tstriped
import tike_tpu_torch.ptycho as tp
from tike_tpu_torch import convert

from . import _torch_parity as H
from . import _torch_striped_cases as C


def cpu_mesh(k: int) -> tpar.Mesh:
    return tpar.make_mesh(devices=["cpu"] * k)


run_both, check = C.run_both, C.check


@pytest.fixture(scope="module")
def one_mode():
    return C.problem(n=128)


@pytest.mark.parametrize("stripes", [2, 4, 8])
@pytest.mark.parametrize("solver", ["lstsq", "rpie"])
def test_striped_epochs_match_jax(one_mode, solver, stripes):
    psi, probe, scan, data = one_mode
    if stripes == 8:
        plan = tstriped.plan_stripes(scan, psi.shape[-2:], probe.shape[-1], stripes)
        assert 2 * plan.halo > plan.stripe_height
    jparams = C.parameters(jp, probe, C.start(psi), scan, solver)
    check(*run_both(data, jparams, stripes))


def test_one_striped_epoch_matches_jax(one_mode):
    psi, probe, scan, data = one_mode
    jparams = C.parameters(jp, probe, C.start(psi), scan, "rpie")
    check(*run_both(data, jparams, 4, epochs=1))


def test_striped_lstsq_three_modes_matches_jax_and_replicated():
    """``reconstruct(..., object_sharding="striped")`` with LSQML and 3
    modes on 8 stripes: tike_tpu's striped result at 1e-5, and the
    replicated port's within the reference test's bounds (interior
    correlation > 0.95, final cost < 2x + 0.05)."""
    psi, probe, scan, data = C.problem(n=128, nmodes=3)
    psi0 = C.start(psi)
    jparams = C.parameters(jp, probe, psi0, scan, "lstsq", algo=dict(num_batch=1))
    got, want = run_both(data, jparams, 8)
    check(got, want)
    replicated = tp.reconstruct(
        data, C.parameters(tp, probe, psi0, scan, "lstsq", algo=dict(num_batch=1)),
        device="cpu", random_seed=0,
    )
    r_costs = [c[0] for c in replicated.algorithm_options.costs]
    s_costs = [c[0] for c in got["costs"]]
    assert s_costs[-1] < s_costs[0]
    assert s_costs[-1] < 2.0 * max(r_costs[-1], 1e-3) + 0.05
    assert C.interior_correlation(got["psi"], replicated.psi) > 0.95
    assert got["probe"].shape == probe.shape


def test_reconstruct_striped_functional_api_matches_jax(one_mode):
    """``reconstruct_striped`` (rPIE, one batch, the functional API's
    default plan) on 8 stripes: psi, probe and costs against tike_tpu's."""
    psi, probe, scan, data = one_mode
    psi0 = C.start(psi)
    want = jstriped.reconstruct_striped(
        data, psi0, probe, scan, mesh=jpar.make_mesh(8), num_iter=3
    )
    got = tstriped.reconstruct_striped(data, psi0, probe, scan, mesh=cpu_mesh(8), num_iter=3)
    np.testing.assert_allclose(got[2], want[2], rtol=H.SLICE_TOL)
    for g, w in zip(got[:2], want[:2]):
        H.assert_close(g, np.asarray(w), rtol=H.SLICE_TOL, atol=H.SLICE_TOL, scale=True)
    assert got[2][-1] < got[2][0]


def _opr_parameters(pkg, psi, probe, scan, solver):
    n, m = scan.shape[0], probe.shape[-3]
    weights = np.zeros((n, 2, m), np.float32)
    weights[:, 0, :] = 1.0
    return C.parameters(
        pkg, probe, C.start(psi), scan, solver,
        eigen_probe=(0.01 * probe[:, :1, :1]).astype(np.complex64), eigen_weights=weights,
    )


def test_striped_opr_rpie_matches_jax():
    """An eigen probe and eigen weights (OPR) with rPIE on 4 stripes, 2
    modes: all fields, the eigen probe and the weights against tike_tpu's
    after 3 epochs (on the CPU: on the card, LAPACK's eigenvector phase
    decides, ROADMAP.md §3)."""
    psi, probe, scan, data = C.problem(n=128, nmodes=2)
    got, want = run_both(data, _opr_parameters(jp, psi, probe, scan, "rpie"), 4)
    check(got, want)
    assert got["eigen_weights"].shape == (scan.shape[0], 2, probe.shape[-3])


def test_striped_opr_lstsq_matches_jax():
    """OPR with LSQML on 4 stripes of 32 positions each and one batch a
    stripe, so that no batch is padded: 3 epochs against tike_tpu's at
    1e-5, the eigen weights included."""
    psi, probe, _, _ = C.problem(n=8, nmodes=2)
    gen = np.random.default_rng(5)
    hw, p = psi.shape[-1], probe.shape[-1]
    rows = [gen.uniform(max(40 * k + 0.5, 2), min(40 * k + 39.5, hw - p - 3), 32)
            for k in range(4)]
    scan = np.stack(
        [np.concatenate(rows), gen.uniform(2, hw - p - 3, 128)], -1
    ).astype(np.float32)
    data = tp.simulate(p, probe, scan, psi, device="cpu").astype(np.float32)
    jparams = _opr_parameters(jp, psi, probe, scan, "lstsq")
    jparams.algorithm_options.num_batch = 1
    got, want = run_both(data, jparams, 4)
    check(got, want)


def test_striped_opr_lstsq_padded_slots_drop_weights_in_jax():
    """OPR with LSQML on 4 stripes of unequal counts, one epoch. The
    stripes' batches are padded to a common length, and a padded slot
    repeats a real position: tike_tpu writes the weight rows back with
    ``.at[idx].set``, where the padded slot's stale copy wins and drops
    that position's update (ROADMAP.md §3, ``tests/test_torch_opr.py::
    test_padded_batches_update_every_eigen_weight``). The port writes
    through the real slots only: those positions' weights move in the port
    and keep their start in tike_tpu; the epoch's cost, taken before the
    writes, agrees at 1e-5. The padded slots enter LSQML's slot means, so
    the fields of the two packages part after the first batch."""
    psi, probe, scan, data = C.problem(n=128, nmodes=2)
    jparams = _opr_parameters(jp, psi, probe, scan, "lstsq")
    start = jparams.eigen_weights.copy()
    with jp.Reconstruction(data, jparams, mesh=jpar.make_mesh(4), object_sharding="striped",
                           random_seed=0) as context:
        context.iterate(1)
        want = convert.parameters_to_numpy(context.get_result())
    with tp.Reconstruction(data, convert.parameters_from_jax(_opr_parameters(
            jp, psi, probe, scan, "lstsq")), mesh=cpu_mesh(4), object_sharding="striped",
            random_seed=0, device="cpu") as context:
        state = context._striped
        repeated = set()
        for k, sel in enumerate(state.order):
            idx, mask = H.n(state.batch_idx[k]), H.n(state.batch_mask[k])
            if len(sel):
                repeated |= set(sel[idx[mask == 0]].tolist())
        context.iterate(1)
        got = convert.parameters_to_numpy(context.get_result())
    repeated = sorted(repeated)
    assert repeated
    np.testing.assert_array_equal(want["eigen_weights"][repeated], start[repeated])
    assert np.all(got["eigen_weights"][repeated, 1, 0] != start[repeated, 1, 0])
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=H.SLICE_TOL)
