"""The striped object's host geometry, its set-up and its host streaming.

Against tike_tpu, exactly: ``plan_stripes``, ``stitch``,
``estimate_probe_rescale`` (rtol 1e-12: the same numpy operations) and
the stripes' layout from ``setup_striped_full`` (batch orders, padded
batches, local positions, masks and psi windows) from the same seeded
generator. The halo cross-fade where the seams overlap (2 halo > hs), as
the JAX package's striped epoch writes it. Then host streaming
(``store_data_on_device=False``): the port's streamed stripes against its
resident stripes, bit for bit, and against tike_tpu's streamed stripes at
``_torch_parity.SLICE_TOL`` (1e-5 of the largest value).
"""

import numpy as np
import pytest
import torch

import tike_tpu.parallel as jpar
import tike_tpu.parallel.striped as jstriped
import tike_tpu.ptycho as jp

import tike_tpu_torch.parallel as tpar
import tike_tpu_torch.parallel.striped as tstriped
import tike_tpu_torch.ptycho as tp
from tike_tpu_torch import convert
from tike_tpu_torch.parallel.halo import cross_fade
from tike_tpu_torch.ptycho.stream import StreamedBatches

from . import _torch_parity as H
from . import _torch_striped_cases as C


@pytest.fixture(scope="module")
def one_mode():
    return C.problem(n=128)


@pytest.mark.parametrize("ndev", [1, 3, 8])
def test_plan_stitch_and_rescale_match_jax(one_mode, ndev):
    psi, probe, scan, data = one_mode
    want = jstriped.plan_stripes(scan, psi.shape[-2:], probe.shape[-1], ndev)
    got = tstriped.plan_stripes(scan, psi.shape[-2:], probe.shape[-1], ndev)
    for field in ("ndev", "stripe_height", "halo", "local_height", "width", "capacity"):
        assert getattr(got, field) == getattr(want, field), field
    np.testing.assert_array_equal(got.assignment, want.assignment)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.counts.sum() == len(scan)
    windows = H.crandn(H.rng(ndev), ndev, 1, got.local_height, psi.shape[-1])
    np.testing.assert_array_equal(
        tstriped.stitch(got, windows, psi.shape[-2]), jstriped.stitch(want, windows, psi.shape[-2])
    )
    for sample in (64, 256):
        np.testing.assert_allclose(
            tstriped.estimate_probe_rescale(
                data, psi, probe, scan, sample, rng=np.random.default_rng(5)
            ),
            jstriped.estimate_probe_rescale(
                data, psi, probe, scan, sample, rng=np.random.default_rng(5)
            ),
            rtol=1e-12,
        )
    idx = np.flatnonzero(got.assignment == 0)
    np.testing.assert_array_equal(
        tstriped.local_row_lookup(len(scan), idx), jstriped.local_row_lookup(len(scan), idx)
    )


@pytest.mark.parametrize("batch_method", ["compact", "wobbly_center"])
def test_stripe_layout_matches_jax(one_mode, batch_method):
    """``setup_striped_full`` on 4 stripes, positions clustered within each
    stripe from one seeded generator: the same layout, bit for bit."""
    psi, probe, scan, data = one_mode
    want = jstriped.setup_striped_full(
        data, psi, probe, scan, mesh=jpar.make_mesh(4), epoch_plan=jstriped._default_plan("rpie", "gaussian", 0.05, 3),
        batch_method=batch_method, num_batch=3, rng=np.random.default_rng(2),
    )
    got = tstriped.setup_striped_full(
        data, psi, probe, scan, mesh=tpar.make_mesh(devices=["cpu"] * 4),
        epoch_plan=tstriped._default_plan("rpie", "gaussian", 0.05, 3),
        batch_method=batch_method, num_batch=3, rng=np.random.default_rng(2),
    )
    for g, w in zip(got.order, want.order):
        np.testing.assert_array_equal(g, w)
    fetch = jpar.fetch_global
    np.testing.assert_array_equal(np.stack(got.batch_idx), fetch(want.batch_idx))
    np.testing.assert_array_equal(np.stack(got.batch_mask), fetch(want.batch_mask))
    np.testing.assert_array_equal(np.stack([s.scan for s in got.states]), fetch(want.scan))
    np.testing.assert_array_equal(np.stack([c.pos_mask for c in got.comms]), fetch(want.pos_mask))
    np.testing.assert_array_equal(np.stack([c.row_mask for c in got.comms]), fetch(want.row_mask))
    np.testing.assert_array_equal(np.stack([s.psi for s in got.states]), fetch(want.psi))
    np.testing.assert_array_equal(np.stack(got.data), fetch(want.data))
    assert got.epoch_plan.cfg.nz == want.epoch_plan.cfg.nz == got.plan.local_height


def test_cross_fade_writes_the_top_seam_last():
    """Three stripes of hs = 4 rows with halo = 3 (2 halo > hs): the blend
    the JAX package's striped epoch writes (bottom seam, then top seam),
    in numpy, against ``halo.cross_fade``; where the seams overlap the
    top seam's rows win."""
    hs, halo, size = 4, 3, 3
    gen = H.rng(11)
    windows = [H.crandn(gen, 1, hs + 2 * halo, 5) for _ in range(size)]
    w2 = 2 * halo
    seams = np.stack([np.stack([w[:, :w2], w[:, hs : hs + w2]]) for w in windows])
    ramp = np.linspace(0.0, 1.0, w2 + 2, dtype=np.float32)[1:-1][None, :, None]
    for i, w in enumerate(windows):
        want = w.copy()
        bot, top = w[:, hs : hs + w2], w[:, :w2]
        if i < size - 1:
            want[:, hs : hs + w2] = (1 - ramp) * bot + ramp * windows[i + 1][:, :w2]
        want[:, :w2] = (1 - ramp) * windows[i - 1][:, hs : hs + w2] + ramp * top if i else top
        got = cross_fade(torch.as_tensor(w), torch.as_tensor(seams), i, hs, halo)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _stream_parameters(pkg, psi, probe, scan, solver, eigen=True):
    """``tests/parallel/test_striped.py``'s streamed case: 3 compact
    batches; LSQML with position correction and (``eigen``) an eigen
    probe."""
    fields = {}
    if solver == "lstsq":
        fields["position_options"] = pkg.PositionOptions(
            initial_scan=scan, update_magnitude_limit=0.2
        )
    if solver == "lstsq" and eigen:
        n, m = scan.shape[0], probe.shape[-3]
        weights = np.zeros((n, 2, m), np.float32)
        weights[:, 0, :] = 1.0
        fields["eigen_probe"] = (0.01 * probe[:, :1, :1]).astype(np.complex64)
        fields["eigen_weights"] = weights
    return C.parameters(pkg, probe, C.start(psi), scan, solver, algo=dict(num_batch=3), **fields)


@pytest.fixture(scope="module")
def two_modes():
    return C.problem(n=160, nmodes=2)


@pytest.mark.parametrize("solver", ["rpie", "lstsq"])
def test_streamed_stripes_are_resident_stripes_bit_for_bit(two_modes, solver):
    psi, probe, scan, data = two_modes
    out = []
    for store in (True, False):
        params = convert.parameters_from_jax(_stream_parameters(jp, psi, probe, scan, solver))
        with tp.Reconstruction(
            data, params, mesh=tpar.make_mesh(devices=["cpu"] * 4), object_sharding="striped",
            store_data_on_device=store, random_seed=0, device="cpu",
        ) as context:
            assert all(isinstance(d, StreamedBatches) != store for d in context.data)
            context.iterate(3)
            out.append(convert.parameters_to_numpy(context.get_result()))
    resident, streamed = out
    assert streamed["costs"] == resident["costs"]
    for key in ("psi", "probe", "scan", "eigen_probe", "eigen_weights"):
        if resident[key] is None:
            continue
        np.testing.assert_array_equal(streamed[key], resident[key])


@pytest.mark.parametrize("solver", ["rpie", "lstsq"])
def test_streamed_stripes_match_jax(two_modes, solver):
    """Without the eigen probe: the stripes' padded batches make tike_tpu
    drop LSQML's eigen-weight updates of the positions a padded slot
    repeats (``test_torch_striped.py::
    test_striped_opr_lstsq_padded_slots_drop_weights_in_jax``)."""
    psi, probe, scan, data = two_modes
    got, want = C.run_both(
        data, _stream_parameters(jp, psi, probe, scan, solver, eigen=False), 4,
        store_data_on_device=False,
    )
    C.check(got, want)
