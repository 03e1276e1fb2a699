"""Host streaming (``store_data_on_device=False``) of the port on the CPU.

The batch-major data stays on the host and the solver takes one batch at a
time from a ``StreamedBatches``. The kernels, their order and their inputs
are those of a resident run, so the port's streamed run must equal its own
resident run bit for bit (on the card a difference would mean a race
between the copy stream and the compute stream; here it holds the plumbing
to that standard). Against tike_tpu's streamed run (its double-buffered
per-epoch loop) the port agrees as the per-epoch path does elsewhere: 1e-5
on the synthetic slice and, on the measured siemens-star subset with its
constant start, within the reference's own one-ulp sensitivity.
"""

import numpy as np
import pytest
import torch

import tike_tpu.ptycho as jp

import tike_tpu_torch.ptycho as tp
from tike_tpu_torch import convert
from tike_tpu_torch.ptycho import stream

from . import _torch_parity as H
from .ptycho.templates import siemens_star_subset

Hh, P, DET, NPOS = 160, 16, 24, 120


@pytest.fixture(scope="module")
def slice_data():
    scan, psi, probe, psi0 = H.slice_inputs(h=Hh, p=P, det=DET, npos=NPOS)
    data = np.asarray(jp.simulate(DET, probe, scan, psi))
    return scan, probe, psi0, data


def _run_port(data, params, store, epochs=3):
    with tp.Reconstruction(
        data, params, device="cpu", random_seed=0, store_data_on_device=store
    ) as context:
        streamed = isinstance(context.data, stream.StreamedBatches)
        assert streamed == (store is False)
        if streamed:
            # The data lives on the host, batch-major, as float32.
            host = context.data.host
            assert host.device.type == "cpu" and host.dtype == torch.float32
            assert host.shape[0] == params.algorithm_options.num_batch
        context.iterate(epochs)
        return convert.parameters_to_numpy(context.get_result())


STREAM_CASES = {
    "rpie_random": ("rpie", dict(batch_method="random")),
    "rpie_compact": ("rpie", dict(batch_method="compact")),
    "rpie_wobbly_7_batches": ("rpie", dict(batch_method="wobbly_center", num_batch=7)),
    "lstsq_compact": ("lstsq", dict(batch_method="compact")),
    "lstsq_wobbly_2_batches": ("lstsq", dict(batch_method="wobbly_center", num_batch=2)),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_streamed_equals_resident_bitwise(slice_data, case):
    """Same seed, same batches, same order: the same bits, whether the
    batch comes from the resident tensor or from the host. The resident run
    is put on the per-epoch path too (a finite ``time_limit``), which is
    the path a streamed run takes."""
    scan, probe, psi0, data = slice_data
    solver, algo = STREAM_CASES[case]
    runs = []
    for store in (True, False):
        params = H.epoch_loop_parameters(
            tp, scan, probe, psi0, solver, dict(time_limit=1e6, **algo)
        )
        runs.append(_run_port(data, params, store))
    resident, streamed = runs
    assert streamed["costs"] == resident["costs"]
    for key in ("psi", "probe", "scan"):
        np.testing.assert_array_equal(streamed[key], resident[key])


@pytest.mark.parametrize("case", ["rpie_random", "lstsq_compact"])
def test_streamed_slice_matches_jax_streamed(slice_data, case):
    scan, probe, psi0, data = slice_data
    solver, algo = STREAM_CASES[case]
    jparams = H.epoch_loop_parameters(jp, scan, probe, psi0, solver, algo)
    got, want = H.run_both_packages(data, jparams, 3, fused=False, store=False)
    assert got["costs"][-1][0] < got["costs"][0][0]
    H.check_epoch_run(got, want)


def test_streamed_rescale_equals_resident(slice_data):
    """``init_rescale_from_measurements`` sums over the batches at set-up
    and streams them too: the same scale, bit for bit."""
    scan, probe, psi0, data = slice_data
    probes = []
    for store in (True, False):
        params = H.epoch_loop_parameters(
            tp, scan, 3.0 * probe, psi0, "rpie", dict(batch_method="compact")
        )
        assert params.probe_options.init_rescale_from_measurements
        with tp.Reconstruction(
            data, params, device="cpu", random_seed=0, store_data_on_device=store
        ) as context:
            probes.append(context.get_result().probe)
    np.testing.assert_array_equal(probes[1], probes[0])
    assert np.max(np.abs(probes[0] - 3.0 * probe)) > 0.1  # it was rescaled


def _siemens_parameters(pkg, scan, probe, psi):
    """The options of tike_tpu's own streaming test on this subset."""
    return pkg.PtychoParameters(
        psi=psi.copy(),
        probe=probe.copy(),
        scan=scan.copy(),
        algorithm_options=pkg.RpieOptions(num_iter=3, num_batch=3, batch_method="compact"),
        object_options=pkg.ObjectOptions(),
        probe_options=pkg.ProbeOptions(init_rescale_from_measurements=False),
    )


def test_streamed_siemens_subset_matches_jax_streamed():
    """96 measured patterns, 5 probe modes, streamed in both packages.

    The constant 0.5 start leaves far-field pixels modeled near 0, where
    the Gaussian gradient carries float32 rounding (ROADMAP.md §3), and
    without the initial rescale the second epoch's cost jumps by 4 orders
    in both packages. So costs, psi and probe are held to 1e-5 or, where
    that fails, to the reference's own sensitivity: within twice what one
    float32 ulp on the reference's start moves the reference (measured:
    costs 3.2e-7, psi 2.2e-6, probe 1.07e-5 against 8.8e-6 of its own)."""
    data, scan, probe, psi = siemens_star_subset(n_keep=96)
    probe = np.asarray(probe).astype(np.complex64)

    def run_jax(probe, psi):
        with jp.Reconstruction(
            data, _siemens_parameters(jp, scan, probe, psi), random_seed=0,
            store_data_on_device=False,
        ) as context:
            assert isinstance(context.data, np.ndarray)  # host-resident
            assert not context._fused_eligible()
            context.iterate(3)
            return convert.parameters_to_numpy(context.get_result())

    want = run_jax(probe, psi)
    gen = H.rng(1)
    nudged = run_jax(H.one_ulp(gen, probe), H.one_ulp(gen, psi))
    tparams = convert.parameters_from_jax(_siemens_parameters(jp, scan, probe, psi))
    got = _run_port(data, tparams, False)
    costs = np.ravel(got["costs"])
    assert np.all(np.isfinite(costs)) and costs[-1] < costs[1]
    relative = lambda x, key: np.max(
        np.abs(np.ravel(x[key]) - np.ravel(want[key]))
    ) / np.max(np.abs(np.ravel(want[key])))
    for key in ("costs", "psi", "probe"):
        gap, own = relative(got, key), relative(nudged, key)
        print(key, "gap", gap, "own", own)
        assert gap <= max(2 * own, 1e-5), (key, gap, own)


def test_device_resident_data_cannot_be_streamed(slice_data):
    """As in tike_tpu: data that already lies on the device with
    ``store_data_on_device=False`` is a ValueError. A CPU tensor is host
    data and streams."""
    scan, probe, psi0, data = slice_data
    params = H.epoch_loop_parameters(tp, scan, probe, psi0, "rpie", {})
    on_device = torch.empty(data.shape, device="meta")
    with pytest.raises(ValueError, match="already device-resident"):
        tp.Reconstruction(on_device, params, device="meta", store_data_on_device=False)
    got = _run_port(torch.tensor(data), params, False, epochs=1)
    assert np.isfinite(got["costs"][0][0])


def test_default_keeps_data_resident_on_the_cpu(slice_data):
    scan, probe, psi0, data = slice_data
    params = H.epoch_loop_parameters(tp, scan, probe, psi0, "rpie", {})
    with tp.Reconstruction(data, params, device="cpu") as context:
        assert context.store_data_on_device is True and context._fused_eligible()
        assert isinstance(context.data, torch.Tensor)


@pytest.mark.parametrize(
    "free_bytes, resident", [(10 * 2**30, True), (2**20, False)]
)
def test_default_decides_from_free_device_memory(monkeypatch, free_bytes, resident):
    """``store_data_on_device=None`` holds the data's bytes plus one
    batch's working set against ``torch.cuda.mem_get_info``."""
    from tike_tpu_torch.ptycho import ptycho as entry

    monkeypatch.setattr(
        torch.cuda, "mem_get_info", lambda device=None: (free_bytes, 80 * 2**30)
    )
    fits = entry._data_fits_on_device(torch.device("cuda"), (1000, 64, 64), 10, 1)
    assert fits == resident
    assert entry._data_fits_on_device(torch.device("cpu"), (10**9, 64, 64), 1, 1)


def test_batch_order_and_views():
    """On the CPU a StreamedBatches hands out the host batches in the order
    asked, without copying; ``pinned_batches`` fills them batch-major."""
    gen = H.rng(3)
    data = gen.random((10, 4, 4), np.float32)
    perm = gen.permutation(10)[:8]
    host = stream.pinned_batches(data, perm, (4, 2), "cpu")
    assert host.shape == (4, 2, 4, 4) and not host.is_pinned()
    np.testing.assert_array_equal(host.numpy().reshape(8, 4, 4), data[perm])
    same = stream.pinned_batches(torch.tensor(data), perm, (4, 2), "cpu")
    assert torch.equal(same, host)
    batches = stream.StreamedBatches(host, "cpu")
    seen = list(batches.batches([2, 0, 3, 1]))
    assert [n for n, _ in seen] == [2, 0, 3, 1]
    for n, batch in seen:
        assert batch.data_ptr() == host[n].data_ptr()
    resident = list(stream.iter_batches(host, [1, 3]))
    assert [n for n, _ in resident] == [1, 3] and torch.equal(resident[1][1], host[3])
    assert batches.stats() == {"copy_ms": 0.0, "wait_ms": 0.0, "copies": 0, "bytes": 0}
