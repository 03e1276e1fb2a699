"""Host streaming of the port on the card: the copy stream against the
compute stream.

Every test here needs a CUDA card and ``nvcc``, is marked ``cuda``, and
skips without a card; whether there is one is decided inside each test, so
every worker collects the same tests. On a machine with a card, from the
root of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_stream_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` configures JAX, which this file
does not import.) A streamed run copies batch k+1 from pinned host memory
on a copy stream while batch k computes, through two device buffers that
take turns; it launches the kernels of a resident run in the same order on
the same inputs, so the two must agree bit for bit. A difference is a race:
a batch read before its copy landed, or overwritten before its last kernel
ran.
"""

import numpy as np
import pytest
import torch

import tike_tpu_torch.ptycho as tp
from tike_tpu_torch.ptycho import stream

pytestmark = pytest.mark.cuda

H, P, DET, NPOS = 160, 16, 24, 210


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build csrc/patch.cu)")
    return torch.device("cuda", 0)


def _problem():
    gen = np.random.default_rng(0)
    scan = gen.uniform(2, H - P - 3, (NPOS, 2)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:H] / H
    psi = (np.exp(1j * 0.5 * np.sin(17 * yy) * np.cos(13 * xx)))[None].astype(np.complex64)
    probe = (tp.gaussian(P) * np.exp(1j * gen.uniform(-np.pi, np.pi, (P, P))))[
        None, None, None
    ].astype(np.complex64)
    psi0 = (0.5 + 0.05 * (gen.standard_normal(psi.shape) + 1j * gen.standard_normal(psi.shape)))
    return scan, psi, probe, psi0.astype(np.complex64)


def _parameters(scan, probe, psi0, solver, num_batch):
    options = tp.RpieOptions if solver == "rpie" else tp.LstsqOptions
    return tp.PtychoParameters(
        probe=probe,
        psi=psi0,
        scan=scan,
        # A finite time limit puts the resident run on the per-epoch path,
        # which is the one a streamed run takes.
        algorithm_options=options(num_batch=num_batch, batch_method="random", time_limit=1e6),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
        exitwave_options=tp.ExitWaveOptions(measured_pixels=np.ones((DET, DET), bool)),
    )


@pytest.mark.parametrize("solver", ["rpie", "lstsq"])
@pytest.mark.parametrize("num_batch", [2, 3, 7])
def test_streamed_equals_resident_bitwise(card, solver, num_batch):
    """3 epochs with an even and two odd numbers of batches: the buffers'
    turns carry over from one epoch to the next, and from the set-up's
    rescale pass into the first epoch."""
    scan, psi, probe, psi0 = _problem()
    data = tp.simulate(DET, probe, scan, psi, device=card)
    results = []
    for store in (True, False):
        params = _parameters(scan, probe, psi0, solver, num_batch)
        with tp.Reconstruction(
            data, params, device=card, random_seed=0, store_data_on_device=store
        ) as context:
            if not store:
                assert isinstance(context.data, stream.StreamedBatches)
                assert context.data.host.is_pinned() and not context.data.host.is_cuda
            context.iterate(3)
            results.append(context.get_result())
    resident, streamed = results
    assert streamed.algorithm_options.costs == resident.algorithm_options.costs
    np.testing.assert_array_equal(streamed.psi, resident.psi)
    np.testing.assert_array_equal(streamed.probe, resident.probe)
    costs = np.ravel(streamed.algorithm_options.costs)
    assert np.all(np.isfinite(costs)) and costs[-1] < costs[0]


def test_default_keeps_a_small_array_resident(card):
    scan, psi, probe, psi0 = _problem()
    data = tp.simulate(DET, probe, scan, psi, device=card)
    params = _parameters(scan, probe, psi0, "rpie", 3)
    with tp.Reconstruction(data, params, device=card, random_seed=0) as context:
        assert context.store_data_on_device is True
        assert isinstance(context.data, torch.Tensor) and context.data.is_cuda


def test_device_tensor_cannot_be_streamed(card):
    scan, psi, probe, psi0 = _problem()
    data = tp.simulate_device(DET, probe, scan, psi, device=card)
    params = _parameters(scan, probe, psi0, "rpie", 3)
    with pytest.raises(ValueError, match="already device-resident"):
        tp.Reconstruction(data, params, device=card, store_data_on_device=False)
    # With no choice stated, device data stays where it is.
    assert tp.Reconstruction(data, params, device=card).store_data_on_device is True


def test_overlap_statistics(card):
    """With timing on, a streamed epoch reports one copy per batch, their
    bytes, and non-negative copy and wait times."""
    scan, psi, probe, psi0 = _problem()
    data = tp.simulate(DET, probe, scan, psi, device=card)
    params = _parameters(scan, probe, psi0, "rpie", 7)
    with tp.Reconstruction(
        data, params, device=card, random_seed=0, store_data_on_device=False
    ) as context:
        context.data.stats()
        context.data.timing = True
        context.iterate(1)
        stats = context.data.stats()
    assert stats["copies"] == 7 and stats["bytes"] == 7 * 30 * DET * DET * 4
    assert stats["copy_ms"] > 0 and stats["wait_ms"] >= 0


def test_unpinned_host_data_is_refused(card):
    host = torch.zeros((2, 3, 4, 4))
    with pytest.raises(ValueError, match="pinned"):
        stream.StreamedBatches(host, card)
