"""The public API's helpers and per-epoch solver functions on the card.

``learn.extract_patches``, ``ops.patch.patch_fwd_padded`` and the Fourier
patch pair run the CUDA patch kernels on the card and are held against
their plain path there; the per-epoch solver functions run 3 epochs of
``update_preconditioners`` then ``solvers.lstsq_grad`` or ``solvers.rpie``
at a small size on the card against the same on the CPU. Every test here
needs a CUDA card and ``nvcc``, is marked ``cuda``, and skips without a
card. On a machine with a card, from the root of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_api_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` configures JAX, which this file
does not import.)
"""

import numpy as np
import pytest
import torch

from tike_tpu_torch import cluster
from tike_tpu_torch.ops import patch, shift
from tike_tpu_torch.ops.ptycho import PtychoConfig
import tike_tpu_torch.ptycho as tp
from tike_tpu_torch.ptycho import learn

from . import _torch_patch_cases as cases

pytestmark = pytest.mark.cuda

# The small slice of chip_smoke.py's phase 5, card against CPU: kernels,
# cuFFT and reductions sum in other orders, and 3 epochs carry that
# rounding forward (relative to the largest value; positions in px).
SLICE_TOL, SLICE_SCAN_TOL = 1e-4, 1e-3
HW, P, DET, NPOS = 160, 16, 24, 120


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build csrc/patch.cu)")
    return torch.device("cuda", 0)


def _image_positions(device, n=300, hw=200, p=P, seed=0):
    gen = np.random.default_rng(seed)
    image = (gen.standard_normal((hw, hw)) + 1j * gen.standard_normal((hw, hw))).astype(
        np.complex64
    )
    positions = gen.uniform(1, hw - p - 2, (n, 2)).astype(np.float32)
    return torch.as_tensor(image, device=device), torch.as_tensor(positions, device=device)


def test_extract_patches_launches_the_kernel(card):
    image, positions = _image_positions(card)
    before = patch.LAUNCHES["patch_fwd"]
    got = learn.extract_patches(image, positions, P)
    assert patch.LAUNCHES["patch_fwd"] == before + 1 and got.device == image.device
    want = patch.patch_fwd_plain(image, positions, P)
    torch.testing.assert_close(got, want, rtol=cases.FWD_TOL, atol=cases.FWD_TOL)
    host = learn.extract_patches(image.cpu().numpy(), positions.cpu().numpy(), P, device=card)
    assert isinstance(host, np.ndarray)
    np.testing.assert_array_equal(host, got.cpu().numpy())


@pytest.mark.parametrize("padded", [P, 24, 33])
def test_patch_fwd_padded_on_the_card(card, padded):
    image, positions = _image_positions(card)
    got = patch.patch_fwd_padded(image, positions, P, padded)
    pad = (padded - P) // 2
    inside = got[:, pad : pad + P, pad : pad + P]
    assert cases.equal_bits(inside, patch.patch_fwd(image, positions, P))
    torch.testing.assert_close(
        inside, patch.patch_fwd_plain(image, positions, P), rtol=cases.FWD_TOL, atol=cases.FWD_TOL
    )
    border = got.clone()
    border[:, pad : pad + P, pad : pad + P] = 0
    assert not bool(border.any())


@pytest.mark.parametrize("initial", [False, True], ids=["zeros", "initial"])
def test_fourier_pair_on_the_card(card, initial):
    """The pair against its plain path (the plain patch versions and the
    same cuFFT shifts), and adjointness."""
    image, positions = _image_positions(card)
    gen = torch.Generator(card).manual_seed(1)
    y = torch.complex(*torch.randn((2, positions.shape[0], P, P), generator=gen, device=card))
    start = image * 0.5 if initial else None
    lo = torch.floor(positions)
    fwd = patch.patch_fwd_fourier(image, positions, P)
    adj = patch.patch_adj_fourier(y, positions, tuple(image.shape), start)
    fwd_plain = shift.shift_adj(patch.patch_fwd_plain(image, lo, P), positions - lo)
    adj_plain = patch.patch_adj_plain(
        shift.shift_fwd(y, positions - lo), lo, tuple(image.shape), start
    )
    torch.testing.assert_close(fwd, fwd_plain, rtol=cases.FWD_TOL, atol=cases.FWD_TOL)
    assert cases.max_abs(adj, adj_plain) <= cases.ADJ_TOL * cases.max_value(adj_plain)
    if not initial:
        lhs = torch.vdot(fwd.flatten().to(torch.complex128), y.flatten().to(torch.complex128))
        rhs = torch.vdot(image.flatten().to(torch.complex128), adj.flatten().to(torch.complex128))
        assert abs(complex(lhs - rhs)) <= 1e-5 * abs(complex(lhs))


def _slice():
    gen = np.random.default_rng(1)
    scan = gen.uniform(2, HW - P - 3, (NPOS, 2)).astype(np.float32)
    yy, xx = np.mgrid[0:HW, 0:HW] / HW
    psi = (
        np.exp(1j * 0.5 * np.sin(17 * yy) * np.cos(13 * xx)) * (0.9 + 0.1 * np.cos(23 * xx * yy))
    ).astype(np.complex64)[None]
    probe = (tp.gaussian(P) * np.exp(1j * gen.uniform(-np.pi, np.pi, (P, P))))[
        None, None, None
    ].astype(np.complex64)
    psi0 = (0.5 + 0.05 * (gen.standard_normal(psi.shape) + 1j * gen.standard_normal(psi.shape)))
    return scan, psi, probe, psi0.astype(np.complex64)


@pytest.mark.parametrize(
    "solver, method, flat",
    [("lstsq", "compact", False), ("rpie", "wobbly_center", True), ("rpie", "compact", False)],
)
def test_per_epoch_solvers_card_against_cpu(card, solver, method, flat):
    scan, psi, probe, psi0 = _slice()
    data = tp.simulate(DET, probe, scan, psi, device="cpu")
    kw = dict(rng=np.random.default_rng(0)) if method == "compact" else {}
    batches = cluster.batches_padded(getattr(cluster, method)(scan, 3, **kw))
    data = data if flat else data[batches[0]]
    cfg = PtychoConfig(probe_shape=P, detector_shape=DET, nz=HW, n=HW)
    fn = tp.solvers.rpie if solver == "rpie" else tp.solvers.lstsq_grad
    out = {}
    for device in ("cpu", card):
        options = tp.RpieOptions if solver == "rpie" else tp.LstsqOptions
        params = tp.PtychoParameters(
            probe=probe,
            psi=psi0,
            scan=scan,
            algorithm_options=options(num_batch=3, batch_method=method),
            object_options=tp.ObjectOptions(use_adaptive_moment=solver == "lstsq"),
            probe_options=tp.ProbeOptions(),
            position_options=tp.PositionOptions(initial_scan=scan, update_magnitude_limit=2.0)
            if solver == "lstsq"
            else None,
            exitwave_options=tp.ExitWaveOptions(measured_pixels=np.ones((DET, DET), bool)),
        ).copy_to_device(device)
        rng = np.random.default_rng(0)
        for epoch in range(3):
            params = tp.update_preconditioners(cfg, params, batches)
            params = fn(params, torch.as_tensor(data, device=device), batches, op=cfg,
                        epoch=epoch, rng=rng)
        assert params.psi.device.type == torch.device(device).type
        out[str(device)] = params.copy_to_host()
    got, ref = out[str(card)], out["cpu"]
    costs = np.asarray(got.algorithm_options.costs)
    assert np.all(np.isfinite(costs)) and costs[-1, 0] < costs[0, 0]
    np.testing.assert_allclose(costs, np.asarray(ref.algorithm_options.costs), rtol=SLICE_TOL)
    for key in ("psi", "probe"):
        a, b = getattr(got, key), getattr(ref, key)
        np.testing.assert_allclose(a, b, rtol=SLICE_TOL, atol=SLICE_TOL * np.abs(b).max())
    np.testing.assert_allclose(got.scan, ref.scan, rtol=0, atol=SLICE_SCAN_TOL)


def test_adjust_probe_power_on_the_card(card):
    probe = tp.add_modes_cartesian_hermite(
        tp.single_probe(64, 1.24e-10, 20e-9, 800e-6, "velo"), 3
    )
    got = tp.adjust_probe_power(torch.as_tensor(probe, device=card))
    want = tp.adjust_probe_power(probe, device="cpu")
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
