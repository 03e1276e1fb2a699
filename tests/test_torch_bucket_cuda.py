"""The CUDA Bucket kernels (``csrc/bucket.cu``) against their plain PyTorch
versions, on the card.

Every test here needs a CUDA card and ``nvcc``, is marked ``cuda``, and
skips without a card; whether there is one is decided inside each test, so
every worker collects the same tests. On a machine with a card, from the
root of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_bucket_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` configures JAX, which this file
does not import.) The checks are those of ``chip_smoke.py``'s phase 16,
from ``tests/_torch_bucket_cases.py``, at smaller sizes.
"""

import numpy as np
import pytest
import torch

import tike_tpu_torch.lamino.bucket as tlb
from tike_tpu_torch.ops import bucket

from . import _torch_bucket_cases as cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build csrc/bucket.cu)")
    return torch.device("cuda", 0)


# (n, angles, precision, tilt, shift of the angles): odd n, n = 1, one
# angle, many angles, precisions 1-4 (their kernels compiled for each) and 5
# (the kernels' runtime loops); at n = 16 and tilt pi/3 the corner voxels
# project past the plane's edge and wrap. Every n but 8, 16 and 24 cuts the
# lattice's last tiles of bucket.TILE^3 voxels.
EDGE_CASES = [
    (16, 8, 1, np.pi / 3, 0.0),
    (16, 8, 2, np.pi / 3, 0.0),
    (15, 7, 3, np.pi / 3, 0.1),
    (13, 5, 4, 0.7, 0.0),
    (1, 3, 2, np.pi / 3, 0.0),
    (24, 1, 3, np.pi / 2, 0.3),
    (8, 300, 1, np.pi / 4, 0.0),
    (10, 4, 5, np.pi / 3, 0.0),
]


@pytest.mark.parametrize("n, ntheta, precision, tilt, shift", EDGE_CASES)
def test_kernels_match_plain(card, n, ntheta, precision, tilt, shift):
    cfg = bucket.BucketConfig(n=n, tilt=tilt, precision=precision)
    th = cases.theta(ntheta, shift, card)
    u, d = cases.volume(n, device=card), cases.planes(ntheta, n, device=card)
    cases.check_bucket_kernels(cfg, u, d, th)
    assert cases.cell_mismatches(cfg, th) == 0


@pytest.mark.parametrize("host", [False, True], ids=["grid on the card", "grid on the host"])
def test_kernels_on_a_grid_chunk(card, host):
    """A chunk of x-slabs with its grid given (the voxel-parallel layout's
    part of one rank), from the card or from the host: a thread per voxel,
    each point's cell by a floor-mod."""
    n = 12
    cfg = bucket.BucketConfig(n=n, tilt=np.pi / 3, precision=2)
    grid = bucket.make_grid(n, 3, 1)
    if not host:
        grid = torch.as_tensor(grid, device=card)
    th = cases.theta(6, 0.0, card)
    u = cases.volume(n, device=card).reshape(-1)[: grid.shape[0]].contiguous()
    cases.check_bucket_kernels(cfg, u, cases.planes(6, n, device=card), th, grid)
    assert cases.cell_mismatches(cfg, th, grid) == 0


@pytest.mark.parametrize("lattice", [True, False], ids=["lattice", "grid"])
def test_precision_past_the_parameter_offsets(card, lattice):
    """At precision bucket.PARAM_OFFSETS + 1 the last offset is computed in
    the kernel, not passed: every point still lands in the plain version's
    cell. The adjoint equals, bit for bit, the plain order of its float32
    sums (angles outer, offsets inner; summed here by numpy's sequential
    accumulate), and the forward lies within FWD_ROUNDING k u S of each
    cell's exact sum."""
    n, ntheta = 2, 2
    cfg = bucket.BucketConfig(n=n, tilt=np.pi / 3, precision=bucket.PARAM_OFFSETS + 1)
    th = cases.theta(ntheta, 0.1)
    trig = bucket.bucket_trig(cfg, th)
    u, d = cases.volume(n), cases.planes(ntheta, n)
    want_adj, exact, bound = cases.sequential_reference(cfg, u, d, trig)
    on = None if lattice else torch.as_tensor(bucket.make_grid(n), device=card)
    bucket.reset_outside_windows(card)
    adj = bucket.bucket_adj_cuda(cfg, d.to(card), th.to(card), on, trig.to(card)).cpu().numpy()
    fwd = bucket.bucket_fwd_cuda(cfg, u.to(card), th.to(card), on, trig.to(card)).cpu().numpy()
    assert bucket.outside_windows(card) == 0
    np.testing.assert_array_equal(adj, want_adj)
    fwd = fwd.reshape(ntheta, -1)
    for part, b in zip((np.real, np.imag), bound):
        assert np.all(np.abs(part(fwd) - part(exact)) <= b)


@pytest.mark.parametrize("n, precision", [(9, 3), (17, 2), (23, 1)])
def test_tile_edges(card, n, precision):
    """A lattice whose edge tiles are cut (n not a multiple of bucket.TILE):
    the voxels past n are no voxels, and nothing of theirs reaches a plane
    or the volume."""
    cfg = bucket.BucketConfig(n=n, tilt=np.pi / 3, precision=precision)
    th = cases.theta(5, 0.2, card)
    u, d = cases.volume(n, device=card), cases.planes(5, n, device=card)
    cases.check_bucket_kernels(cfg, u, d, th)
    assert cases.cell_mismatches(cfg, th) == 0


def test_zero_voxels_add_nothing(card):
    """The forward skips voxels whose value is 0 (a plane cell stays +0):
    half a volume of zeros against the plain version."""
    n = 16
    cfg = bucket.BucketConfig(n=n, tilt=np.pi / 3, precision=3)
    th = cases.theta(6, 0.0, card)
    u = cases.volume(n, device=card)
    u[: n // 2] = 0
    cases.check_bucket_kernels(cfg, u, cases.planes(6, n, device=card), th)


def test_wrapping_points_are_covered(card):
    """The case list has points whose projection wraps: at n = 16, tilt
    pi/3, some voxel's in-plane coordinate leaves [-n/2, n/2)."""
    cfg = bucket.BucketConfig(n=16, tilt=np.pi / 3)
    grid = torch.as_tensor(bucket.make_grid(16), device=card)
    trig = bucket.bucket_trig(cfg, cases.theta(8, 0.0, card))
    r = trig[1]
    p = grid.to(torch.float32) + 0.5
    d = p @ r[:3]
    q = p - d[:, None] * r[:3]
    y = r[3] * q[:, 0] + r[4] * q[:, 1] + r[5] * q[:, 2]
    assert float(y.abs().max()) > 8


def test_adjoint_repeats_bitwise(card):
    cfg = bucket.BucketConfig(n=32, tilt=np.pi / 3, precision=3)
    th = cases.theta(16, 0.0, card)
    d = cases.planes(16, 32, device=card)
    first = bucket.bucket_adj(cfg, d, th)
    for _ in range(3):
        assert torch.equal(bucket.bucket_adj(cfg, d, th), first)


def test_kernels_run_in_a_cuda_graph(card):
    """With the angles' table built beforehand, a forward and an adjoint
    capture into a CUDA graph and replay to the eager results (the adjoint
    bit for bit, the forward within the rounding bound of its atomics'
    sums)."""
    cfg = bucket.BucketConfig(n=24, tilt=np.pi / 3, precision=2)
    th = cases.theta(10, 0.0, card)
    trig = bucket.bucket_trig(cfg, th)
    u, d = cases.volume(24, device=card), cases.planes(10, 24, device=card)
    fwd = bucket.bucket_fwd(cfg, u, th, trig=trig)
    adj = bucket.bucket_adj(cfg, d, th, trig=trig)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_fwd = bucket.bucket_fwd(cfg, u, th, trig=trig)
        g_adj = bucket.bucket_adj(cfg, d, th, trig=trig)
    bucket.reset_outside_windows(card)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(g_adj, adj)
        assert cases.fwd_rounding_ratio(cfg, g_fwd, fwd, u, th, trig=trig) <= 1.0
    assert bucket.outside_windows(card) == 0


def test_launches_are_counted(card):
    cfg = bucket.BucketConfig(n=8, tilt=np.pi / 3)
    th = cases.theta(4, 0.0, card)
    before = dict(bucket.LAUNCHES)
    bucket.bucket_adj(cfg, bucket.bucket_fwd(cfg, cases.volume(8, device=card), th), th)
    assert bucket.LAUNCHES["bucket_fwd"] == before["bucket_fwd"] + 1
    assert bucket.LAUNCHES["bucket_adj"] == before["bucket_adj"] + 1


def test_wrong_inputs_are_refused_before_a_launch(card):
    cfg = bucket.BucketConfig(n=8, tilt=np.pi / 3)
    th = cases.theta(4, 0.0, card)
    with pytest.raises(ValueError, match="n\\^3"):
        bucket.bucket_fwd(cfg, torch.zeros(100, dtype=torch.complex64, device=card), th)
    with pytest.raises(ValueError, match="complex64"):
        bucket.bucket_adj(cfg, torch.zeros((4, 8, 8), dtype=torch.complex128, device=card), th)
    with pytest.raises(ValueError, match="one device"):
        bucket.bucket_fwd(cfg, torch.zeros(512, dtype=torch.complex64, device=card), th.cpu())


def test_golden_reconstruction(card):
    """The reference's protocol (1 + 30 outer iterations at eps=1 on
    lamino_setup) on the card, against lamino_bucket at atol 1e-3."""
    obj, standard, costs = cases.golden_reconstruct(card)
    assert np.all(np.isfinite(costs)) and costs[-1] < costs[0]
    np.testing.assert_allclose(obj, standard, atol=cases.GOLDEN_ATOL)


def test_solver_on_the_card_matches_the_cpu(card):
    """3 outer iterations at cg_iter 1 at n = 16, card against CPU."""
    th = cases.theta(8, 0.1).numpy()
    vol = cases.volume(16).numpy()
    data = tlb.simulate(vol, th, np.pi / 3, eps=1 / 8, device="cpu")
    kw = dict(num_iter=3, eps=1 / 8, cg_iter=1)
    want = tlb.reconstruct(data, th, np.pi / 3, device="cpu", **kw)
    got = tlb.reconstruct(data, th, np.pi / 3, device=card, **kw)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-4)
    assert np.max(np.abs(got["obj"] - want["obj"])) <= 1e-4 * np.max(np.abs(want["obj"]))
