"""The mesh on the card: the tiled Bucket kernels on x-slabs against their
plain versions, and a two-shard mesh on one card against the same mesh on
the CPU.

Every test here needs a CUDA card and ``nvcc``, is marked ``cuda``, and
skips without a card; whether there is one is decided inside each test, so
every worker collects the same tests. On a machine with a card, from the
root of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mesh_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` configures JAX, which this file
does not import.) ``chip_smoke.py``'s phase 21 runs the same checks at the
main paths' sizes.
"""

import numpy as np
import pytest
import torch

import tike_tpu_torch.lamino as tl
import tike_tpu_torch.lamino.bucket as tlb
import tike_tpu_torch.parallel as tpar
import tike_tpu_torch.ptycho as tp
from tike_tpu_torch.ops import bucket

from . import _torch_bucket_cases as cases

pytestmark = pytest.mark.cuda

# The small slices' tolerance, card against CPU (chip_smoke.py's SLICE_TOL).
SLICE_TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    return torch.device("cuda", 0)


# (n, precision, slab): slabs of 8 and 16 rows from a tile boundary, and of
# 5, 13 and 21 rows from rows off the lattice's tiles; the last row; the
# whole lattice as a slab.
SLABS = [
    (32, 3, (0, 16)),
    (32, 3, (16, 16)),
    (32, 2, (8, 8)),
    (32, 3, (3, 13)),
    (29, 4, (11, 5)),
    (40, 1, (19, 21)),
    (16, 5, (15, 1)),
    (16, 3, (0, 16)),
]


@pytest.mark.parametrize("n, precision, slab", SLABS)
def test_slab_kernels_match_plain(card, n, precision, slab):
    """Each kernel on the slab against its plain version on the slab (the
    adjoint bitwise, the forward within the rounding bound of its sums), no
    point outside its window, and the adjoint's slab the rows of the full
    lattice's adjoint, bit for bit."""
    cfg = bucket.BucketConfig(n=n, tilt=np.pi / 3, precision=precision)
    th = cases.theta(7, 0.1, card)
    x0, rows = slab
    u = cases.volume(n, device=card)[x0 : x0 + rows]
    d = cases.planes(7, n, device=card)
    cases.check_bucket_kernels(cfg, u, d, th, slab=slab)
    whole = bucket.bucket_adj_cuda(cfg, d, th).reshape(n, n, n)
    part = bucket.bucket_adj_cuda(cfg, d, th, slab=slab).reshape(rows, n, n)
    assert torch.equal(part, whole[x0 : x0 + rows])


def test_slab_forwards_sum_to_the_lattice(card):
    """The forwards of 3 slabs (11, 11 and 10 rows of 32) summed, against
    the full lattice's plain forward: within the rounding bound of its
    sums."""
    cfg = bucket.BucketConfig(n=32, tilt=np.pi / 3, precision=3)
    th = cases.theta(9, 0.1, card)
    u = cases.volume(32, device=card)
    total = sum(
        bucket.bucket_fwd_cuda(cfg, u[x0 : x0 + rows], th, slab=(x0, rows))
        for x0, rows in (bucket.slab_of(32, 3, r) for r in range(3))
    )
    want = bucket.bucket_fwd_plain(cfg, u, th)
    assert cases.fwd_rounding_ratio(cfg, total, want, u, th) <= 1.0


def test_a_slab_outside_the_lattice_is_refused(card):
    cfg = bucket.BucketConfig(n=16, tilt=np.pi / 3, precision=2)
    th = cases.theta(3, 0.0, card)
    d = cases.planes(3, 16, device=card)
    with pytest.raises(ValueError, match="run of rows"):
        bucket.bucket_adj_cuda(cfg, d, th, slab=(10, 8))
    with pytest.raises(ValueError, match="slab's 4 x n"):
        bucket.bucket_fwd_cuda(cfg, cases.volume(16, device=card)[:3], th, slab=(0, 4))


def _slice_inputs(seed=1, h=160, p=16, n=120, det=24):
    """chip_smoke.py's phase 5 slice: scan, data and parameters."""
    gen = np.random.default_rng(seed)
    scan = gen.uniform(2, h - p - 3, (n, 2)).astype(np.float32)
    psi = (0.8 + 0.2 * gen.standard_normal((1, h, h))
           + 0.2j * gen.standard_normal((1, h, h))).astype(np.complex64)
    probe = (tp.gaussian(p) * np.exp(1j * gen.uniform(-np.pi, np.pi, (p, p))))[
        None, None, None
    ].astype(np.complex64)
    psi0 = (0.5 + 0.05 * (gen.standard_normal(psi.shape)
                          + 1j * gen.standard_normal(psi.shape))).astype(np.complex64)
    data = tp.simulate(det, probe, scan, psi, device="cpu")

    def params():
        return tp.PtychoParameters(
            probe=probe, psi=psi0, scan=scan,
            algorithm_options=tp.LstsqOptions(num_batch=3, batch_method="compact",
                                              rescale_period=2),
            object_options=tp.ObjectOptions(), probe_options=tp.ProbeOptions(),
            exitwave_options=tp.ExitWaveOptions(measured_pixels=np.ones((det, det), bool)),
        )

    return data, params


def test_two_shards_on_the_card_match_two_on_the_cpu(card):
    """3 LSQML epochs on ``[cuda:0, cuda:0]`` against ``[cpu, cpu]``:
    costs and fields at 1e-4; a one-shard mesh on the card is no mesh,
    bit for bit."""
    data, params = _slice_inputs()
    out = {}
    for name, dev, mesh in (
        ("cpu", "cpu", tpar.make_mesh(devices=["cpu"] * 2)),
        ("card", card, tpar.make_mesh(devices=[card] * 2)),
        ("one", card, tpar.make_mesh(devices=[card])),
        ("none", card, None),
    ):
        with tp.Reconstruction(data, params(), device=dev, mesh=mesh, random_seed=0) as context:
            context.iterate(3)
            out[name] = context.get_result()
    got, ref = out["card"], out["cpu"]
    np.testing.assert_allclose(got.algorithm_options.costs, ref.algorithm_options.costs,
                               rtol=SLICE_TOL)
    for key in ("psi", "probe"):
        a, b = getattr(got, key), getattr(ref, key)
        np.testing.assert_allclose(a, b, rtol=SLICE_TOL, atol=SLICE_TOL * np.abs(b).max())
        np.testing.assert_array_equal(getattr(out["one"], key), getattr(out["none"], key))


def test_meshes_of_laminography_on_the_card(card):
    """USFFT cgrad with the angles over 2 shards and Bucket with
    ``obj_split=2`` on the card, against the card's single device (1e-5 at
    ``cg_iter=1``); no point of the slabs outside its window."""
    gen = np.random.default_rng(5)
    obj = ((gen.standard_normal((16,) * 3) + 1j * gen.standard_normal((16,) * 3)) * 0.1).astype(
        np.complex64
    )
    theta = np.linspace(0, 2 * np.pi, 8, endpoint=False).astype(np.float32)
    data = tl.simulate(obj, theta, np.pi / 3, upsample=2, device=card)
    kw = dict(data=data, theta=theta, tilt=np.pi / 3, algorithm="cgrad", num_iter=2, cg_iter=1,
              upsample=2, device=card)
    mesh = tl.reconstruct(mesh=tpar.make_mesh(devices=[card] * 2), **kw)
    np.testing.assert_allclose(mesh["cost"], tl.reconstruct(**kw)["cost"], rtol=1e-5)
    data = tlb.simulate(obj, theta, np.pi / 3, eps=1.0, device=card)
    kw = dict(data=data, theta=theta, tilt=np.pi / 3, num_iter=2, cg_iter=1, eps=1.0,
              device=card)
    bucket.reset_outside_windows(card)
    split = tlb.reconstruct(obj_split=2, **kw)
    assert bucket.outside_windows(card) == 0
    np.testing.assert_allclose(split["cost"], tlb.reconstruct(**kw)["cost"], rtol=1e-5)
