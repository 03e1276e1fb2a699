"""The Bucket kernels' checks, inputs and golden protocol.

``chip_smoke.py`` holds the CUDA kernels of ``tike_tpu_torch/csrc/bucket.cu``
to their plain PyTorch versions with these, and
``tests/test_torch_bucket_cuda.py`` does the same on the card;
``tests/test_torch_bucket.py`` holds the plain versions to ``tike_tpu`` on the
CPU. Nothing here imports JAX.
"""

from __future__ import annotations

import lzma
import os
import pickle

import numpy as np
import torch

import tike_tpu_torch.lamino.bucket as tlb
from tike_tpu_torch.ops import bucket

# The forward kernel against its plain version: the same cells (checked
# exactly by cell_mismatches), each cell's k weighted points added by float2
# atomics in an order that varies from launch to launch, the plain version's
# index_add_ in its own. Each order's float32 sum lies within (k - 1) u S of
# the exact one (u = 2^-24, S the cell's sum of |terms|, each part on its
# own), so the two within FWD_ROUNDING k u S of each other. A relative
# tolerance does not hold at full width: a cell there sums thousands of
# terms that largely cancel (1.29e-5 of the largest value at 128^3, 64
# angles, precision 3, NVIDIA H100 80GB HBM3).
FWD_ROUNDING = 2.0
UNIT_ROUNDOFF = 2.0**-24
# The adjoint kernel against its plain version: the same cells and the same
# float32 operations in the same order (angles outer, offsets inner, each
# product and sum rounded on its own), so bit for bit; relative, like the
# forward's.
ADJ_TOL = 0.0
# <fwd(u), d> against <u, adj(d)>, relative, summed in float64.
ADJOINT_TOL = 1e-5
# The reference's golden protocol (tests/test_parity_golden.py): 1 + 30 outer
# iterations at eps=1 on lamino_setup, against lamino_bucket at this atol.
GOLDEN_ATOL = 1e-3
GOLDEN_ITERS = (1, 30)

# bench_all.py's laminography geometry (lamino_cgrad, lamino_cgls): a 128^3
# volume, 64 angles over [0, pi), tilt pi/3; the Bucket solver's default eps
# of 1e-1 (precision 3) and cg_iter 4.
FULL = dict(n=128, ntheta=64, tilt=np.pi / 3, eps=1e-1, cg_iter=4)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def theta(ntheta: int, shift: float = 0.0, device=None) -> torch.Tensor:
    """``ntheta`` float32 angles over [0, pi), moved by ``shift`` rad."""
    t = np.linspace(0, np.pi, ntheta, endpoint=False) + shift
    return torch.as_tensor(t.astype(np.float32), device=device)


def volume(n: int, seed: int = 0, device=None) -> torch.Tensor:
    """A Gaussian-windowed random complex64 n^3 volume (as bench_all.py's
    laminography volume)."""
    gen = np.random.default_rng(seed)
    x = (gen.standard_normal((n, n, n)) + 1j * gen.standard_normal((n, n, n))) * np.exp(
        -((np.mgrid[0:n, 0:n, 0:n] - n / 2) ** 2).sum(0) / (n / 3) ** 2
    )
    return torch.as_tensor(x.astype(np.complex64), device=device)


def planes(ntheta: int, n: int, seed: int = 1, device=None) -> torch.Tensor:
    gen = np.random.default_rng(seed)
    x = gen.standard_normal((ntheta, n, n)) + 1j * gen.standard_normal((ntheta, n, n))
    return torch.as_tensor(x.astype(np.complex64), device=device)


def max_rel(a, b) -> float:
    scale = float(torch.max(torch.abs(b))) if b.numel() else 0.0
    return float(torch.max(torch.abs(a - b))) / scale if scale else 0.0


def inner64(a, b) -> complex:
    """<a, b> = sum(conj(a) b), in complex128."""
    return complex(torch.sum(torch.conj(a.to(torch.complex128)) * b.to(torch.complex128)))


def fwd_rounding_ratio(cfg: bucket.BucketConfig, got, want, u, th, grid=None, trig=None) -> float:
    """The largest |got - want| of the forward (each of the real and the
    imaginary part) over its rounding bound FWD_ROUNDING k u S, cell by
    cell: k the cell's points and S its sum of |terms|, both from the plain
    version (on a volume of ones, and of |Re u| + i |Im u|). At most 1 when
    the two differ only by the order of their float32 sums."""
    counts = bucket.bucket_fwd_plain(cfg, torch.ones_like(u), th, grid, trig).real
    k = torch.round(counts / bucket._weight(cfg))
    v = u.reshape(-1)
    s = bucket.bucket_fwd_plain(cfg, torch.complex(v.real.abs(), v.imag.abs()), th, grid, trig)
    ratio = 0.0
    for part in (torch.real, torch.imag):
        bound = FWD_ROUNDING * k * UNIT_ROUNDOFF * part(s)
        diff = torch.abs(part(got) - part(want))
        if bool(torch.any((diff > 0) & (bound == 0))):
            return float("inf")
        ratio = max(ratio, float(torch.max(torch.where(diff > 0, diff / bound, 0.0))))
    return ratio


def cell_mismatches(cfg: bucket.BucketConfig, th, grid=None) -> int:
    """Voxels whose cells differ between the adjoint kernel and the plain
    version, angle by angle: each angle's plane holds its own flat cell
    index, so the adjoint of one angle gives each voxel the sum of its
    points' indices (times the weight), in the same order on both sides.
    Any difference is a point in another cell."""
    n = cfg.n
    index = torch.arange(n * n, dtype=torch.float32, device=th.device)
    plane = torch.complex(index, torch.zeros_like(index)).reshape(1, n, n)
    trig = bucket.bucket_trig(cfg, th)
    bad = 0
    for t in range(th.shape[0]):
        got = bucket.bucket_adj_cuda(cfg, plane, th[t : t + 1], grid, trig[t : t + 1])
        want = bucket.bucket_adj_plain(cfg, plane, th[t : t + 1], grid, trig[t : t + 1])
        bad += int(torch.sum(got != want))
    return bad


def check_bucket_kernels(cfg: bucket.BucketConfig, u, d, th, grid=None) -> dict:
    """Both kernels against their plain versions on the same inputs (u the
    volume, d the planes, th the angles, all on the card), and against
    adjointness; two adjoint launches bitwise equal; the forward of a
    volume of ones (each cell's count of points times the weight) equal to
    the plain version's where the weight is a power of two, so that every
    sum is exact. Raises AssertionError; returns the errors."""
    trig = bucket.bucket_trig(cfg, th)
    fwd = bucket.bucket_fwd_cuda(cfg, u, th, grid, trig)
    adj = bucket.bucket_adj_cuda(cfg, d, th, grid, trig)
    adj2 = bucket.bucket_adj_cuda(cfg, d, th, grid, trig)
    fwd_plain = bucket.bucket_fwd_plain(cfg, u, th, grid, trig)
    adj_plain = bucket.bucket_adj_plain(cfg, d, th, grid, trig)
    torch.cuda.synchronize()
    out = {
        "fwd": max_rel(fwd, fwd_plain),
        "fwd_rounding": fwd_rounding_ratio(cfg, fwd, fwd_plain, u, th, grid, trig),
        "fwd_abs": float(torch.max(torch.abs(fwd - fwd_plain))),
        "adj": max_rel(adj, adj_plain),
        "adj_abs": float(torch.max(torch.abs(adj - adj_plain))),
        "adj_bitwise": bool(torch.equal(adj, adj_plain)),
    }
    lhs, rhs = inner64(fwd, d), inner64(u.reshape(-1), adj)
    out["adjoint"] = abs(lhs - rhs) / max(abs(lhs), abs(rhs), 1e-30)
    what = f"bucket n={cfg.n} precision={cfg.precision} angles={th.shape[0]}"
    if not out["fwd_rounding"] <= 1.0:
        raise AssertionError(
            f"{what}: bucket_fwd differs from plain by {out['fwd_rounding']:.3g} times the "
            f"rounding bound of its sums ({out['fwd']:.3e} of max|value|)"
        )
    if not out["adj"] <= ADJ_TOL:
        raise AssertionError(f"{what}: bucket_adj differs from plain by {out['adj']:.3e}")
    if not out["adjoint"] <= ADJOINT_TOL:
        raise AssertionError(f"{what}: adjointness {out['adjoint']:.3e}")
    if not torch.equal(adj, adj2):
        raise AssertionError(f"{what}: two bucket_adj launches differ")
    if cfg.precision in (1, 2, 4):
        ones = torch.ones_like(u)
        counts = bucket.bucket_fwd_cuda(cfg, ones, th, grid, trig)
        if not torch.equal(counts, bucket.bucket_fwd_plain(cfg, ones, th, grid, trig)):
            raise AssertionError(f"{what}: bucket_fwd's points per cell differ from plain")
    return out


def load_golden(name: str):
    with lzma.open(os.path.join(DATA, name), "rb") as f:
        return pickle.load(f)


def golden_reconstruct(device):
    """The reference's golden protocol on ``device``: 1 outer iteration from
    zeros, then 30 more, at eps=1 (precision 1) on lamino_setup. Returns
    (volume, the standard lamino_bucket, costs)."""
    data, original, th, tilt = load_golden("lamino_setup.pickle.lzma")
    standard = load_golden("lamino_bucket.pickle.lzma")
    first, more = GOLDEN_ITERS
    r = tlb.reconstruct(data, th, tilt, obj=np.zeros_like(original), num_iter=first,
                        eps=1, device=device)
    costs = list(r["cost"])
    r = tlb.reconstruct(data, th, tilt, obj=r["obj"], num_iter=more, eps=1,
                        device=device)
    return r["obj"], standard, np.asarray(costs + list(r["cost"]))
