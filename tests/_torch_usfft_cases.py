"""The KB kernels' checks, inputs, bounds and einsum yardstick.

``chip_smoke.py`` holds the CUDA kernels of ``tike_tpu_torch/csrc/usfft.cu``
to their plain PyTorch versions with these, ``tests/test_torch_usfft_cuda.py``
does the same on the card, and ``tests/test_torch_usfft.py`` checks the
inputs, the bounds and the einsum formulation on the CPU (against
``tike_tpu``'s ``gather_kb_rows``/``scatter_kb_rows``). Nothing here imports
JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from tike_tpu_torch.ops import lamino, usfft

# Kernel against plain version, relative to the largest |value|: the same
# weights, bit for bit; the gather sums the taps in the plain version's
# order but with FMAs, the scatter sums each cell's points in the plan's
# order, the plain version's index_add_ in its own.
KB_TOL = 1e-5
# <gather(G), f> against <G, scatter(f)>, relative to the larger, summed in
# float64 from float32 terms.
ADJOINT_TOL = 1e-5
# The einsum yardstick against the kernels: the dense rows sum n products
# per axis (most of them zero) in cuBLAS's order, TF32 off.
EINSUM_TOL = 1e-4
# NVIDIA's data sheet for the H100 SXM at 700 W.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# bench_all.py's laminography (lamino_cgrad, lamino_cgls): a 128^3 volume,
# 64 angles over [0, pi), tilt pi/3, eps 1e-3, upsample 1.
LAMINO_N, LAMINO_NTHETA, LAMINO_TILT, LAMINO_EPS = 128, 64, np.pi / 3, 1e-3


def lamino_theta(ntheta: int, device=None) -> torch.Tensor:
    return torch.as_tensor(
        np.linspace(0, np.pi, ntheta, endpoint=False).astype(np.float32), device=device
    )


def lamino_rows(n: int, ntheta: int, device=None) -> torch.Tensor:
    """The (ntheta n, n, 3) row-structured points of a laminography
    transform of an n^3 volume (``bench_all.py``'s tilt)."""
    theta = lamino_theta(ntheta, device)
    return lamino.make_grids(theta, n, LAMINO_TILT).reshape(ntheta * n, n, 3)


def flat_points(gen: np.random.Generator, npoints: int, device=None, span=0.7):
    """(npoints, 3) float32 points uniform in [-span, span): with span >
    0.5, about a third of each axis wraps."""
    x = gen.uniform(-span, span, (npoints, 3)).astype(np.float32)
    return torch.as_tensor(x, device=device)


def crandn(gen: np.random.Generator, *shape, device=None) -> torch.Tensor:
    x = (gen.standard_normal(shape) + 1j * gen.standard_normal(shape)).astype(np.complex64)
    return torch.as_tensor(x, device=device)


def window_for(n_volume: int, eps: float, upsample: float):
    """(grid size, m, beta) of the KB window of a transform."""
    upsampled, _, m, beta = usfft.kb_parameters(n_volume, eps, upsample)
    return upsampled, m, beta


def max_rel(a, b) -> float:
    scale = float(torch.max(torch.abs(b))) if b.numel() else 0.0
    return float(torch.max(torch.abs(a - b))) / scale if scale else 0.0


def inner64(a, b) -> complex:
    """<a, b> = sum(conj(a) b), in complex128."""
    return complex(torch.sum(torch.conj(a.to(torch.complex128)) * b.to(torch.complex128)))


def check_kb_kernels(grid, x, f, n, m, beta, name) -> dict:
    """Both CUDA kernels against their plain versions on these inputs
    (grid (n, n, n), points x (N, 3), values f (N,)), each launched twice
    on one prebuilt plan with bitwise-equal results and once more building
    its own plan, again bitwise equal, and <gather(grid), f> = <grid,
    scatter(f)>. Raises on a difference; returns the relative errors (by
    kernel name and ``adjoint``) and the absolute ones (``<name>_abs``)."""
    plan = usfft.kb_plan(x, n, m, beta)
    got = usfft.gather_kb_cuda(grid, x, n, m, beta, plan)
    spread = usfft.scatter_kb_cuda(f, x, n, m, beta, plan)
    repeats = {
        "usfft_gather_kb": (
            got,
            usfft.gather_kb_cuda(grid, x, n, m, beta, plan),
            usfft.gather_kb_cuda(grid, x, n, m, beta),
        ),
        "usfft_scatter_kb": (
            spread,
            usfft.scatter_kb_cuda(f, x, n, m, beta, plan),
            usfft.scatter_kb_cuda(f, x, n, m, beta),
        ),
    }
    want = usfft.gather_kb_plain(grid, x, n, m, beta)
    spread_want = usfft.scatter_kb_plain(f, x, n, m, beta)
    torch.cuda.synchronize()
    out = {
        "usfft_gather_kb": max_rel(got, want),
        "usfft_scatter_kb": max_rel(spread, spread_want),
    }
    for key, value in out.items():
        if not value <= KB_TOL:
            raise AssertionError(f"{key} ({name}): relative error {value:.3e} > {KB_TOL:g}")
    for key, (first, *others) in repeats.items():
        for other in others:
            if not torch.equal(torch.view_as_real(first), torch.view_as_real(other)):
                raise AssertionError(f"{key} ({name}): two launches differ")
    lhs, rhs = inner64(got, f), inner64(grid, spread)
    out["adjoint"] = abs(lhs - rhs) / max(abs(lhs), abs(rhs), 1e-300)
    if not out["adjoint"] <= ADJOINT_TOL:
        raise AssertionError(
            f"adjointness ({name}): <gather(G), f> = {lhs} vs <G, scatter(f)> = {rhs}"
        )
    out["usfft_gather_kb_abs"] = float(torch.max(torch.abs(got - want))) if x.shape[0] else 0.0
    out["usfft_scatter_kb_abs"] = float(torch.max(torch.abs(spread - spread_want)))
    return out


def _wrap(i: int, n: int) -> int:
    return i + n if i < 0 else (i - n if i >= n else i)


def scatter_owned_plain(f, plan) -> torch.Tensor:
    """The scatter as ``kb_scatter_kernel`` computes it, cell by cell in
    float32 on the host: each grid cell sums, over the rows (j0, j1) of
    bins that reach it, the run of sorted points along axis 2 (two runs
    where the axis wraps), in the plan's order (the kernel splits a long
    run over a warp's lanes, which reorders that run's additions, not its
    terms). For small grids."""
    n, m = plan.n, plan.m
    taps = 2 * m
    bins, order = plan.bins.cpu().numpy(), plan.order.cpu().numpy()
    start, w = plan.bin_start.cpu().numpy(), plan.weights.cpu().numpy()
    values = f.cpu().numpy()
    grid = np.zeros((n, n, n), np.complex64)
    for c0, c1, c2 in np.ndindex(n, n, n):
        lo, hi = c2 - m, c2 + m
        a0 = lo + n if lo < 0 else lo
        a1 = n if (lo < 0 or hi > n) else hi
        b1 = hi if lo < 0 else (hi - n if hi > n else 0)
        acc = np.complex64(0)
        for j0 in range(taps):
            r0 = _wrap(c0 + m - 1 - j0, n)
            for j1 in range(taps):
                row_bin = (r0 * n + _wrap(c1 + m - 1 - j1, n)) * n
                if start[row_bin] == start[row_bin + n]:
                    continue
                for first, last in ((a0, a1), (0, b1)):
                    for p in range(start[row_bin + first], start[row_bin + last]):
                        j2 = _wrap(c2 + m - 1 - (bins[p] - row_bin), n)
                        wgt = np.float32(w[0, j0, p] * w[1, j1, p]) * w[2, j2, p]
                        acc = np.complex64(acc + values[order[p]] * wgt)
        grid[c0, c1, c2] = acc
    return torch.as_tensor(grid)


def gather_sorted_plain(Fe, plan) -> torch.Tensor:
    """The gather as ``kb_gather_kernel`` computes it: the sorted points'
    taps from their bins and the plan's weights, written through
    ``order``."""
    n, m = plan.n, plan.m
    bins = plan.bins.long()
    base = torch.stack([bins // (n * n), (bins // n) % n, bins % n], dim=1)
    offs = torch.arange(1 - m, m + 1, device=bins.device)
    g = torch.remainder(base[:, :, None] + offs, n)  # (N, 3, 2m)
    w = plan.weights
    acc = torch.zeros(plan.npoints, dtype=Fe.dtype, device=Fe.device)
    for j0 in range(2 * m):
        for j1 in range(2 * m):
            w01 = w[0, j0] * w[1, j1]
            for j2 in range(2 * m):
                acc = acc + Fe[g[:, 0, j0], g[:, 1, j1], g[:, 2, j2]] * (w01 * w[2, j2])
    out = torch.empty_like(acc)
    out[plan.order.long()] = acc
    return out


def roofline(name: str, x, n: int, m: int) -> dict:
    """The least time the card could take for a KB gather or scatter of
    the points x (N, 3) on an n^3 grid: the larger of the bytes it must
    move (``usfft.roofline_bytes``; the gather's grid bytes counted from the
    cells these points touch) at the HBM rate and its float32 operations at
    the peak rate outside the tensor cores."""
    npoints = x.shape[0]
    cells = usfft.touched_cells(x, n, m) if name == "usfft_gather_kb" else None
    nbytes = usfft.roofline_bytes(name, npoints, n, cells)
    ops = usfft.flops(npoints, m)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / FP32_FLOPS_PER_S
    return {
        "bound_bytes": nbytes,
        "bound_flops": ops,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "touched_cells": cells,
    }


# The TPU formulation, as the yardstick: tike_tpu/ops/usfft.py's
# gather_kb_rows/scatter_kb_rows, dense (.., n) rows of each axis's 2m
# weights contracted with einsums (cuBLAS on the card).


def dense_axis(x_axis, n: int, m: int, beta: float):
    """``dense[..., k] = phi(k - n x)`` on the 2m taps around floor(n x),
    zero elsewhere, wrapped into the centred grid's columns."""
    ell = torch.floor(n * x_axis)
    w = usfft._kb_axis_weights(x_axis, ell, m, beta, n)
    cols = torch.remainder(
        n // 2 + ell.to(torch.int64)[..., None]
        + torch.arange(1 - m, m + 1, device=x_axis.device),
        n,
    )
    dense = torch.zeros((*x_axis.shape, n), dtype=x_axis.dtype, device=x_axis.device)
    return dense.scatter_add_(-1, cols, w)


def _row_chunk(R: int, C: int, n: int) -> int:
    """Rows per chunk, so each dense (Rc, C, n) intermediate stays ~32 MB."""
    return min(R, max(8, (1 << 23) // max(C * n, 1)))


def gather_rows_einsum(Fe, x, n: int, m: int, beta: float):
    """``gather_kb_rows`` as ``tike_tpu`` computes it: Fe (n, n, n) at rows
    x (R, C, 3) whose x[..., 0] is constant along each row; (R, C)."""
    R, C, _ = x.shape
    G2 = torch.stack([Fe.real, Fe.imag])  # (2, n, n, n)
    out = []
    step = _row_chunk(R, C, n)
    for r0 in range(0, R, step):
        xc = x[r0 : r0 + step]
        w0 = dense_axis(xc[:, 0, 0], n, m, beta)  # (Rc, n)
        w1 = dense_axis(xc[..., 1], n, m, beta)  # (Rc, C, n)
        w2 = dense_axis(xc[..., 2], n, m, beta)
        U = torch.einsum("ry,jyab->jrab", w0, G2)
        V = torch.einsum("rca,jrab->jrcb", w1, U)
        out.append(torch.sum(w2[None] * V, dim=-1))  # (2, Rc, C)
    out = torch.cat(out, dim=1)
    return torch.complex(out[0], out[1])


def scatter_rows_einsum(f, x, n: int, m: int, beta: float):
    """``scatter_kb_rows`` as ``tike_tpu`` computes it: f (R, C) spread onto
    (n, n, n) by the transposed einsum chain."""
    R, C = f.shape
    f2 = torch.stack([f.real, f.imag])  # (2, R, C)
    S = torch.zeros((2, n, n, n), dtype=f2.dtype, device=f.device)
    step = _row_chunk(R, C, n)
    for r0 in range(0, R, step):
        xc = x[r0 : r0 + step]
        w0 = dense_axis(xc[:, 0, 0], n, m, beta)
        w1 = dense_axis(xc[..., 1], n, m, beta)
        w2 = dense_axis(xc[..., 2], n, m, beta)
        T1 = f2[:, r0 : r0 + step, :, None] * w2[None]  # (2, Rc, C, n)
        T2 = torch.einsum("rca,jrcb->jrab", w1, T1)
        S = S + torch.einsum("ry,jrab->jyab", w0, T2)
    return torch.complex(S[0], S[1])


def einsum_flops(R: int, C: int, n: int) -> int:
    """The multiply-adds (x 2) of the einsum chain of one gather or scatter
    of (R, C) rows: two (.., n) x (n, n^2)-shaped products per row chunk."""
    return 2 * 2 * (R * n * n * n + R * C * n * n)
