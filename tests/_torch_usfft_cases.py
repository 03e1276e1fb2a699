"""The USFFT kernels' checks, inputs, bounds and einsum yardstick, for the
Kaiser-Bessel and the Gaussian window.

``chip_smoke.py`` holds the CUDA kernels of ``tike_tpu_torch/csrc/usfft.cu``
to their plain PyTorch versions with these, ``tests/test_torch_usfft_cuda.py``
and ``tests/test_torch_usfft_gaussian_cuda.py`` do the same on the card, and
``tests/test_torch_usfft.py``, ``test_torch_usfft_plan.py`` and
``test_torch_usfft_gaussian.py`` check the inputs, the plans, the bounds and
the einsum formulation on the CPU (against ``tike_tpu``). The Gaussian
kernels of ``csrc/usfft_gaussian.cu`` are written out in plain code in
their own summation order (``gather_gaussian_kernel_order``,
``scatter_gaussian_kernel_order``), and their yardstick, the first form
(the KB kernels of ``csrc/usfft.cu`` on a Gaussian plan), is launched by
``first_form_gather`` and ``first_form_scatter``. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from tike_tpu_torch import kernels
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
# NVIDIA's data sheet for the H100 SXM at 700 W: 67e12 float32 operations a
# second outside the tensor cores, a fused multiply-add counted as two, so
# 33.45e12 FP32 instructions.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
FP32_INSTRUCTIONS_PER_S = 33.45e12

# bench_all.py's laminography (lamino_cgrad, lamino_cgls): a 128^3 volume,
# 64 angles over [0, pi), tilt pi/3, eps 1e-3, upsample 1.
LAMINO_N, LAMINO_NTHETA, LAMINO_TILT, LAMINO_EPS = 128, 64, np.pi / 3, 1e-3


def lamino_theta(ntheta: int, device=None) -> torch.Tensor:
    return torch.as_tensor(
        np.linspace(0, np.pi, ntheta, endpoint=False).astype(np.float32), device=device
    )


def lamino_rows(n: int, ntheta: int, device=None, tilt=LAMINO_TILT) -> torch.Tensor:
    """The (ntheta n, n, 3) row-structured points of a laminography
    transform of an n^3 volume (``bench_all.py``'s tilt unless given; at
    tilt pi/2, tomography, each detector row's points lie in one plane of
    the grid, so the scatter's bins are very uneven)."""
    theta = lamino_theta(ntheta, device)
    return lamino.make_grids(theta, n, tilt).reshape(ntheta * n, n, 3)


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


def gaussian_window_for(n_volume: int, eps: float, upsample: float):
    """(grid size, m, mu) of the Gaussian window of a transform."""
    upsampled, _, mu, m = usfft.usfft_parameters(n_volume, eps, upsample)
    return upsampled, m, mu


def max_rel(a, b) -> float:
    scale = float(torch.max(torch.abs(b))) if b.numel() else 0.0
    return float(torch.max(torch.abs(a - b))) / scale if scale else 0.0


def inner64(a, b) -> complex:
    """<a, b> = sum(conj(a) b), in complex128."""
    return complex(torch.sum(torch.conj(a.to(torch.complex128)) * b.to(torch.complex128)))


# Each window's (CUDA gather, CUDA scatter, plain gather, plain scatter).
# Each window's launch counts in usfft.LAUNCHES, (gather, scatter).
COUNTS = {
    "kb": ("usfft_gather_kb", "usfft_scatter_kb"),
    "gaussian": ("usfft_gather_gaussian", "usfft_scatter_gaussian"),
}

WINDOW_CALLS = {
    "kb": (usfft.gather_kb_cuda, usfft.scatter_kb_cuda,
           usfft.gather_kb_plain, usfft.scatter_kb_plain),
    "gaussian": (usfft.gather_gaussian_cuda, usfft.scatter_gaussian_cuda,
                 usfft.gather_gaussian_plain, usfft.scatter_gaussian_plain),
}


def check_kernels(grid, x, f, n, m, param, name, window="kb") -> dict:
    """Both CUDA kernels on ``window``'s plans against their plain versions
    on these inputs (grid (n, n, n), points x (N, 3), values f (N,)), each
    launched twice on one prebuilt plan with bitwise-equal results and once
    more building its own plan, again bitwise equal, and <gather(grid), f>
    = <grid, scatter(f)>. Raises on a difference; returns the relative
    errors (by kernel name and ``adjoint``) and the absolute ones
    (``<name>_abs``)."""
    gather, scatter, gather_plain, scatter_plain = WINDOW_CALLS[window]
    gather_name, scatter_name = COUNTS[window]
    plan = usfft.geometry_plan(x, n, m, param, window=window)
    got = gather(grid, x, n, m, param, plan)
    spread = scatter(f, x, n, m, param, plan)
    repeats = {
        gather_name: (got, gather(grid, x, n, m, param, plan), gather(grid, x, n, m, param)),
        scatter_name: (spread, scatter(f, x, n, m, param, plan), scatter(f, x, n, m, param)),
    }
    want = gather_plain(grid, x, n, m, param)
    spread_want = scatter_plain(f, x, n, m, param)
    torch.cuda.synchronize()
    out = {gather_name: max_rel(got, want), scatter_name: max_rel(spread, spread_want)}
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
    out[f"{gather_name}_abs"] = float(torch.max(torch.abs(got - want))) if x.shape[0] else 0.0
    out[f"{scatter_name}_abs"] = float(torch.max(torch.abs(spread - spread_want)))
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


# csrc/usfft_gaussian.cu's kThreadGatherMaxM (a thread a point in the
# gather up to this m): tests/test_torch_usfft_gaussian_kernels.py holds it to
# the source.
THREAD_GATHER_MAX_M = 2


def _group_width(taps: int) -> int:
    """The lanes a Gaussian kernel gives a point along axis 2: 2m rounded
    up to a power of two."""
    return 1 << (taps - 1).bit_length()


def gather_gaussian_kernel_order(Fe, plan) -> torch.Tensor:
    """The gather as ``csrc/usfft_gaussian.cu`` computes it, in float32 (the
    kernels fuse each multiply-add, which rounds once where this rounds
    twice), written through ``order``. Up to ``THREAD_GATHER_MAX_M``
    (``gaussian_gather_thread_kernel``): sum over j0 of w0[j0] times the sum
    over j1 of w1[j1] times the sum over j2 of w2[j2] G[j0, j1, j2], each in
    ascending order. Above (``gaussian_gather_kernel``), for each axis-2 tap
    j (a lane): sum over j0 of w0[j0] times the sum over j1 of w1[j1] G[j0,
    j1, j], in ascending order; times w2[j]; then the lanes added by a
    butterfly (at 2m = 8 ((t0 + t4) + (t2 + t6)) + ((t1 + t5) + (t3 +
    t7)))."""
    n, m = plan.n, plan.m
    taps = 2 * m
    width = _group_width(taps)
    bins = plan.bins.long()
    base = torch.stack([bins // (n * n), (bins // n) % n, bins % n], dim=1)
    cells = torch.remainder(base[:, :, None] + torch.arange(1 - m, m + 1, device=bins.device), n)
    w = plan.weights.permute(2, 0, 1)  # (N, 3, 2m) views of the (3, 2m, N) table
    grid = torch.view_as_real(Fe.contiguous())
    npoints = plan.npoints
    if m <= THREAD_GATHER_MAX_M:
        acc = torch.zeros((npoints, 2), dtype=grid.dtype, device=grid.device)
        for j0 in range(taps):
            sum1 = torch.zeros_like(acc)
            for j1 in range(taps):
                sum2 = torch.zeros_like(acc)
                for j2 in range(taps):
                    v = grid[cells[:, 0, j0], cells[:, 1, j1], cells[:, 2, j2]]
                    sum2 = sum2 + w[:, 2, j2, None] * v
                sum1 = sum1 + w[:, 1, j1, None] * sum2
            acc = acc + w[:, 0, j0, None] * sum1
        out = torch.empty_like(acc)
        out[plan.order.long()] = acc
        return torch.view_as_complex(out)
    acc = torch.zeros((npoints, taps, 2), dtype=grid.dtype, device=grid.device)
    for j0 in range(taps):
        s = torch.zeros_like(acc)
        for j1 in range(taps):
            v = grid[cells[:, 0, j0, None], cells[:, 1, j1, None], cells[:, 2, :]]
            s = s + w[:, 1, j1, None, None] * v
        acc = acc + w[:, 0, j0, None, None] * s
    t = acc * w[:, 2, :, None]
    t = torch.cat([t, torch.zeros((npoints, width - taps, 2), dtype=t.dtype, device=t.device)], 1)
    offset = width // 2
    while offset:
        t = t + t[:, torch.arange(width, device=t.device) ^ offset]
        offset //= 2
    out = torch.empty((npoints, 2), dtype=t.dtype, device=t.device)
    out[plan.order.long()] = t[:, 0]
    return torch.view_as_complex(out)


# csrc/usfft_gaussian.cu's kScatterWarps: the warps of a scatter block, each
# with its copy of the band.
SCATTER_WARPS = 4


def _scan_runs(t, key):
    """The segmented inclusive scan of the scatter's chunk over its lanes
    (t (..., lanes, 2) float32; runs of equal ``key``), by the same shuffle
    steps: at step d a lane d or more past its run's start adds the value d
    lanes below, all lanes at once."""
    lanes = len(key)
    heads = np.ones(lanes, bool)
    heads[1:] = key[1:] != key[:-1]
    dist = np.arange(lanes) - np.maximum.accumulate(np.where(heads, np.arange(lanes), 0))
    d = 1
    while d <= dist.max():
        below = np.zeros_like(t)
        below[..., d:, :] = t[..., :-d, :]
        t = np.where((dist >= d)[:, None], (t + below).astype(np.float32), t)
        d *= 2
    return t


def scatter_gaussian_kernel_order(f, plan) -> torch.Tensor:
    """The scatter as ``gaussian_scatter_kernel`` computes it, in float32 on
    the host: each block, rows c1 ... c1 + rows - 1 of a plane c0 (the
    plan's ``blocks``), walks the rows of bins that reach it, axis-0 tap j0
    outermost, then along axis 1, 32 rows of bins at a time; their points in
    the plan's order 32 at a time are the batch's items, item k going to
    warp k mod ``SCATTER_WARPS``, which adds it to its own copy of the band
    tap by tap and row by row, each run of equal b2 summed by the scan's
    tree (``_scan_runs``), each term w1 (w2 (w0 v)); the copies are added
    in the warps' order. For small grids."""
    n, m = plan.n, plan.m
    taps = 2 * m
    bins, order = plan.bins.cpu().numpy().astype(np.int64), plan.order.cpu().numpy()
    start = plan.bin_start.cpu().numpy().astype(np.int64)
    w = plan.weights.cpu().numpy()
    values = f.cpu().numpy()[order]
    v = np.stack([values.real, values.imag], -1).astype(np.float32)
    grid = np.zeros((n, n, n, 2), np.float32)
    for first_row, rows in plan.blocks.cpu().tolist():
        c0, c1 = divmod(first_row, n)
        span1 = rows + taps - 1
        copies = np.zeros((SCATTER_WARPS, rows * n, 2), np.float32)
        item = 0  # the chunk's place among its batch's items
        for place in range(taps * span1):
            if place % 32 == 0:
                item = 0
            j0, h1 = divmod(place, span1)
            bin_row = (((c0 + m - 1 - j0) % n) * n + (c1 - m + h1) % n) * n
            t1 = np.arange(max(0, h1 - taps + 1), min(rows - 1, h1) + 1)
            for chunk in range(start[bin_row], start[bin_row + n], 32):
                p = np.arange(chunk, min(chunk + 32, start[bin_row + n]))
                b2 = bins[p] - bin_row
                tail = np.ones(len(p), bool)
                tail[:-1] = b2[1:] != b2[:-1]
                u = (w[0, j0, p, None] * v[p]).astype(np.float32)
                wu = (w[2, :, p].T[:, :, None] * u).astype(np.float32)  # (taps, lanes, 2)
                # (rows, taps, lanes, 2): every term.
                a = w[1, t1[:, None] - h1 + taps - 1, p]
                term = (a[:, None, :, None] * wu).astype(np.float32)
                copy = copies[item % SCATTER_WARPS]
                item += 1
                total = _scan_runs(term, b2)[:, :, tail]
                for tap in range(taps):
                    index = t1[:, None] * n + (b2[tail] + 1 - m + tap) % n
                    copy[index] = (copy[index] + total[:, tap]).astype(np.float32)
        band = copies[0]
        for more in copies[1:]:
            band = (band + more).astype(np.float32)
        grid[c0, c1:c1 + rows] = band.reshape(rows, n, 2)
    return torch.view_as_complex(torch.as_tensor(grid))


def first_form_gather(grid, plan) -> torch.Tensor:
    """The first form's gather (``kb_gather_kernel`` of ``csrc/usfft.cu``)
    on a Gaussian plan: the yardstick, counted nowhere."""
    out = torch.empty(plan.npoints, dtype=torch.complex64, device=grid.device)
    rc = kernels.load("usfft").tike_kb_gather(
        grid.data_ptr(), plan.bins.data_ptr(), plan.order.data_ptr(), plan.weights.data_ptr(),
        out.data_ptr(), plan.npoints, plan.n, plan.m, torch.cuda.current_stream().cuda_stream,
    )
    if rc:
        raise RuntimeError(f"kb_gather: CUDA error {rc}")
    return out


def first_form_scatter(f, plan) -> torch.Tensor:
    """The first form's scatter (``kb_scatter_kernel``) on a Gaussian plan
    in bin order, counted nowhere."""
    n = plan.n
    grid = torch.empty((n, n, n), dtype=torch.complex64, device=f.device)
    rc = kernels.load("usfft").tike_kb_scatter(
        f.data_ptr(), plan.bins.data_ptr(), plan.order.data_ptr(), plan.bin_start.data_ptr(),
        plan.weights.data_ptr(), grid.data_ptr(), plan.npoints, n, plan.m,
        torch.cuda.current_stream().cuda_stream,
    )
    if rc:
        raise RuntimeError(f"kb_scatter: CUDA error {rc}")
    return grid


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


def gaussian_roofline(name: str, x, n: int, m: int) -> dict:
    """The least time the card could take for a Gaussian gather or scatter
    of the points x (N, 3) on an n^3 grid, pipe by pipe: the bytes it must
    move (``usfft.roofline_bytes``; the gather's grid bytes from the cells
    the Gaussian's taps touch) at the HBM rate, and the FP32 instructions of
    ``usfft.fp32_instructions`` at the card's FP32 instruction rate; the
    bound is the larger."""
    npoints = x.shape[0]
    cells = usfft.touched_cells(x, n, m, "gaussian") if "gather" in name else None
    nbytes = usfft.roofline_bytes(name, npoints, n, cells)
    instructions = usfft.fp32_instructions(npoints, m)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    fp32_ms = 1e3 * instructions / FP32_INSTRUCTIONS_PER_S
    return {
        "bound_bytes": nbytes,
        "bound_bytes_ms": bytes_ms,
        "bound_fp32_instructions": instructions,
        "bound_fp32_ms": fp32_ms,
        "bound_ms": max(bytes_ms, fp32_ms),
        "bound_by": "bytes" if bytes_ms >= fp32_ms else "operations",
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
