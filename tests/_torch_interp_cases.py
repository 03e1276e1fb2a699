"""Inputs and checks of the Lanczos remap kernels (``csrc/interp.cu``),
shared by ``tests/test_torch_interp_cuda.py`` and ``chip_smoke.py``.

No JAX here: this module runs on the card's machine. Each case is a stack
of images with points one set per image (the flow warp's layout) or one
set all images share (the rotation's), at a half-width m, complex64 or
float32, with or without a constant for taps outside the grid. The points
take every kind the kernels branch on: inside, on the grid's edges, outside
it (whole windows and parts), and on integer coordinates.

Tolerances, relative to the largest magnitude of the plain version's
result: the forward sums at most (2m+1)^2 taps in the plain version's
order, but with the card's ``sinf`` and fused multiply-adds, so the two
differ by a few float32 roundings (``FWD_TOL``); the adjoint's float
atomics add each grid value's taps in no fixed order (``ADJ_TOL``).
Adjointness <fwd(x), y> = <x, adj(y)> holds to ``ADJOINT_TOL`` relative.

``sine_pair_weights``, ``window_fwd`` and ``window_adj`` write out in
plain PyTorch what the kernels compute: the window that half-width m
reduces to (``interp.window``: every m >= 2 is m = 2's 4 x 4 taps), with
weights from one sine pair an axis.
"""

from __future__ import annotations

import numpy as np
import torch

from tike_tpu_torch import kernels
from tike_tpu_torch.ops import interp

FWD_TOL = 1e-5
ADJ_TOL = 1e-5
ADJOINT_TOL = 1e-5

# The paths' full width: 128 projections of 1024^2 (chip_smoke.py phase 19c).
FULL_IMAGES, FULL_N = 128, 1024
# The golden alignment dataset's shape (tests/data/algin_setup.pickle.lzma).
GOLDEN_N = 128


def _points(gen, images, n, h, w, shared):
    """Points over [-3, h + 2) x [-3, w + 2): some outside, some with parts
    of their windows outside; a tenth on integer coordinates and a few on
    the grid's last row and column."""
    shape = (n, 2) if shared else (images, n, 2)
    pts = np.stack(
        [gen.uniform(-3, h + 2, shape[:-1]), gen.uniform(-3, w + 2, shape[:-1])], -1
    )
    k = max(n // 10, 1)
    pts[..., :k, :] = np.round(pts[..., :k, :])
    pts[..., k : k + 2, 0] = h - 1
    pts[..., k + 2 : k + 4, 1] = w - 1
    return pts.astype(np.float32)


CASES = {
    # name: (images, h, w, n points, m, complex, cval, shared points)
    "m1 complex": (3, 40, 33, 500, 1, True, 0.0, False),
    "m2 complex, cval": (3, 40, 33, 500, 2, True, 0.3 - 0.2j, False),
    "m1 real, cval": (2, 31, 45, 400, 1, False, 0.7, False),
    "m2 real": (2, 31, 45, 400, 2, False, 0.0, False),
    "m2 complex, shared points (rotate)": (4, 36, 36, 36 * 36, 2, True, 0.0, True),
    "m0 complex": (2, 20, 20, 300, 0, True, 0.0, False),
    "m5 complex, cval (run-time m)": (2, 30, 30, 300, 5, True, 0.5j, False),
    # A flow warp's filter_size of 22 or 23: far more taps than any register
    # array of weights would hold.
    "m11 real, cval (run-time m)": (2, 26, 21, 300, 11, False, -0.4, False),
    "one image, one point": (1, 8, 8, 1, 2, True, 0.0, False),
    "no points": (2, 8, 8, 0, 2, True, 0.0, False),
}


def case_inputs(name: str, device, seed: int = 0):
    """(images (I, H, W), points, values (I, N), m, cval) of case ``name``
    on ``device``."""
    images, h, w, n, m, is_complex, cval, shared = CASES[name]
    gen = np.random.default_rng(seed)
    f = gen.standard_normal((images, h, w))
    v = gen.standard_normal((images, n))
    if is_complex:
        f = f + 1j * gen.standard_normal((images, h, w))
        v = v + 1j * gen.standard_normal((images, n))
    dtype = np.complex64 if is_complex else np.float32
    return (
        torch.as_tensor(f.astype(dtype), device=device),
        torch.as_tensor(_points(gen, images, n, h, w, shared), device=device),
        torch.as_tensor(v.astype(dtype), device=device),
        m,
        cval,
    )


def smooth_flow(gen, images: int, n: int, device, amplitude: float = 3.0, cells: int = 8):
    """(images, n, n, 2) float32 displacements of about +-amplitude pixels:
    a random cells x cells field from ``gen``, upsampled bicubically on
    ``device``."""
    coarse = torch.as_tensor(
        amplitude * gen.uniform(-1, 1, (images, 2, cells, cells)), dtype=torch.float32,
        device=device,
    )
    fine = torch.nn.functional.interpolate(
        coarse, size=(n, n), mode="bicubic", align_corners=True
    )
    return fine.permute(0, 2, 3, 1).contiguous()


def flow_points(flow: torch.Tensor) -> torch.Tensor:
    """The flow warp's sample points (I, H*W, 2) of displacements (I, H,
    W, 2), as ``ops.flow`` computes them."""
    from tike_tpu_torch.ops.flow import _flow_coords

    return _flow_coords(flow)


def rotate_points(n: int, angle: float, device) -> torch.Tensor:
    """The rotation's shared points (n*n, 2), as ``ops.rotate`` computes
    them."""
    from tike_tpu_torch.ops.rotate import _rotated_grid

    return _rotated_grid((n, n), angle, device)


def full_width_inputs(device, images: int = FULL_IMAGES, n: int = FULL_N, seed: int = 0):
    """The paths' shapes: a stack of complex64 images, the flow warp's
    per-image points (m = 2) and the rotation's shared points, and values
    to spread back."""
    gen = np.random.default_rng(seed)
    stack = torch.complex(
        torch.randn((images, n, n), generator=torch.Generator(device).manual_seed(seed),
                    device=device),
        torch.randn((images, n, n), generator=torch.Generator(device).manual_seed(seed + 1),
                    device=device),
    )
    flow = smooth_flow(gen, images, n, device)
    return dict(
        images=stack,
        flow=flow_points(flow).contiguous(),
        rotate=rotate_points(n, 0.05, device).contiguous(),
    )


def sine_pair_weights(f: torch.Tensor, offsets) -> torch.Tensor:
    """(..., len(offsets)) float32 Lanczos weights at fractions f in [0, 1]
    (float32) as ``csrc/interp.cu`` computes them: s, c = sin, cos(pi f /
    2) (``sincospif``, correctly rounded here through float64), then in
    float32 (4 / pi^2) s c times c for odd offsets and s for even ones,
    signed (-, +, +, -) for offsets -1, 0, 1, 2, over d^2, d = f - o; 1
    where |d| < 1e-12."""
    half = (0.5 * f.to(torch.float64)) * np.pi
    s = torch.sin(half).to(torch.float32)
    c = torch.cos(half).to(torch.float32)
    sc = torch.tensor(4 / np.pi**2, dtype=torch.float32) * s * c
    odd, even = sc * c, sc * s
    numerators = {-1: -odd, 0: even, 1: odd, 2: -even}
    out = []
    for o in offsets:
        d = f - torch.tensor(float(o), dtype=torch.float32)
        out.append(torch.where(torch.abs(d) < 1e-12, 1.0, numerators[o] / (d * d)))
    return torch.stack(out, -1)


def _window_taps(x: torch.Tensor, m: int):
    """(first row, first column, wy, wx) of every point's window: the
    origins (..., ) int64 and the weights (..., K)."""
    k, lo = interp.window(m)
    fl = torch.floor(x)
    frac = x - fl
    offsets = range(lo, lo + k)
    return (
        fl[..., 0].to(torch.int64) + lo,
        fl[..., 1].to(torch.int64) + lo,
        sine_pair_weights(frac[..., 0], offsets),
        sine_pair_weights(frac[..., 1], offsets),
    )


def window_fwd(images: torch.Tensor, points: torch.Tensor, m: int, cval=0.0) -> torch.Tensor:
    """The forward kernel's sum in plain PyTorch: images (I, H, W), points
    (I, N, 2) or (N, 2); each point's window summed row by row, sum_i wy[i]
    (sum_j wx[j] v[i, j]), taps outside the grid reading cval."""
    i, h, w = images.shape
    pts = points if points.dim() == 3 else points[None].expand(i, -1, -1)
    row0, col0, wy, wx = _window_taps(pts, m)
    k = wy.shape[-1]
    flat = images.reshape(i, h * w)
    acc = torch.zeros(pts.shape[:-1], dtype=images.dtype)
    for a in range(k):
        line = torch.zeros_like(acc)
        for b in range(k):
            row, col = row0 + a, col0 + b
            inside = (row >= 0) & (row < h) & (col >= 0) & (col < w)
            idx = (row.clamp(0, h - 1) * w + col.clamp(0, w - 1))
            v = torch.where(inside, torch.gather(flat, 1, idx), torch.tensor(cval, dtype=images.dtype))
            line = line + wx[..., b] * v
        acc = acc + wy[..., a] * line
    return acc


def window_adj(values: torch.Tensor, points: torch.Tensor, m: int, grid_shape) -> torch.Tensor:
    """The adjoint kernels' taps in plain PyTorch: values (I, N) spread
    onto (I, H, W) grids, wx[j] (wy[i] v) a tap, taps outside dropped."""
    h, w = grid_shape
    i = values.shape[0]
    pts = points if points.dim() == 3 else points[None].expand(i, -1, -1)
    row0, col0, wy, wx = _window_taps(pts, m)
    k = wy.shape[-1]
    grid = torch.zeros((i, h * w), dtype=values.dtype)
    for a in range(k):
        rv = wy[..., a] * values
        for b in range(k):
            row, col = row0 + a, col0 + b
            inside = (row >= 0) & (row < h) & (col >= 0) & (col < w)
            idx = (row.clamp(0, h - 1) * w + col.clamp(0, w - 1))
            grid.scatter_add_(1, idx, torch.where(inside, wx[..., b] * rv, 0))
    return grid.reshape(i, h, w)


def _max_rel(got, want) -> tuple:
    err = float(torch.max(torch.abs(got - want))) if want.numel() else 0.0
    scale = float(torch.max(torch.abs(want))) if want.numel() else 1.0
    return err, err / max(scale, 1e-30)


def inner(a: torch.Tensor, b: torch.Tensor) -> complex:
    """<a, b> summed in double precision: the float32 values' own rounding
    is then all the adjointness gap sees."""
    wide = torch.complex128 if a.is_complex() or b.is_complex() else torch.float64
    return complex(torch.sum(a.to(wide) * b.to(wide).conj()))


def check_lanczos_kernels(images, points, values, m, cval, label="") -> dict:
    """Each kernel against its plain version on one case (forward with
    ``cval``, adjoint), and adjointness of the kernels (cval 0); raises on
    a miss. Returns each kernel's max |err| and the adjointness gap."""
    h, w = images.shape[-2:]
    fwd = interp.remap_lanczos_fwd_cuda(images, points, m, cval)
    fwd_plain = interp.remap_lanczos_fwd_plain(images, points, m, cval)
    adj = interp.remap_lanczos_adj_cuda(values, points, m, (h, w))
    adj_plain = interp.remap_lanczos_adj_plain(values, points, m, (h, w))
    torch.cuda.synchronize()
    out = {}
    for name, got, want, tol in (
        ("lanczos_fwd", fwd, fwd_plain, FWD_TOL),
        ("lanczos_adj", adj, adj_plain, ADJ_TOL),
    ):
        assert got.shape == want.shape and got.dtype == want.dtype, (label, name)
        err, rel = _max_rel(got, want)
        if not rel <= tol:
            raise AssertionError(
                f"{label}: {name} differs from its plain version by {err:.3e} "
                f"({rel:.3e} of the largest value; tol {tol:g})"
            )
        out[name] = err
    lin = interp.remap_lanczos_fwd_cuda(images, points, m, 0.0)
    a, b = inner(lin, values), inner(images, adj)
    gap = abs(a - b) / max(abs(a), 1e-30)
    if values.numel() and not gap <= ADJOINT_TOL:
        raise AssertionError(f"{label}: adjointness gap {gap:.3e} (tol {ADJOINT_TOL:g})")
    out["adjointness"] = gap if values.numel() else 0.0
    return out


def first_form_fwd(images, points, m: int, cval=0.0):
    """The forward of ``csrc/interp_first_form.cu`` (the kernels before
    their redesign, a yardstick) on (I, H, W) images: (I, N)."""
    i, h, w = images.shape
    out = torch.empty((i, points.shape[-2]), dtype=images.dtype, device=images.device)
    cval = complex(cval)
    rc = kernels.load("interp_first_form").tike_lanczos_first_form_fwd(
        images.data_ptr(), points.data_ptr(), out.data_ptr(), i, points.shape[-2], h, w, m,
        int(points.dim() == 2), 2 if images.is_complex() else 1, cval.real, cval.imag,
        torch.cuda.current_stream().cuda_stream,
    )
    if rc:
        raise RuntimeError(f"lanczos first form fwd: CUDA error {rc}")
    return out


def first_form_adj(values, points, m: int, grid_shape):
    """The adjoint of ``csrc/interp_first_form.cu`` on (I, N) values: (I,
    H, W)."""
    h, w = grid_shape
    i, n = values.shape
    grid = torch.zeros((i, h, w), dtype=values.dtype, device=values.device)
    rc = kernels.load("interp_first_form").tike_lanczos_first_form_adj(
        values.data_ptr(), points.data_ptr(), grid.data_ptr(), i, n, h, w, m,
        int(points.dim() == 2), 2 if values.is_complex() else 1,
        torch.cuda.current_stream().cuda_stream,
    )
    if rc:
        raise RuntimeError(f"lanczos first form adj: CUDA error {rc}")
    return grid


def grid_sample_calls(images, points, values):
    """The library yardsticks, one PyTorch call each on the same inputs:
    bicubic ``grid_sample`` for the forward and its input gradient
    (``grid_sampler_2d_backward``) for the adjoint. Complex images are two
    channels; points become grid_sample's normalized (x, y), corners
    aligned. Inputs are converted here, outside what is timed."""
    i, h, w = images.shape
    pts = points if points.dim() == 3 else points[None].expand(i, -1, -1)
    grid = torch.stack(
        [pts[..., 1] * (2.0 / (w - 1)) - 1, pts[..., 0] * (2.0 / (h - 1)) - 1], -1
    )[:, None].contiguous()  # (I, 1, N, 2)
    x = torch.view_as_real(images).permute(0, 3, 1, 2).contiguous()  # (I, 2, H, W)
    g = torch.view_as_real(values).permute(0, 2, 1)[:, :, None].contiguous()  # (I, 2, 1, N)

    def fwd():
        return torch.nn.functional.grid_sample(
            x, grid, mode="bicubic", padding_mode="zeros", align_corners=True
        )

    def adj():
        return torch.ops.aten.grid_sampler_2d_backward(g, x, grid, 2, 0, True, [True, False])[0]

    return {"lanczos_fwd": fwd, "lanczos_adj": adj}


def bound(kernel: str, images, points, m: int) -> dict:
    """:func:`interp.roofline` of one launch on these inputs."""
    i, h, w = images.shape
    return interp.roofline(
        kernel, i, points.shape[-2], h, w, m, images.is_complex(), points.dim() == 2
    )
