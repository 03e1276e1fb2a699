"""The patch kernels' checks, edge cases, bounds and library yardsticks.

``chip_smoke.py`` (phase 3) holds the CUDA kernels of
``tike_tpu_torch/csrc/patch.cu`` to their plain PyTorch versions with
these, ``tests/test_torch_patch_cuda.py`` does the same on the card, and
``tests/test_torch_patch.py`` checks the cases, the bounds and the library
calls on the CPU. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from tike_tpu_torch.ops import patch

# patch_fwd: a float32 4-term blend in both versions (the kernel uses FMA).
FWD_TOL = 1e-5
# patch_adj: the kernel adds overlapping windows in an order the inputs fix,
# the plain version's index_add_ with atomics in an order that varies from
# run to run; error relative to the largest |value| of the image.
ADJ_TOL = 1e-5
# The library yardsticks against the kernels: grid_sample normalises the
# sample coordinates in float32, which moves a sample by up to ~1e-4 px;
# error relative to the largest |value|.
LIBRARY_TOL = 1e-3
# NVIDIA's data sheet for the H100 SXM at 700 W: HBM3 bytes/s and float32
# flops/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# The main path's patch shapes: one batch of 1,000 windows of 128^2 on a
# 1500^2 object.
MAIN_N, MAIN_P, MAIN_HW = 1000, 128, 1500


def max_abs(a, b) -> float:
    return float(torch.max(torch.abs(a - b))) if a.numel() else 0.0


def max_value(x) -> float:
    return float(torch.max(torch.abs(x))) if x.numel() else 0.0


def _real_view(x):
    return torch.view_as_real(x) if x.is_complex() else x


def equal_bits(a, b) -> bool:
    return torch.equal(_real_view(a), _real_view(b))


def check_patch_kernels(image, positions, patches, p, name) -> dict:
    """Both CUDA kernels against their plain versions on these inputs (the
    adjoint with and without ``image`` as its initial image), each launched
    twice with bitwise-equal results. Raises on a difference; returns the
    largest errors."""
    shape = tuple(image.shape)
    got = patch.patch_fwd_cuda(image, positions, p)
    again = patch.patch_fwd_cuda(image, positions, p)
    want = patch.patch_fwd_plain(image, positions, p)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    if not equal_bits(got, again):
        raise AssertionError(f"patch_fwd ({name}): two launches differ")
    fwd_err = max_abs(got, want)
    adj_err = 0.0
    for init in (None, image):
        got = patch.patch_adj_cuda(patches, positions, shape, init)
        again = patch.patch_adj_cuda(patches, positions, shape, init)
        want = patch.patch_adj_plain(patches, positions, shape, init)
        torch.cuda.synchronize()
        err, scale = max_abs(got, want), max_value(want)
        label = f"patch_adj ({name}{'' if init is None else ', initial image'})"
        if not err <= ADJ_TOL * scale:
            raise AssertionError(
                f"{label} differs from its plain version by {err:.3e} > "
                f"{ADJ_TOL:g} x {scale:.3e}"
            )
        if not equal_bits(got, again):
            raise AssertionError(f"{label}: two launches differ")
        adj_err = max(adj_err, err)
    return {"patch_fwd": fwd_err, "patch_adj": adj_err}


def _quarter_positions(gen, n, lo, hi):
    """(n, 2) positions in [lo, hi) on a grid of quarter pixels."""
    return lo + gen.integers(0, 4 * (hi - lo), (n, 2)) / 4


# The kernels' edge cases: name -> (dtype, (H, W), P, positions from a
# generator). Corners may be negative or past the image.
EDGE_CASES = {
    "negative corners": (
        np.complex64, (96, 80), 16,
        lambda g: [[-5.25, 3.5], [2.75, -9.5], [-15.5, -15.75], [-0.5, -0.25],
                   [40.1, 30.7]],
    ),
    "windows wholly outside": (
        np.complex64, (96, 80), 16,
        lambda g: [[-40.5, 10.0], [10.0, -17.25], [96.0, 5.5], [5.5, 80.0],
                   [200.3, 300.7], [-17.01, -17.01], [30.5, 20.25]],
    ),
    "N = 0": (np.complex64, (64, 72), 16, lambda g: np.zeros((0, 2))),
    "N = 1": (np.complex64, (300, 290), 128, lambda g: [[50.3, 60.7]]),
    "P = 100": (np.complex64, (400, 380), 100, lambda g: g.uniform(-10, 310, (40, 2))),
    "odd P = 37": (np.complex64, (200, 210), 37, lambda g: g.uniform(-5, 180, (30, 2))),
    "float32, odd W": (np.float32, (203, 257), 33, lambda g: g.uniform(-3, 230, (30, 2))),
    # More windows on one tile than the adjoint's list holds. Quarter-pixel
    # positions and small integer patch values keep every sum exact, so
    # any order of summation gives the same image.
    "5,000 windows on one tile": (
        np.complex64, (256, 256), 32,
        lambda g: _quarter_positions(g, 5000, 60, 70),
    ),
}


def edge_case(name, device):
    """The image, positions and patches of ``EDGE_CASES[name]`` on
    ``device``, made from a seeded generator; and P."""
    dtype, (h, w), p, make_positions = EDGE_CASES[name]
    gen = np.random.default_rng(7)
    positions = np.asarray(make_positions(gen), np.float32).reshape(-1, 2)
    n = len(positions)
    if name.startswith("5,000"):
        values = lambda *shape: gen.integers(0, 4, shape).astype(np.float32)
    else:
        values = lambda *shape: gen.standard_normal(shape).astype(np.float32)
    image, patches = values(h, w), values(n, p, p)
    if dtype == np.complex64:
        image = image + 1j * values(h, w)
        patches = patches + 1j * values(n, p, p)
    as_t = lambda x: torch.tensor(np.asarray(x, dtype), device=device)
    return as_t(image), torch.tensor(positions, device=device), as_t(patches), p


def main_path_patch_inputs(device):
    """The image, positions and patches at the main path's shapes (seed
    0): a 1500^2 complex64 image, 1,000 positions (25 windows past the
    bottom or right edge) and 1,000 complex64 patches of 128^2."""
    n, p, hw = MAIN_N, MAIN_P, MAIN_HW
    gen = np.random.default_rng(0)
    image = torch.tensor(
        (gen.standard_normal((hw, hw)) + 1j * gen.standard_normal((hw, hw))).astype(
            np.complex64
        ),
        device=device,
    )
    pos = np.stack([gen.uniform(1, hw - p - 2, n), gen.uniform(1, hw - p - 2, n)], -1)
    # Windows past the bottom and right edges (those pixels read 0).
    pos[:10, 0] = gen.uniform(hw - p - 1, hw - 1, 10)
    pos[10:20, 1] = gen.uniform(hw - p - 1, hw - 1, 10)
    pos[20:25] = gen.uniform(hw - p - 1, hw - 1, (5, 2))
    positions = torch.tensor(pos.astype(np.float32), device=device)
    patches = torch.tensor(
        (gen.standard_normal((n, p, p)) + 1j * gen.standard_normal((n, p, p))).astype(
            np.complex64
        ),
        device=device,
    )
    return image, positions, patches


# The patch shapes of the joint-ADMM and the host-streamed paths (seed 0):
# name -> (windows, P, image side). At 16^2 the adjoint's tiles hold few and
# unevenly many windows; at 64^2 on 4096^2 one batch is 10,000 windows.
PATH_SHAPES = {
    "admm_joint angle (200 x 16^2 on 64^2)": (200, 16, 64),
    "stream_1m batch (10,000 x 64^2 on 4096^2)": (10_000, 64, 4096),
}


def path_shape_inputs(name, device, dtype=np.complex64):
    """The image, positions and patches of ``PATH_SHAPES[name]`` on
    ``device``, and P: positions drawn as ``bench_all.py`` draws its scans
    (uniform in [2, side - P - 3]), values standard normal."""
    n, p, hw = PATH_SHAPES[name]
    gen = np.random.default_rng(0)
    positions = gen.uniform(2, hw - p - 3, (n, 2)).astype(np.float32)

    def values(*shape):
        x = gen.standard_normal(shape, dtype=np.float32)
        if dtype == np.complex64:
            x = x + 1j * gen.standard_normal(shape, dtype=np.float32)
        return torch.tensor(x.astype(dtype), device=device)

    return values(hw, hw), torch.tensor(positions, device=device), values(n, p, p), p


def roofline(name, positions, p, shape, dtype) -> dict:
    """The least time kernel ``name`` (``patch_fwd`` or ``patch_adj``)
    could take on this card for these positions: the bytes it must move
    (``patch.roofline_bytes`` of what ``patch.needed_values`` counts: the
    image pixels the forward's windows touch, the patch values whose taps
    the adjoint adds into the image) over the HBM rate, or its float32
    flops (4 multiply-adds per real component of each patch value it
    makes or spreads) over the float32 rate, whichever is longer."""
    h, w = shape
    n = positions.shape[0]
    pixels, values = patch.needed_values(positions, p, h, w)
    if name == "patch_fwd":
        nbytes = patch.roofline_bytes(n, p, h, w, dtype, image_pixels=pixels)
        values = n * p * p
    else:
        nbytes = patch.roofline_bytes(n, p, h, w, dtype, patch_values=values)
    components = 2 if dtype.is_complex else 1
    flops = 4 * 2 * components * values
    by_bytes, by_flops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return dict(
        bound_bytes=nbytes,
        bound_ms=1e3 * max(by_bytes, by_flops),
        bound_by="bytes" if by_bytes >= by_flops else "operations",
    )


def grid_sample_inputs(image, positions, p):
    """``grid_sample``'s planar (1, 2, H, W) image and its (1, N P, P, 2)
    grid of (x, y) sample coordinates, normalised for align_corners=True:
    output (k, y, x) samples the image at positions[k] + (y, x)."""
    h, w = image.shape
    n = positions.shape[0]
    planar = torch.view_as_real(image).permute(2, 0, 1)[None].contiguous()
    span = torch.arange(p, device=image.device, dtype=torch.float32)
    gy = 2 * (positions[:, 0, None] + span) / (h - 1) - 1
    gx = 2 * (positions[:, 1, None] + span) / (w - 1) - 1
    grid = torch.stack(
        [gx[:, None, :].expand(n, p, p), gy[:, :, None].expand(n, p, p)], -1
    )
    return planar, grid.reshape(1, n * p, p, 2).contiguous()


def planar_to_complex(x, shape):
    """(1, 2, ...) planar float32 -> complex64 of ``shape``."""
    return torch.view_as_complex(x[0].movedim(0, -1).contiguous()).reshape(shape)


def check_library(name, got, kernel_out) -> float:
    """Raise unless a library call's output ``got`` agrees with the
    kernel's to LIBRARY_TOL of its largest value; return the error."""
    err, scale = max_abs(got, kernel_out), max_value(kernel_out)
    if not err <= LIBRARY_TOL * scale:
        raise AssertionError(
            f"{name}'s library call differs from the kernel by {err:.3e} > "
            f"{LIBRARY_TOL:g} x {scale:.3e}"
        )
    return err
