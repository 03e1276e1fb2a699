"""Inputs and checks of the Gaussian model's far-field step
(``tike_tpu_torch/ops/objective.py::gaussian_farplane``) and its CUDA kernel
(``csrc/farplane.cu``), shared by the CPU tests, the card's tests and
``kernel_sweep --source farplane``. Imports no JAX.

The inputs are made with numpy from a seed: a farplane of random complex
values with every mode zero on a strip of pixels (zero intensity there),
data near the farplane's own intensity with some zeros, and a mask that
leaves about a tenth of the pixels unmeasured where a case asks.
"""

from __future__ import annotations

import numpy as np
import torch

from tike_tpu_torch.ops import objective

# name -> (mode axes, D, unmeasured pixels, unmeasured_pixels_scaling)
CASES = {
    "lsqml 1 mode": ((1, 1), 128, False, 1.0),
    "lsqml 1 mode, unmeasured": ((1, 1), 128, True, 1.0),
    "rpie 3 modes": ((3,), 128, False, 1.0),
    "rpie 3 modes, unmeasured, s 0.5": ((3,), 128, True, 0.5),
    "lsqml 3 modes, unmeasured, s 0.5": ((1, 3), 128, True, 0.5),
    "rpie 4 modes, unmeasured": ((4,), 128, True, 1.0),
    # D^2 even but D not a multiple of 8: pairs of pixels.
    "D 100, 2 modes, unmeasured": ((2,), 100, True, 0.5),
    # D^2 odd: one pixel at a time; 5 modes: read twice, not held.
    "D 45, 5 modes, unmeasured": ((5,), 45, True, 0.5),
    "D 45, 1 mode": ((1,), 45, False, 1.0),
}

# Kernel against the plain version on the card, each relative to the
# largest magnitude: the kernel sums the intensity and the costs in
# another order (and with fused multiply-adds), a few float32 roundings.
CHI_TOL = 1e-5
COST_TOL = 1e-5

# The main path's shapes: 1,000 patterns of 128^2 with 1 and 3 modes.
MAIN_PATTERNS, MAIN_D = 1000, 128


def inputs(mode_axes, d, unmeasured, b=16, seed=0, device="cpu"):
    """(data, farplane, measured_pixels) on ``device``."""
    gen = np.random.default_rng(seed)
    shape = (b, *mode_axes, d, d)
    farplane = (gen.standard_normal(shape) + 1j * gen.standard_normal(shape)).astype(np.complex64)
    farplane[..., 1, : d // 4] = 0  # zero intensity, measured or not
    intensity = np.sum(np.abs(farplane) ** 2, axis=tuple(range(1, farplane.ndim - 2)))
    data = (intensity * gen.uniform(0.5, 1.5, intensity.shape)).astype(np.float32)
    data[:, 2, : d // 3] = 0
    mask = np.ones((d, d), bool)
    if unmeasured:
        mask = gen.random((d, d)) > 0.1
    return (
        torch.from_numpy(data).to(device),
        torch.from_numpy(farplane).to(device),
        torch.from_numpy(mask).to(device),
    )


def case_inputs(name, device, b=16, seed=0):
    """``inputs`` of the case ``name`` and its scaling."""
    mode_axes, d, unmeasured, scaling = CASES[name]
    return (*inputs(mode_axes, d, unmeasured, b=b, seed=seed, device=device), scaling)


def gaps(got, want):
    """Largest gaps of (costs, chi) against the wanted pair, each relative to
    the wanted one's largest magnitude."""
    out = []
    for g, w in zip(got, want):
        scale = max(float(torch.max(torch.abs(w))), 1e-30)
        out.append(float(torch.max(torch.abs(g - w))) / scale)
    return tuple(out)


def bound_bytes(patterns: int, modes: int, d: int) -> int:
    """The bytes the step must move at the least: the farplane read and
    chi written (complex64), the data read (float32), the mask read (a
    byte a pixel) and the costs written (float32)."""
    pixels = d * d
    return 2 * patterns * modes * pixels * 8 + patterns * pixels * 4 + pixels + patterns * 4


def check_kernel(data, farplane, mask, scaling, tag=""):
    """The kernel against the plain version on the card: within the
    tolerances, chi written over the farplane given it, and two launches on
    copies of one farplane the same bit for bit. ``farplane`` itself is
    left as it was. Returns the gaps."""
    want = objective.gaussian_farplane_plain(data, farplane, mask, scaling)
    field = farplane.clone()
    got = objective.gaussian_farplane_cuda(data, field, mask, scaling)
    again = objective.gaussian_farplane_cuda(data, farplane.clone(), mask, scaling)
    torch.cuda.synchronize()
    assert got[1].data_ptr() == field.data_ptr(), tag
    assert got[1].shape == farplane.shape, tag
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all(), tag
    cost_gap, chi_gap = gaps(got, want)
    assert cost_gap <= COST_TOL, (tag, cost_gap)
    assert chi_gap <= CHI_TOL, (tag, chi_gap)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]), tag
    return cost_gap, chi_gap
