"""Alignment quickstart: rigid registration by phase cross-correlation.

The port's counterpart of ``examples/align.py``: shift a stack of images,
recover the shifts with the upsampled-DFT cross-correlation solver on the
card, and invert the warp. The warp is a shift only, so no Lanczos kernel
runs.

Run: python examples/torch/align.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import tike_tpu_torch.align  # noqa: E402


def problem(n=4, size=64, seed=0):
    """``(original, true_shift)``: ``n`` smooth complex64 images of
    ``size``^2 and shifts of up to 3 px, from ``seed``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    original = np.stack(
        [np.exp(1j * (np.sin(7 * yy + k) * np.cos(5 * xx))).astype(np.complex64) for k in range(n)]
    )
    true_shift = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    return original, true_shift


def main(n=4, size=64, *, device="cuda"):
    """Run the example; returns ``{"unaligned", "shift", "true_shift",
    "max_shift_error", "residual"}``."""
    original, true_shift = problem(n, size)
    unaligned = tike_tpu_torch.align.simulate(
        original, shift=true_shift, flow=None, padded_shape=None, angle=None, device=device
    )
    result = tike_tpu_torch.align.reconstruct(
        original=original,
        unaligned=unaligned,
        algorithm="cross_correlation",
        upsample_factor=16,
        device=device,
    )
    shift = np.asarray(result["shift"])
    err = float(np.abs(shift - true_shift).max())
    print("true shifts:\n", np.round(true_shift, 2))
    print("recovered:\n", np.round(shift, 2))
    print(f"max shift error: {err:.2f} px")

    realigned = tike_tpu_torch.align.invert(
        unaligned, shift=shift, flow=None, unpadded_shape=None, angle=None, device=device
    )
    res = float(np.linalg.norm(realigned - original) / np.linalg.norm(original))
    print(f"residual after inverting the warp: {res:.3f}")
    return dict(unaligned=unaligned, shift=shift, true_shift=true_shift,
                max_shift_error=err, residual=res)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    main(device=parser.parse_args().device)
