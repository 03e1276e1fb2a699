"""Farneback dense optical-flow alignment.

Counterpart of :mod:`tike_tpu.align.solvers.farneback`: OpenCV's
calcOpticalFlowFarneback on 8-bit rescaled images, on the host, one image
at a time. OpenCV is an optional dependency, imported when the solver runs.
"""

from __future__ import annotations

import numpy as np

from ...precision import to_numpy


def _rescale_8bit(a, b, hi=None, lo=None):
    """Map a, b onto one robust 8-bit range, estimated from b unless given:
    the 0.1% tails of b's intensities are left out."""
    if hi is None or lo is None:
        lo, hi = np.quantile(b, (0.001, 0.999))
        if hi <= lo:
            lo, hi = float(np.min(b)), float(np.max(b))
    span = hi - lo if hi > lo else 1.0
    a = np.clip(255 * (a - lo) / span, 0, 255)
    b = np.clip(255 * (b - lo) / span, 0, 255)
    return a, b


def farneback(
    op,
    original,
    unaligned,
    pyr_scale=0.5,
    levels=5,
    winsize=19,
    num_iter=16,
    poly_n=5,
    poly_sigma=1.1,
    flow=None,
    hi=None,
    lo=None,
    **kwargs,
):
    """Find the flow from unaligned to original with Farneback's algorithm.

    original, unaligned (L, M, N) float32. Returns {'flow': (L, M, N, 2)
    float32 numpy, (dy, dx) last, 'cost': -1}. Any ``device`` is ignored:
    OpenCV runs on the host.
    """
    try:
        from cv2 import calcOpticalFlowFarneback
    except ImportError as e:
        raise ImportError(
            "The farneback alignment solver requires OpenCV (cv2), which is "
            "an optional host-side dependency. Use the cross_correlation "
            "solver for rigid alignment without OpenCV."
        ) from e

    original = to_numpy(original)
    unaligned = to_numpy(unaligned)
    shape = original.shape
    if original.dtype != np.float32 or unaligned.dtype != np.float32:
        raise ValueError(
            f"original and unaligned must be float32, not {original.dtype} and "
            f"{unaligned.dtype}"
        )

    if flow is None:
        flow = np.zeros((*shape, 2), dtype="float32")
    else:
        flow = np.ascontiguousarray(to_numpy(flow)[..., ::-1])

    for i in range(len(original)):
        flow[i] = calcOpticalFlowFarneback(
            *_rescale_8bit(
                original[i],
                unaligned[i],
                hi=hi[i] if hi is not None else None,
                lo=lo[i] if lo is not None else None,
            ),
            flow=flow[i],
            pyr_scale=pyr_scale,
            levels=levels,
            winsize=winsize,
            iterations=num_iter,
            poly_n=poly_n,
            poly_sigma=poly_sigma,
            flags=4,
        )
    return {"flow": np.ascontiguousarray(flow[..., ::-1]), "cost": -1}
