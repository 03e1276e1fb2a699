"""The yardstick's table of peaks and the operation and byte counts of the
kernels it holds to a roofline. Frozen copies: they change only with the
benchmark, never with the program.

Peaks: NVIDIA's data sheet for the H100 SXM (80 GB HBM3) at its 700 W
limit, dense rates. A card set below 700 W reads lower shares; each result
line carries the card's name and power limit.
"""

from __future__ import annotations

import typing

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def patch_needed(positions: torch.Tensor, p: int, h: int, w: int) -> typing.Tuple[int, int]:
    """What (P, P) bilinear windows at ``positions`` (N, 2) need of an (H, W)
    image: the image pixels some (P + 1)^2 window touches (all a patch
    gather must read), and the patch values with a tap inside the image
    (all a patch accumulation must read)."""
    corner = torch.floor(positions).to(torch.int64)
    cy, cx = corner[:, 0], corner[:, 1]
    r0, r1 = cy.clamp(0, h), (cy + p + 1).clamp(0, h)
    c0, c1 = cx.clamp(0, w), (cx + p + 1).clamp(0, w)
    edges = torch.zeros((h + 1, w + 1), dtype=torch.int64, device=positions.device)
    for rows, cols, sign in ((r0, c0, 1), (r0, c1, -1), (r1, c0, -1), (r1, c1, 1)):
        edges.index_put_((rows, cols), torch.full_like(rows, sign), accumulate=True)
    pixels = int((edges.cumsum(0).cumsum(1)[:h, :w] > 0).sum())
    rows = ((h - 1 - cy).clamp(max=p - 1) - (-1 - cy).clamp(min=0) + 1).clamp(min=0)
    cols = ((w - 1 - cx).clamp(max=p - 1) - (-1 - cx).clamp(min=0) + 1).clamp(min=0)
    return pixels, int((rows * cols).sum())


def patch_bound_s(name: str, positions: torch.Tensor, p: int, shape) -> float:
    """The least seconds one complex64 patch gather (``patch_fwd``) or
    accumulation (``patch_adj``) at ``positions`` needs: the larger of its
    bytes over the HBM rate and its float32 operations over the float32
    rate. Bytes: the patch values (written by the gather, read by the
    accumulation), the image pixels the windows touch (read by the gather)
    or the whole image (written by the accumulation), and the positions.
    Operations: four multiply-adds (8 flops) a real component of each patch
    value made or spread."""
    h, w = shape
    n = positions.shape[0]
    itemsize = 8  # complex64
    pixels, values = patch_needed(positions, p, h, w)
    if name == "patch_fwd":
        values = n * p * p
        nbytes = values * itemsize + pixels * itemsize + n * 2 * 4
    elif name == "patch_adj":
        nbytes = values * itemsize + h * w * itemsize + n * 2 * 4
    else:
        raise KeyError(name)
    flops = 4 * 2 * 2 * values
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
