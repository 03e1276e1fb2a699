"""Halo exchange for row-striped object arrays.

Counterpart of :mod:`tike_tpu.parallel.halo` (the original tike's
``ThreadPool.swap_edges``): when the object is split into row stripes over
the shards of a mesh, neighbouring stripes share an overlap of rows that is
blended with a linear cross-fade, so the seam stays consistent. Where the
JAX package sends the edge rows to the neighbours with ``lax.ppermute``,
here every stripe's edge rows are gathered (across processes on a mesh
that spans several) and each stripe reads its neighbours'.
"""

from __future__ import annotations

import typing

import torch

from ._mesh import Mesh, all_gather


def _blend_ramp(overlap: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Linear cross-fade weights for the overlap region, from 0 to 1 and
    leaving out both ends."""
    return torch.linspace(0.0, 1.0, overlap + 2, dtype=dtype, device=device)[1:-1]


def swap_edges(
    psi_striped: typing.Sequence[torch.Tensor], mesh: Mesh, overlap: int
) -> typing.List[torch.Tensor]:
    """Blend the overlapping halo rows of a row-striped psi across a mesh.

    ``psi_striped`` holds the (D, H / size, W) stripe of each shard of
    ``mesh`` (of this process, on a mesh across processes, whose edge rows
    are then exchanged), in mesh order, on its device (``parallel.put`` of a (D, H, W)
    tensor with ``batch_sharding(mesh, axis=1)``, which raises where H does
    not split evenly). The ``overlap`` rows at each inner seam become a
    linear cross-fade of the two neighbours' values; the outer edges of the
    first and last stripes stay as they are. Returns the new stripes.
    Raises ``ValueError`` where the overlap is wider than a stripe.
    """
    stripes = list(psi_striped)
    size = mesh.size
    ours = mesh.local
    if len(stripes) != len(ours):
        raise ValueError(f"{len(stripes)} stripes for a mesh of {len(ours)} shards in this process")
    if size == 1 or overlap == 0:
        return stripes
    rows = stripes[0].shape[-2]
    if any(s.shape != stripes[0].shape for s in stripes):
        raise ValueError("the stripes must all have one shape")
    if overlap > rows:
        raise ValueError(f"the overlap ({overlap} rows) is wider than a stripe ({rows} rows)")
    # Every stripe's (top, bottom) edge rows, from their processes.
    edges = all_gather(
        [torch.stack([s[:, :overlap], s[:, -overlap:]])[None] for s in stripes], mesh.flat
    )[0]
    out = []
    for i, local in zip(ours, stripes):
        ramp = _blend_ramp(overlap, local.real.dtype, local.device)[None, :, None]
        top, bottom = local[:, :overlap, :], local[:, -overlap:, :]
        if i > 0:
            from_above = edges[i - 1, 1].to(local.device)
            top = (1 - ramp) * from_above + ramp * top
        if i < size - 1:
            from_below = edges[i + 1, 0].to(local.device)
            rramp = torch.flip(ramp, dims=(1,))
            bottom = (1 - rramp) * from_below + rramp * bottom
        # Both written, the bottom last, as in the JAX package: where the
        # overlap is more than half a stripe, the bottom rows win.
        new = local.clone()
        new[:, :overlap, :] = top
        new[:, -overlap:, :] = bottom
        out.append(new)
    return out


def cross_fade(
    window: torch.Tensor, seams: torch.Tensor, index: int, hs: int, halo: int
) -> torch.Tensor:
    """The seams of stripe ``index``'s psi window cross-faded with its
    neighbours', as the striped epoch of the JAX package blends them
    (``tike_tpu/ptycho/solvers/fused.py``, its stripe reconciliation).

    ``window`` (D, R, W) holds the stripe's ``hs`` interior rows between
    two halos of ``halo`` rows (R = hs + 2 halo); its top seam is rows
    ``[0, 2 halo)`` and its bottom seam rows ``[hs, hs + 2 halo)``, each
    the same global rows as a neighbour's opposite seam. ``seams`` (size,
    2, D, 2 halo, W) holds every stripe's (top, bottom) seams in mesh order
    (a ``parallel.Gather``). Each seam becomes a linear cross-fade of the
    two copies, from the upper stripe's weight to the lower's, leaving out
    both ends; the first stripe keeps its top seam and the last its bottom
    one. Unlike :func:`swap_edges`, the bottom seam is written first and
    the top seam last, so where the two overlap (``2 halo > hs``) the top
    seam's rows win, as in the JAX package. Returns the new window.
    """
    size = seams.shape[0]
    w2 = 2 * halo
    top, bottom = window[:, :w2], window[:, hs : hs + w2]
    ramp = _blend_ramp(w2, torch.float32, window.device)[None, :, None]
    out = window.clone()
    if index < size - 1:
        from_below = seams[index + 1, 0].to(window.device)
        out[:, hs : hs + w2] = (1 - ramp) * bottom + ramp * from_below
    if index > 0:
        from_above = seams[index - 1, 1].to(window.device)
        out[:, :w2] = (1 - ramp) * from_above + ramp * top
    else:
        out[:, :w2] = top
    return out
