"""Halo exchange for row-striped object arrays.

Counterpart of :mod:`tike_tpu.parallel.halo` (the original tike's
``ThreadPool.swap_edges``): when the object is split into row stripes over
the shards of a mesh, neighbouring stripes share an overlap of rows that is
blended with a linear cross-fade, so the seam stays consistent. Where the
JAX package sends the edge rows to the neighbours with ``lax.ppermute``,
here each stripe reads its neighbours' edge rows from their devices.
"""

from __future__ import annotations

import typing

import torch

from ._mesh import Mesh


def _blend_ramp(overlap: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Linear cross-fade weights for the overlap region, from 0 to 1 and
    leaving out both ends."""
    return torch.linspace(0.0, 1.0, overlap + 2, dtype=dtype, device=device)[1:-1]


def swap_edges(
    psi_striped: typing.Sequence[torch.Tensor], mesh: Mesh, overlap: int
) -> typing.List[torch.Tensor]:
    """Blend the overlapping halo rows of a row-striped psi across a mesh.

    ``psi_striped`` holds the (D, H / size, W) stripe of each shard of
    ``mesh``, in mesh order, on its device (``parallel.put`` of a (D, H, W)
    tensor with ``batch_sharding(mesh, axis=1)``, which raises where H does
    not split evenly). The ``overlap`` rows at each inner seam become a
    linear cross-fade of the two neighbours' values; the outer edges of the
    first and last stripes stay as they are. Returns the new stripes.
    Raises ``ValueError`` where the overlap is wider than a stripe.
    """
    stripes = list(psi_striped)
    size = mesh.size
    if len(stripes) != size:
        raise ValueError(f"{len(stripes)} stripes for a mesh of {size} shards")
    if size == 1 or overlap == 0:
        return stripes
    rows = stripes[0].shape[-2]
    if any(s.shape != stripes[0].shape for s in stripes):
        raise ValueError("the stripes must all have one shape")
    if overlap > rows:
        raise ValueError(f"the overlap ({overlap} rows) is wider than a stripe ({rows} rows)")
    out = []
    for i, local in enumerate(stripes):
        ramp = _blend_ramp(overlap, local.real.dtype, local.device)[None, :, None]
        top, bottom = local[:, :overlap, :], local[:, -overlap:, :]
        if i > 0:
            from_above = stripes[i - 1][:, -overlap:, :].to(local.device)
            top = (1 - ramp) * from_above + ramp * top
        if i < size - 1:
            from_below = stripes[i + 1][:, :overlap, :].to(local.device)
            rramp = torch.flip(ramp, dims=(1,))
            bottom = (1 - rramp) * from_below + rramp * bottom
        # Both written, the bottom last, as in the JAX package: where the
        # overlap is more than half a stripe, the bottom rows win.
        new = local.clone()
        new[:, :overlap, :] = top
        new[:, -overlap:, :] = bottom
        out.append(new)
    return out
