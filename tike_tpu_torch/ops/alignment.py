"""The composite alignment operator: pad, then shift, flow and rotate.

Counterpart of :mod:`tike_tpu.ops.alignment` (its ``alignment_fwd``,
``alignment_adj`` and ``alignment_inv``). The flow warp and the rotation
run ``csrc/interp.cu``'s Lanczos kernels on CUDA tensors; the shift runs on
cuFFT.
"""

from __future__ import annotations

from .flow import flow_adj, flow_fwd
from .pad import pad_adj, pad_fwd
from .rotate import rotate_adj, rotate_fwd
from .shift import shift_adj, shift_fwd


def alignment_fwd(unpadded, shift, flow, padded_shape, angle, unpadded_shape=None, cval=0.0):
    """rotate(flow(shift(pad(unpadded))))."""
    return rotate_fwd(
        flow_fwd(
            shift_fwd(pad_fwd(unpadded, padded_shape=padded_shape, cval=cval), shift),
            flow,
            cval=cval,
        ),
        angle,
        cval=cval,
    )


def alignment_adj(rotated, flow, shift, unpadded_shape, angle, padded_shape=None, cval=0.0):
    """The adjoint of :func:`alignment_fwd` (with cval 0)."""
    return pad_adj(
        shift_adj(flow_adj(rotate_adj(rotated, angle, cval=cval), flow, cval=cval), shift),
        unpadded_shape=unpadded_shape,
    )


def alignment_inv(rotated, flow, shift, unpadded_shape, angle, padded_shape=None, cval=0.0):
    """Approximate inverse: rotate and warp by the negated angle and flow,
    then undo the shift and crop."""
    return pad_adj(
        shift_adj(
            flow_fwd(
                rotate_fwd(rotated, None if angle is None else -angle, cval=cval),
                None if flow is None else -flow,
                cval=cval,
            ),
            shift,
        ),
        unpadded_shape=unpadded_shape,
    )
