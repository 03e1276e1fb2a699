"""The port's Lanczos remap (``ops/interp.py``) against tike_tpu's on the CPU.

The same seeded points and values go to ``tike_tpu.ops.interp`` and to the
port's plain versions, which walk the taps in the JAX package's order with
its guards: 1e-6 relative plus 1e-6 of the largest value (the adjoint's
scatter-adds sum each grid value's taps in another order than XLA's). The
batched forms (a stack of images, per-image or shared points) are the
single-image forms image by image, bit for bit; the kernels' own checks
are in ``test_torch_interp_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tike_tpu.ops import interp as jinterp

from tike_tpu_torch.ops import interp as tinterp

from . import _torch_interp_cases as cases
from . import _torch_parity as H

CASE_NAMES = [
    "m1 complex", "m2 complex, cval", "m1 real, cval", "m2 real",
    "m0 complex", "m5 complex, cval (run-time m)", "m11 real, cval (run-time m)",
]


def _close(got, want):
    H.assert_close(got, want, rtol=1e-6, atol=1e-6, scale=True)


def test_lanczos_weight_matches_jax():
    d = np.concatenate(
        [np.linspace(-3, 3, 601), [0.0, 1e-13, -1e-13, 2.0, -2.0, 2.0000002, 1.0, 0.5]]
    ).astype(np.float32)
    got = tinterp._lanczos_weight(torch.tensor(d))
    want = jinterp._lanczos_weight(jnp.asarray(d))
    H.assert_close(got, want, rtol=1e-6, atol=1e-7)
    assert float(got[601]) == float(got[602]) == 1.0  # d = 0 and below the guard
    assert float(got[-3]) == 0.0  # beyond the two lobes


@pytest.mark.parametrize("name", CASE_NAMES)
def test_remap_matches_jax(name):
    images, points, values, m, cval = cases.case_inputs(name, "cpu")
    h, w = images.shape[-2:]
    for k in range(images.shape[0]):
        want = jinterp.remap_lanczos_fwd(jnp.asarray(images[k].numpy()),
                                         jnp.asarray(points[k].numpy()), m, cval)
        _close(tinterp.remap_lanczos_fwd(images[k], points[k], m, cval), want)
        want = jinterp.remap_lanczos_adj(jnp.asarray(values[k].numpy()),
                                         jnp.asarray(points[k].numpy()), m, (h, w))
        _close(tinterp.remap_lanczos_adj(values[k], points[k], m, (h, w)), want)


@pytest.mark.parametrize("name", ["m2 complex, cval", "m2 complex, shared points (rotate)"])
def test_batched_forms_are_the_single_image_forms(name):
    images, points, values, m, cval = cases.case_inputs(name, "cpu")
    h, w = images.shape[-2:]
    fwd = tinterp.remap_lanczos_fwd(images, points, m, cval)
    adj = tinterp.remap_lanczos_adj(values, points, m, (h, w))
    assert fwd.shape == values.shape and adj.shape == images.shape
    for k in range(images.shape[0]):
        pk = points if points.dim() == 2 else points[k]
        np.testing.assert_array_equal(
            fwd[k].numpy(), tinterp.remap_lanczos_fwd(images[k], pk, m, cval).numpy()
        )
        np.testing.assert_array_equal(
            adj[k].numpy(), tinterp.remap_lanczos_adj(values[k], pk, m, (h, w)).numpy()
        )


@pytest.mark.parametrize("name", ["m1 complex", "m2 real", "m2 complex, shared points (rotate)"])
def test_adjointness(name):
    images, points, values, m, _ = cases.case_inputs(name, "cpu")
    lin = tinterp.remap_lanczos_fwd(images, points, m)
    adj = tinterp.remap_lanczos_adj(values, points, m, images.shape[-2:])
    a, b = cases.inner(lin, values), cases.inner(images, adj)
    assert abs(a - b) <= cases.ADJOINT_TOL * abs(a), (a, b)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches only on the card; the dispatcher takes the plain
    version only for CPU tensors."""
    images, points, values, m, cval = cases.case_inputs("m1 complex", "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tinterp.remap_lanczos_fwd_cuda(images, points, m, cval)
    with pytest.raises(ValueError, match="CUDA"):
        tinterp.remap_lanczos_adj_cuda(values, points, m, images.shape[-2:])
    before = dict(tinterp.LAUNCHES)
    tinterp.remap_lanczos_fwd(images, points, m, cval)
    assert tinterp.LAUNCHES == before


def test_roofline_counts():
    """Bytes: images, values and points once; FP32: 2(2m+1) weights of 9
    and, summed row by row, (2m+1)^2 + (2m+1) multiply-adds a channel a
    point."""
    b = tinterp.roofline("lanczos_fwd", 128, 1024 * 1024, 1024, 1024, 2)
    assert b["bound_bytes"] == 8 * 128 * 2**20 * 2 + 8 * 128 * 2**20
    assert b["bound_fp32"] == 128 * 2**20 * (9 * 10 + (25 + 5) * 2)
    shared = tinterp.roofline("lanczos_adj", 128, 2**20, 1024, 1024, 2, shared_points=True)
    assert shared["bound_bytes"] == 8 * 128 * 2**20 * 2 + 8 * 2**20
    real = tinterp.roofline("lanczos_fwd", 1, 10, 4, 4, 1, complex_values=False)
    assert real["bound_fp32"] == 10 * (9 * 6 + 9 + 3)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == b["bound_bytes_ms"]
    # The rotation's shared points move fewer bytes, and are bound by them
    # too: 2,155,872,256 B at 3.35 TB/s against 150 FP32 a point.
    assert shared["bound_by"] == "bytes"
    assert shared["bound_ms"] == pytest.approx(2155872256 / 3.35e9)
