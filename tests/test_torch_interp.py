"""The port's Lanczos remap (``ops/interp.py``) against tike_tpu's on the CPU.

The same seeded points and values go to ``tike_tpu.ops.interp`` and to the
port's plain versions, which walk the taps in the JAX package's order with
its guards: 1e-6 relative plus 1e-6 of the largest value (the adjoint's
scatter-adds sum each grid value's taps in another order than XLA's). The
batched forms (a stack of images, per-image or shared points) are the
single-image forms image by image, bit for bit. What the kernels compute
differently is held here too: every m >= 2 gives m = 2's result in both
packages, bit for bit, and the kernels' sine-pair weights and 4 x 4 window
(``_torch_interp_cases.sine_pair_weights``, ``window_fwd``, ``window_adj``)
lie close to tike_tpu's; the kernels' own checks are in
``test_torch_interp_cuda.py``.
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
    """Bytes: images, values and points once; FP32: the window m reduces
    to (K = 4 taps a side for m >= 2, 3 at m = 1), one sine pair an axis
    (8) and K weights from it (3 each), and, summed row by row, K^2 + K
    multiply-adds a channel a point."""
    b = tinterp.roofline("lanczos_fwd", 128, 1024 * 1024, 1024, 1024, 2)
    assert b["bound_bytes"] == 8 * 128 * 2**20 * 2 + 8 * 128 * 2**20
    assert b["bound_fp32"] == 128 * 2**20 * (2 * (8 + 3 * 4) + (16 + 4) * 2)
    assert tinterp.roofline("lanczos_fwd", 128, 2**20, 1024, 1024, 11) == b
    shared = tinterp.roofline("lanczos_adj", 128, 2**20, 1024, 1024, 2, shared_points=True)
    assert shared["bound_bytes"] == 8 * 128 * 2**20 * 2 + 8 * 2**20
    real = tinterp.roofline("lanczos_fwd", 1, 10, 4, 4, 1, complex_values=False)
    assert real["bound_fp32"] == 10 * (2 * (8 + 3 * 3) + 9 + 3)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == b["bound_bytes_ms"]
    # The rotation's shared points move fewer bytes, and are bound by them
    # too: 2,155,872,256 B at 3.35 TB/s against 80 FP32 a point.
    assert shared["bound_by"] == "bytes"
    assert shared["bound_ms"] == pytest.approx(2155872256 / 3.35e9)


@pytest.mark.parametrize("m", [3, 5, 11])
@pytest.mark.parametrize("name", ["m2 complex, cval", "m2 real"])
def test_every_m_above_2_is_m2(name, m):
    """The window is 0 beyond |d| > 2, so tike_tpu's remap at m > 2 is its
    m = 2 remap bit for bit, and so is the port's plain version."""
    images, points, values, _, cval = cases.case_inputs(name, "cpu")
    h, w = images.shape[-2:]
    f, x, v = (jnp.asarray(t[0].numpy()) for t in (images, points, values))
    np.testing.assert_array_equal(
        np.asarray(jinterp.remap_lanczos_fwd(f, x, m, cval)),
        np.asarray(jinterp.remap_lanczos_fwd(f, x, 2, cval)),
    )
    np.testing.assert_array_equal(
        np.asarray(jinterp.remap_lanczos_adj(v, x, m, (h, w))),
        np.asarray(jinterp.remap_lanczos_adj(v, x, 2, (h, w))),
    )
    np.testing.assert_array_equal(
        tinterp.remap_lanczos_fwd(images, points, m, cval).numpy(),
        tinterp.remap_lanczos_fwd(images, points, 2, cval).numpy(),
    )
    np.testing.assert_array_equal(
        tinterp.remap_lanczos_adj(values, points, m, (h, w)).numpy(),
        tinterp.remap_lanczos_adj(values, points, 2, (h, w)).numpy(),
    )


def test_sine_pair_weights_match_jax():
    """The kernels' weights, from one sine pair an axis, within 5e-7 of
    tike_tpu's float32 window (largest weight 1) over f in [0, 1), f = 0
    and the fractions next to it included."""
    f = np.concatenate([
        np.random.default_rng(5).uniform(0, 1, 100_000),
        [0.0, 1e-13, 1e-12, 1e-7, 0.25, 0.5, 0.75, 1 - 2**-24],
    ]).astype(np.float32)
    got = cases.sine_pair_weights(torch.tensor(f), range(-1, 3)).numpy()
    want = np.stack(
        [np.asarray(jinterp._lanczos_weight(jnp.asarray(f - np.float32(o)))) for o in range(-1, 3)],
        -1,
    )
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)
    assert got[100_000, 1] == 1.0 and got[100_001, 1] == 1.0  # d = 0 and below the guard


@pytest.mark.parametrize("name", CASE_NAMES)
def test_window_mirror_matches_jax(name):
    """The kernels' window (4 x 4 for every m >= 2) with their weights
    against tike_tpu's remap at the case's m, within 1e-6 of the largest
    value."""
    images, points, values, m, cval = cases.case_inputs(name, "cpu")
    h, w = images.shape[-2:]
    fwd = cases.window_fwd(images, points, m, cval)
    adj = cases.window_adj(values, points, m, (h, w))
    for k in range(images.shape[0]):
        x = jnp.asarray(points[k].numpy())
        want = jinterp.remap_lanczos_fwd(jnp.asarray(images[k].numpy()), x, m, cval)
        H.assert_close(fwd[k], want, rtol=0, atol=1e-6, scale=True)
        want = jinterp.remap_lanczos_adj(jnp.asarray(values[k].numpy()), x, m, (h, w))
        H.assert_close(adj[k], want, rtol=0, atol=1e-6, scale=True)


def test_kernel_source_matches_the_wrappers_constants():
    """The adjoint's count of fallback warps has as many slots in the
    kernel as the wrapper allocates and sums."""
    import re

    from tike_tpu_torch import kernels

    source = (kernels.CSRC / "interp.cu").read_text()
    slots = re.search(r"constexpr int kFallbackSlots = (\d+);", source)
    assert slots and int(slots.group(1)) == tinterp.FALLBACK_SLOTS


def test_window_of_each_m():
    assert [tinterp.window(m) for m in (0, 1, 2, 3, 11)] == [
        (1, 0), (3, -1), (4, -1), (4, -1), (4, -1)
    ]


@pytest.mark.parametrize("spelling", ["cuda", "cuda:0", torch.device("cuda")])
def test_fallback_count_reads_cuda_as_the_current_card(monkeypatch, spelling):
    """The count is filed under the card with its index, so ``cuda`` reads
    (and resets) the current card's count and not an empty entry. A CPU
    tensor stands in for the card's slots."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    slots = torch.zeros(tinterp.FALLBACK_SLOTS, dtype=torch.int64)
    slots[[0, 5, 255]] = torch.tensor([4, 2, 1])
    monkeypatch.setitem(tinterp.FALLBACK._tensors, torch.device("cuda", 0), slots)
    assert tinterp.FALLBACK.tensor(spelling) is slots
    assert tinterp.fallback_warps(spelling) == tinterp.fallback_warps("cuda:0") == 7
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert tinterp.fallback_warps("cuda") == 0
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    tinterp.reset_fallback_warps(spelling)
    assert tinterp.fallback_warps("cuda:0") == 0 and not slots.any()


def test_card_counter_sums_its_slots():
    """``kernels.CardCounter``: slots made at first use, read as their sum,
    reset to 0; a device no kernel has counted on reads 0."""
    from tike_tpu_torch import kernels

    counter = kernels.CardCounter(4)
    assert counter.read("cpu") == 0
    slots = counter.tensor("cpu")
    assert slots.dtype == torch.int64 and slots.shape == (4,)
    assert counter.tensor(torch.device("cpu")) is slots
    slots += torch.tensor([1, 0, 3, 5])
    assert counter.read("cpu") == 9 and counter.read("cuda:3") == 0
    counter.reset("cpu")
    assert counter.read("cpu") == 0


def test_interp_sweep_variants_apply_to_the_source():
    """Every default variant of ``kernel_sweep --source interp`` finds its
    text in ``csrc/interp.cu`` and changes the source, and the first form,
    which chip_smoke.py times beside the kernels, keeps its own entry
    points."""
    from tike_tpu_torch import kernel_sweep, kernels

    with open(kernel_sweep.INTERP_SOURCE) as f:
        source = f.read()
    variants = kernel_sweep.interp_variants(source)
    sources = [kernel_sweep.variant_source(source, subs) for subs in variants.values()]
    assert sources[0] == source and len(set(sources)) == len(variants) == 8
    first = (kernels.CSRC / "interp_first_form.cu").read_text()
    for name in kernels.SIGNATURES["interp_first_form"]:
        assert f'extern "C" int {name}(' in first
    for name in kernels.SIGNATURES["interp"]:
        assert f'extern "C" int {name}(' in source
