"""Alignment in the port (``tike_tpu_torch.align`` and its operators)
against tike_tpu on the CPU.

The operators get the same seeded numpy inputs on both sides. Padding is
indexing, so it is compared bit for bit; the shift goes through two FFT
libraries (1e-5 of the largest value); the flow warp and the rotation
resample with the same Lanczos taps in the same order (1e-6 of the largest
value; their adjoints add the taps in another order than XLA's scatter);
the composite operator carries both (1e-5). Cross-correlation returns
multiples of 1 / upsample_factor, so both packages give the same shifts
(to 1e-6), and Farneback runs the same OpenCV call on the same bytes. The
golden alignment dataset (``tests/data/algin_setup.pickle.lzma``) is held
at the reference's own atol of 1e-6 (``tests/test_parity_golden.py``).
"""

import lzma
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tike_tpu.align as ja
from tike_tpu.ops import alignment as jalign
from tike_tpu.ops import flow as jflow
from tike_tpu.ops import pad as jpad
from tike_tpu.ops import rotate as jrotate
from tike_tpu.ops import shift as jshift

import tike_tpu_torch.align as ta
from tike_tpu_torch.ops import alignment as talign
from tike_tpu_torch.ops import flow as tflow
from tike_tpu_torch.ops import pad as tpad
from tike_tpu_torch.ops import rotate as trotate
from tike_tpu_torch.ops import shift as tshift

from . import _torch_parity as H

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "algin_setup.pickle.lzma")


def _close(got, want, tol):
    H.assert_close(got, want, rtol=tol, atol=tol, scale=True)


def _images(seed=0, n=4, size=64):
    """tests/test_align.py's images: smooth fringes and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    return (
        np.sin(9 * yy[None] * (1 + 0.1 * np.arange(n)[:, None, None])) * np.cos(7 * xx[None])
        + 0.3 * rng.random((n, size, size))
    ).astype(np.complex64)


def _flow(gen, n, h, w, amplitude=2.0):
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    phases = gen.uniform(0, 2 * np.pi, (n, 2, 1, 1))
    return np.stack(
        [amplitude * np.sin(5 * yy + phases[:, 0]), amplitude * np.cos(4 * xx + phases[:, 1])],
        -1,
    ).astype(np.float32)


@pytest.mark.parametrize("direction", ["fwd", "adj"])
def test_shift_matches_jax(direction):
    gen = H.rng(30)
    a = H.crandn(gen, 3, 20, 24)
    s = gen.uniform(-4, 4, (3, 2)).astype(np.float32)
    want = getattr(jshift, f"shift_{direction}")(jnp.asarray(a), jnp.asarray(s))
    got = getattr(tshift, f"shift_{direction}")(H.t(a), H.t(s))
    _close(got, want, 1e-5)
    assert tshift.shift_fwd(H.t(a), None) is not None


@pytest.mark.parametrize("corner", [None, "given"])
def test_pad_matches_jax(corner):
    gen = H.rng(31)
    a = H.crandn(gen, 3, 10, 12)
    c = None
    if corner:
        # the last corner runs past the frame and is clamped, as
        # lax.dynamic_update_slice clamps it
        c = np.array([[0, 0], [3, 5], [9, 12]], np.int32)
    jc = None if c is None else jnp.asarray(c)
    tc = None if c is None else H.t(c)
    want = jpad.pad_fwd(jnp.asarray(a), jc, padded_shape=(3, 16, 20), cval=0.5)
    got = tpad.pad_fwd(H.t(a), tc, padded_shape=(3, 16, 20), cval=0.5)
    np.testing.assert_array_equal(H.n(got), np.asarray(want))
    big = H.crandn(gen, 3, 16, 20)
    want = jpad.pad_adj(jnp.asarray(big), jc, unpadded_shape=(3, 10, 12))
    got = tpad.pad_adj(H.t(big), tc, unpadded_shape=(3, 10, 12))
    np.testing.assert_array_equal(H.n(got), np.asarray(want))


@pytest.mark.parametrize("filter_size", [3, 5])
def test_flow_matches_jax(filter_size):
    gen = H.rng(32)
    f = H.crandn(gen, 2, 24, 20)
    flow = _flow(gen, 2, 24, 20)
    jf, tf = jnp.asarray(flow), H.t(flow)
    for name in ("flow_fwd", "flow_inv"):
        want = getattr(jflow, name)(jnp.asarray(f), jf, filter_size, 0.2 + 0.1j)
        got = getattr(tflow, name)(H.t(f), tf, filter_size, 0.2 + 0.1j)
        _close(got, want, 1e-6)
    want = jflow.flow_adj(jnp.asarray(f), jf, filter_size)
    _close(tflow.flow_adj(H.t(f), tf, filter_size), want, 1e-6)
    # the flow is left as it was
    np.testing.assert_array_equal(H.n(tf), flow)


def test_rotate_matches_jax():
    gen = H.rng(33)
    f = H.crandn(gen, 2, 24, 24)
    for name in ("rotate_fwd", "rotate_inv"):
        want = getattr(jrotate, name)(jnp.asarray(f), 0.3, cval=0.1)
        _close(getattr(trotate, name)(H.t(f), 0.3, cval=0.1), want, 1e-6)
    _close(trotate.rotate_adj(H.t(f), 0.3), jrotate.rotate_adj(jnp.asarray(f), 0.3), 1e-6)
    assert trotate.rotate_fwd(H.t(f), None) is not None


def _operator_inputs(seed=34):
    gen = H.rng(seed)
    unpadded = H.crandn(gen, 2, 20, 20)
    shift = gen.uniform(-3, 3, (2, 2)).astype(np.float32)
    flow = _flow(gen, 2, 28, 28, amplitude=1.5)
    return unpadded, shift, flow


def test_alignment_operators_match_jax():
    unpadded, shift, flow = _operator_inputs()
    j = dict(shift=jnp.asarray(shift), flow=jnp.asarray(flow), angle=0.2)
    t = dict(shift=H.t(shift), flow=H.t(flow), angle=0.2)
    want = jalign.alignment_fwd(jnp.asarray(unpadded), padded_shape=(2, 28, 28), **j)
    got = talign.alignment_fwd(H.t(unpadded), padded_shape=(2, 28, 28), **t)
    _close(got, want, 1e-5)
    for name in ("alignment_adj", "alignment_inv"):
        want_b = getattr(jalign, name)(want, unpadded_shape=(2, 20, 20), **j)
        got_b = getattr(talign, name)(H.t(np.asarray(want)), unpadded_shape=(2, 20, 20), **t)
        _close(got_b, want_b, 1e-5)


def test_alignment_adjointness():
    """<A x, y> = <x, A* y> for the port's composite operator (cval 0)."""
    unpadded, shift, flow = _operator_inputs()
    t = dict(shift=H.t(shift), flow=H.t(flow), angle=0.2)
    y = H.t(H.crandn(H.rng(35), 2, 28, 28))
    ax = talign.alignment_fwd(H.t(unpadded), padded_shape=(2, 28, 28), **t)
    aty = talign.alignment_adj(y, unpadded_shape=(2, 20, 20), **t)
    a = complex(torch.sum(ax.to(torch.complex128) * y.conj()))
    b = complex(torch.sum(H.t(unpadded).to(torch.complex128) * aty.conj()))
    assert abs(a - b) <= 1e-5 * abs(a), (a, b)


def test_simulate_and_invert_match_jax():
    original = _images(n=3, size=48)
    gen = H.rng(36)
    kw = dict(
        shift=gen.uniform(-2, 2, (3, 2)).astype(np.float32),
        flow=_flow(gen, 3, 48, 48, amplitude=1.0),
        angle=0.1,
    )
    want = ja.simulate(original, padded_shape=None, **kw)
    got = ta.simulate(original, padded_shape=None, device="cpu", **kw)
    assert got.dtype == np.complex64 and isinstance(got, np.ndarray)
    _close(got, want, 1e-5)
    want_b = ja.invert(want, unpadded_shape=None, **kw)
    got_b = ta.invert(want, unpadded_shape=None, device="cpu", **kw)
    _close(got_b, want_b, 1e-5)


def test_simulate_matches_golden():
    with lzma.open(GOLDEN, "rb") as f:
        data, original, flow, shift = pickle.load(f)
    sim = ta.simulate(
        original=original, flow=flow, shift=shift, padded_shape=None, angle=None, device="cpu"
    )
    assert sim.dtype == np.complex64
    np.testing.assert_array_equal(sim.shape, data.shape)
    np.testing.assert_allclose(sim, data, atol=1e-6)


@pytest.mark.parametrize("space", ["real", "fourier"])
@pytest.mark.parametrize("upsample_factor", [1, 4])
def test_cross_correlation_matches_jax(space, upsample_factor):
    original = _images()
    # tests/test_align.py's shifts, less their half pixels: at
    # upsample_factor 1 a shift of k + 1/2 pixels makes two correlation
    # peaks of equal height, and the last bit of the FFT library picks one.
    true_shift = np.array([[2.25, -1.25], [-3.0, 0.75], [0.0, 4.25], [1.0, -2.0]], np.float32)
    unaligned = ja.simulate(original, shift=true_shift, flow=None, padded_shape=None, angle=None)
    if space == "fourier":
        original, unaligned = np.fft.fft2(original), np.fft.fft2(unaligned)
    kw = dict(algorithm="cross_correlation", upsample_factor=upsample_factor, space=space)
    want = ja.reconstruct(original=original, unaligned=unaligned, **kw)
    got = ta.reconstruct(original=original, unaligned=unaligned, device="cpu", **kw)
    assert got["cost"] == -1 and got["shift"].dtype == np.float32
    np.testing.assert_allclose(got["shift"], want["shift"], atol=1e-6)
    if upsample_factor == 4:
        # tests/test_align.py's own tolerance
        np.testing.assert_allclose(got["shift"], true_shift, atol=0.3)


def test_farneback_matches_jax():
    pytest.importorskip("cv2")
    gen = H.rng(37)
    original = np.abs(_images(n=2, size=48)).astype(np.float32)
    flow = _flow(gen, 2, 48, 48, amplitude=1.0)
    unaligned = np.abs(
        ja.simulate(original.astype(np.complex64), flow=flow, shift=None, padded_shape=None,
                    angle=None)
    ).astype(np.float32)
    kw = dict(algorithm="farneback", num_iter=4)
    want = ja.reconstruct(original=original, unaligned=unaligned, **kw)
    got = ta.reconstruct(original=original, unaligned=unaligned, device="cpu", **kw)
    assert got["flow"].flags.c_contiguous and got["flow"].shape == (2, 48, 48, 2)
    np.testing.assert_allclose(got["flow"], want["flow"], atol=1e-6)
    # a starting flow is taken as (dy, dx) too
    want = ja.reconstruct(original=original, unaligned=unaligned, flow=want["flow"], **kw)
    got = ta.reconstruct(original=original, unaligned=unaligned, flow=got["flow"],
                         device="cpu", **kw)
    np.testing.assert_allclose(got["flow"], want["flow"], atol=1e-6)


def test_entry_points_refuse_what_the_reference_refuses(monkeypatch):
    original = _images(n=1, size=16)
    with pytest.raises(ValueError, match="not an available"):
        ta.reconstruct(original, original, "no_such_solver", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ta.simulate(original, shift=None, flow=None, padded_shape=None, angle=None)
    with pytest.raises(RuntimeError, match="cuda"):
        ta.reconstruct(original, original, "cross_correlation")
