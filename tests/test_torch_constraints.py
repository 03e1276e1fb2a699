"""The port's probe and object constraints against tike_tpu's.

Each constraint gets the same seeded complex64 input on both sides and
agrees to 1e-5 relative to the largest value of the result (float32 sums
in another order). Orthogonalized modes are compared up to one unit phase
per mode: the eigenvectors of ``eigh`` are defined only up to such a
phase, which the port fixes (first component real and non-negative) and
the JAX package leaves to LAPACK, whose sign differs.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

import tike_tpu.ptycho.object as jobj
import tike_tpu.ptycho.probe as jprobe
from tike_tpu.ops.ptycho import PtychoConfig as JConfig
from tike_tpu.ptycho.solvers import fused

import tike_tpu_torch.ptycho.object as tobj
import tike_tpu_torch.ptycho.probe as tprobe
from tike_tpu_torch.ops.ptycho import PtychoConfig as TConfig
from tike_tpu_torch.ptycho.solvers import epoch
from tike_tpu_torch.utils.ndimage import _gaussian_kernel1d

from . import _torch_parity as H

P, M = 32, 3
TOL = 1e-5


def _probe(seed=50, off=(3.0, -2.0)):
    """(1, 1, M, P, P) Hermite modes of an off-center blob with a random
    phase, so the centering and sparsity constraints have work to do."""
    gen = H.rng(seed)
    r, c = np.mgrid[:P, :P] + 0.5
    amp = np.exp(
        -((r - P / 2 - off[0]) ** 2 + (c - P / 2 - off[1]) ** 2) / (0.2 * P) ** 2
    )
    base = (amp * np.exp(1j * gen.uniform(-1, 1, (P, P))))[None, None, None]
    modes = jprobe.add_modes_cartesian_hermite(base.astype(np.complex64), M)
    return (modes + 0.01 * H.crandn(gen, *modes.shape)).astype(np.complex64)


def _close(got, want, tol=TOL):
    H.assert_close(got, want, rtol=tol, atol=tol, scale=True)


@pytest.mark.parametrize("radius, degree, p", [(0.35, 2.5, 0.5), (0.4, 5.0, 1.0)])
def test_finite_probe_support_matches_jax(radius, degree, p):
    x = _probe()
    kw = dict(radius=radius, degree=degree, p=p)
    got = tprobe.finite_probe_support(H.t(x), **kw)
    assert got.dtype == torch.float32 and got.shape == (P, P)
    _close(got, jprobe.finite_probe_support(jnp.asarray(x), **kw))
    assert tprobe.finite_probe_support(H.t(x), p=0.0) == 0.0


@pytest.mark.parametrize("off", [(3.0, -2.0), (0.0, 0.0), (-5.0, 4.5)])
def test_constrain_center_peak_matches_jax(off):
    x = _probe(off=off)
    got = tprobe.constrain_center_peak(H.t(x))
    want = jprobe.constrain_center_peak(jnp.asarray(x))
    np.testing.assert_array_equal(H.n(got), np.asarray(want))
    if off != (0.0, 0.0):  # an off-center probe moves
        assert not np.array_equal(H.n(got), x)


def test_center_peak_blur_has_257_taps_at_p128():
    """sigma = P / 6 with truncate=6 at P = 128."""
    assert len(_gaussian_kernel1d(64 / 3, 6.0)) == 257


@pytest.mark.parametrize("px", [(1.0, 1.0), (3.0, 3.0), (2.0, 4.0)])
def test_apply_median_filter_abs_probe_matches_jax(px):
    x = _probe()
    got = tprobe.apply_median_filter_abs_probe(H.t(x), med_filt_px=px)
    want = jprobe.apply_median_filter_abs_probe(jnp.asarray(x), med_filt_px=px)
    _close(got, want)


@pytest.mark.parametrize("f", [0.0, 0.1, 0.5, 0.95])
def test_constrain_probe_sparsity_matches_jax(f):
    """The threshold is the k-th smallest value counting from 0."""
    x = _probe()
    got = tprobe.constrain_probe_sparsity(H.t(x), f)
    want = jprobe.constrain_probe_sparsity(jnp.asarray(x), f)
    np.testing.assert_array_equal(H.n(got), np.asarray(want))
    zeros = np.sum(np.all(H.n(got) == 0, axis=(0, 1, 2)))
    assert zeros == int(f * P * P)


def test_orthogonalize_eig_matches_jax_up_to_phase():
    x = _probe()
    got, got_pwr = tprobe._orthogonalize_eig_body(H.t(x))
    want, want_pwr = jprobe._orthogonalize_eig_body(jnp.asarray(x))
    _close(got_pwr, want_pwr)
    _close(H.phase_aligned(got, want), want)
    # Up to a sign per mode, which is all that LAPACK leaves open.
    sign = np.sum(np.conj(H.n(got)) * np.asarray(want), axis=(-2, -1))
    assert np.all(np.abs(sign.imag) <= 1e-4 * np.abs(sign)), sign
    # The modes are orthogonal and sorted by power, descending.
    flat = H.n(got).reshape(M, -1)
    gram = np.conj(flat) @ flat.T
    np.testing.assert_allclose(gram - np.diag(np.diag(gram)), 0, atol=1e-3)
    assert np.all(np.diff(H.n(got_pwr)) <= 0)
    t_modes, t_pwr = tprobe.orthogonalize_eig(H.t(x))
    assert isinstance(t_pwr, np.ndarray)
    np.testing.assert_array_equal(H.n(t_modes), H.n(got))


def _golden(name):
    return scipy.io.loadmat(os.path.join(os.path.dirname(__file__), "data", name))


def test_orthogonalize_eig_matches_golden_data():
    """The reference's MATLAB data, up to one phase per mode."""
    modes = np.rollaxis(_golden("ortho-in.mat")["modes"], -1, 0).astype(np.complex64)
    want = np.rollaxis(_golden("ortho-out.mat")["pr"], -1, 0).astype(np.complex64)
    got, _ = tprobe._orthogonalize_eig_body(H.t(modes))
    _close(H.phase_aligned(got, want), want, tol=1e-4)


def test_power_matches_jax():
    x = _probe()
    _close(tprobe.power(H.t(x)), jprobe.power(jnp.asarray(x)))


@pytest.mark.parametrize("fraction", [None, [0.7, 0.2, 0.1]])
def test_rescale_probe_using_fixed_intensity_photons_matches_jax(fraction):
    x = _probe()
    tf = None if fraction is None else torch.tensor(fraction)
    jf = None if fraction is None else jnp.asarray(fraction)
    got = tprobe.rescale_probe_using_fixed_intensity_photons(H.t(x), 1234.5, tf)
    want = jprobe.rescale_probe_using_fixed_intensity_photons(
        jnp.asarray(x), 1234.5, jf
    )
    _close(got, want)
    np.testing.assert_allclose(np.sum(np.abs(H.n(got)) ** 2), 1234.5, rtol=1e-5)


def _plans(**kw):
    """The same constraint settings as a tike_tpu and a tike_tpu_torch
    EpochPlan (the other fields do not reach the constraints)."""
    jcfg = JConfig(probe_shape=P, detector_shape=P, nz=64, n=64)
    tcfg = TConfig(probe_shape=P, detector_shape=P, nz=64, n=64)
    common = dict(
        noise_model="gaussian",
        steplength_usemodes="all_modes",
        recover_psi=True,
        recover_probe=True,
        update_start=0,
        update_period=1,
        rescale_mean_abs=True,
        rescale_period=10,
        probe_support=0.0,
        probe_support_radius=0.35,
        probe_support_degree=2.5,
        additional_probe_penalty=0.0,
        median_filter=False,
        median_filter_px=(1.0, 1.0),
        force_center=False,
        force_sparsity=0.0,
        force_orthogonality=False,
    )
    common.update(kw)
    jplan = fused.EpochPlan(
        cfg=jcfg, solver="rpie", n_epochs=1, compact=False, has_eigen=False,
        positivity=0.0, smoothness=0.0, clip_magnitude=False, alpha=0.05,
        **common,
    )
    return jplan, epoch.EpochPlan(cfg=tcfg, solver="rpie", **common)


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(probe_support=0.2),
        dict(additional_probe_penalty=0.3),
        dict(median_filter=True, median_filter_px=(3.0, 3.0)),
        dict(force_center=True),
        dict(force_sparsity=0.3),
        dict(force_orthogonality=True),
        dict(
            probe_support=0.2,
            additional_probe_penalty=0.1,
            median_filter=True,
            median_filter_px=(2.0, 2.0),
            force_center=True,
            force_sparsity=0.2,
            force_orthogonality=True,
        ),
    ],
    ids=["none", "support", "penalty", "median", "center", "sparsity", "ortho", "all"],
)
def test_probe_constraints_math_matches_jax(kw):
    x = _probe()
    jplan, tplan = _plans(**kw)
    got, got_pwr = epoch._probe_constraints_math(tplan, H.t(x))
    want, want_pwr = fused._probe_constraints_math(jplan, jnp.asarray(x))
    _close(got_pwr, want_pwr)
    if kw.get("force_orthogonality"):
        got = H.phase_aligned(got, want)
    _close(got, want)


def _object(seed=51):
    gen = H.rng(seed)
    return (0.8 * H.crandn(gen, 1, 20, 23)).astype(np.complex64)


@pytest.mark.parametrize("r", [0.0, 0.3, 1.0])
def test_positivity_constraint_matches_jax(r):
    x = _object()
    got = tobj.positivity_constraint(H.t(x), r)
    _close(got, jobj.positivity_constraint(jnp.asarray(x), r))


@pytest.mark.parametrize("a", [0.0, 0.05, 0.12])
def test_smoothness_constraint_matches_jax(a):
    x = _object()
    got = tobj.smoothness_constraint(H.t(x), a)
    _close(got, jobj.smoothness_constraint(jnp.asarray(x), a))


@pytest.mark.parametrize("a_max", [1.0, 0.5])
def test_clip_magnitude_matches_jax(a_max):
    x = _object()
    got = tobj.clip_magnitude(H.t(x), a_max)
    _close(got, jobj.clip_magnitude(jnp.asarray(x), a_max))
    assert np.abs(H.n(got)).max() <= a_max * (1 + 1e-6)


@pytest.mark.parametrize(
    "fn, bad, match",
    [
        (tobj.positivity_constraint, 1.5, r"range \[0, 1\]"),
        (tobj.smoothness_constraint, 0.125, r"range \[0, 1/8\)"),
        (tobj.smoothness_constraint, -0.01, r"range \[0, 1/8\)"),
    ],
)
def test_object_constraint_ranges_raise(fn, bad, match):
    with pytest.raises(ValueError, match=match):
        fn(H.t(_object()), bad)
    # The JAX package raises the same.
    jfn = getattr(jobj, fn.__name__)
    with pytest.raises(ValueError, match=match):
        jfn(jnp.asarray(_object()), bad)


def test_epoch_plan_fields_cover_the_jax_constraints():
    """Every constraint and moment field of fused.EpochPlan exists in the
    port's plan."""
    ours = {f.name for f in dataclasses.fields(epoch.EpochPlan)}
    theirs = {f.name for f in dataclasses.fields(fused.EpochPlan)}
    assert theirs - ours == {"n_epochs"}


@pytest.mark.parametrize("power", [None, (1.0, 0.3, 0.05)], ids=["default", "given"])
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_adjust_probe_power_matches_jax(kind, power):
    """numpy in gives numpy out (on the device asked for), a tensor stays a
    tensor, as tike_tpu's host wrapper does."""
    probe = H.crandn(H.rng(40), 1, 1, 3, 16, 16)
    want = jprobe.adjust_probe_power(probe, power)
    if kind == "tensor":
        got = tprobe.adjust_probe_power(H.t(probe), power)
        assert isinstance(got, torch.Tensor)
    else:
        got = tprobe.adjust_probe_power(probe, power, device="cpu")
        assert isinstance(got, np.ndarray) and got.dtype == np.complex64
    _close(got, want)
    norms = np.linalg.norm(H.n(got)[0, 0].reshape(3, -1), axis=-1)
    expected = 1.0 / np.arange(1, 4) if power is None else np.asarray(power)
    np.testing.assert_allclose(norms / norms[0], expected, rtol=1e-5)


def test_simulate_varying_weights_matches_jax_bitwise():
    scan = H.rng(41).uniform(0, 50, (1, 30, 2)).astype(np.float32)
    eigen_probe = np.zeros((1, 2, 3, 8, 8), np.complex64)
    got = tprobe.simulate_varying_weights(scan, eigen_probe, rng=H.rng(42))
    assert got.shape == (30, 2, 3)
    np.testing.assert_array_equal(
        got, jprobe.simulate_varying_weights(scan, eigen_probe, rng=H.rng(42))
    )


@pytest.mark.parametrize("precond", ["float32", "complex64"])
def test_remove_object_ambiguity_matches_jax(precond):
    """The rescale the epochs apply every ``rescale_period`` epochs, from
    either preconditioner dtype."""
    gen = H.rng(43)
    psi = H.crandn(gen, 2, 20, 24)
    probe = H.crandn(gen, 1, 1, 2, 8, 8)
    pre = gen.uniform(0, 3, (2, 20, 24)).astype(np.float32).astype(precond)
    want = jobj.remove_object_ambiguity(jnp.asarray(psi), jnp.asarray(probe), jnp.asarray(pre))
    got = tobj.remove_object_ambiguity(H.t(psi), H.t(probe), H.t(pre))
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("method", ["cubic", "linear", "nearest"])
def test_get_absorbtion_image_matches_jax_bitwise(method):
    gen = H.rng(44)
    data = gen.random((60, 8, 8)).astype(np.float32)
    scan = gen.uniform(0, 20, (60, 2)).astype(np.float32)
    want = jobj.get_absorbtion_image(data, scan, rescale=0.5, method=method)
    got = tobj.get_absorbtion_image(H.t(data), H.t(scan), rescale=0.5, method=method)
    np.testing.assert_array_equal(got, want)
