"""Shared helpers for the tike_tpu_torch parity tests.

Every parity test makes its inputs once with numpy from a fixed seed and
hands the same arrays to the JAX function (on the CPU, as
``tests/conftest.py`` forces) and to its counterpart in the port (on CPU
tensors, so the port runs its plain PyTorch versions).

Importing this module caps PyTorch at one intra-op thread: the suite runs
under several xdist workers, and each would otherwise start a thread per
core.
"""

from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(1)


def rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def crandn(gen: np.random.Generator, *shape) -> np.ndarray:
    """Complex64 standard-normal array."""
    return (gen.standard_normal(shape) + 1j * gen.standard_normal(shape)).astype(
        np.complex64
    )


def positions(gen: np.random.Generator, n: int, h: int, w: int, p: int):
    """(n, 2) float32 fractional min-corners inside [1, dim - p - 2]."""
    return np.stack(
        [gen.uniform(1, h - p - 2, n), gen.uniform(1, w - p - 2, n)], -1
    ).astype(np.float32)


def t(x) -> torch.Tensor:
    """numpy -> CPU tensor (a copy), keeping the dtype (inputs are 32-bit)."""
    return torch.tensor(np.asarray(x))


def n(x) -> np.ndarray:
    """JAX array or tensor -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(got, want, rtol: float, atol: float = 0.0, *, scale=False):
    """``assert_allclose`` on numpy views; with ``scale`` the atol is
    relative to the largest magnitude of ``want``."""
    got, want = n(got), n(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if scale:
        atol = atol * float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def slice_inputs(
    seed: int = 0, h: int = 160, p: int = 16, det: int = 24, npos: int = 120
):
    """Seeded inputs of the small LSQML slice: scan, true psi, probe, and
    a perturbed starting psi.

    The probe has a random phase and the starting object a random
    perturbation, so the modeled far field has no near-zero pixels. Where
    the modeled intensity is close to 0 the Gaussian gradient's
    ``farplane / sqrt(intensity)`` is the phase of FFT rounding noise, which
    differs between any two FFT libraries; a constant start with a smooth
    probe puts many pixels there and amplifies rounding to ~1e-3.
    """
    gen = rng(seed)
    scan = np.stack(
        [gen.uniform(2, h - p - 3, npos), gen.uniform(2, h - p - 3, npos)], -1
    ).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:h] / h
    psi = (
        np.exp(1j * 0.5 * np.sin(17 * yy) * np.cos(13 * xx))
        * (0.9 + 0.1 * np.cos(23 * xx * yy))
    ).astype(np.complex64)[None]
    r, c = np.mgrid[:p, :p] + 0.5
    amp = np.exp(-((r - p / 2) ** 2 + (c - p / 2) ** 2) / (0.3 * p) ** 2)
    probe = (amp * np.exp(1j * gen.uniform(-np.pi, np.pi, (p, p))))[
        None, None, None
    ].astype(np.complex64)
    psi0 = (0.5 + 0.05 * crandn(gen, *psi.shape)).astype(np.complex64)
    return scan, psi, probe, psi0


def bench_start_inputs(
    seed: int = 0, h: int = 160, p: int = 16, det: int = 24, npos: int = 120
):
    """Like :func:`slice_inputs`, but starting where ``bench.py`` and
    ``chip_smoke.py`` start: the soft-edged real aperture with a 0.2 rad
    phase ramp as the probe, and a constant 0.5 object."""
    scan, psi, _, _ = slice_inputs(seed, h, p, det, npos)
    r, c = np.mgrid[:p, :p] + 0.5
    rs = np.sqrt((r - p / 2) ** 2 + (c - p / 2) ** 2)
    rmax = np.sqrt(2) * 0.5 * rs.max() + 1.0
    rmin = np.sqrt(2) * 0.5 * 0.8 * rs.max()
    win = np.clip((rmax - rs) / (rmax - rmin), 0.0, 1.0)
    probe = (win * np.exp(1j * 0.2 * win))[None, None, None].astype(np.complex64)
    return scan, psi, probe, np.full_like(psi, 0.5)


def one_ulp(gen: np.random.Generator, x: np.ndarray) -> np.ndarray:
    """``x`` (complex64) with its real or imaginary part, picked at random
    per element, moved up by one float32 ulp."""
    up = lambda a: np.nextafter(a, np.float32(np.inf), dtype=np.float32)
    real = gen.uniform(size=x.shape) < 0.5
    return (
        np.where(real, up(x.real), x.real) + 1j * np.where(real, x.imag, up(x.imag))
    ).astype(np.complex64)


def opr_inputs(seed: int = 0, h: int = 160, p: int = 16, det: int = 24, npos: int = 120):
    """Seeded inputs of the small config-2 slice: :func:`slice_inputs` with
    the probe split into 3 incoherent modes by ``add_modes_cartesian_hermite``
    (the JAX package's numpy helper, as ``bench_all.py`` builds config 2).

    Returns scan, true psi, the (1, 1, 3, P, P) probe and the perturbed
    starting psi.
    """
    from tike_tpu.ptycho.probe import add_modes_cartesian_hermite

    scan, psi, probe, psi0 = slice_inputs(seed, h, p, det, npos)
    return scan, psi, add_modes_cartesian_hermite(probe, 3), psi0


def bench_eigen(probe: np.ndarray, npos: int):
    """``bench_all.py``'s config-2 eigen state: one eigen probe, 0.01 of the
    shared modes, and weights of 1 on the shared component and 0 on the
    eigen probe."""
    eigen_probe = (0.01 * probe[:, :1]).astype(np.complex64)
    weights = np.zeros((npos, 2, probe.shape[-3]), np.float32)
    weights[:, 0, :] = 1.0
    return eigen_probe, weights


def phase_aligned(got, want):
    """``got`` with each mode (axis -3) turned by the unit phase that best
    matches it to ``want``: an orthogonalized mode is defined up to such a
    phase, and LAPACK, the JAX package and cuSOLVER pick it differently."""
    got, want = n(got), n(want)
    inner = np.sum(np.conj(got) * want, axis=(-2, -1), keepdims=True)
    return got * np.exp(1j * np.angle(inner)).astype(got.dtype)


def distinct_modes_probe(seed: int = 0, p: int = 16, nmodes: int = 3):
    """A (1, 1, nmodes, P, P) probe for the probe constraints: Hermite
    modes of a random-phase blob whose center of mass lies off the pixel
    grid's half-integers, scaled to distinct powers.

    ``constrain_center_peak`` rounds the distance of the center of mass
    from P/2, so a blob centered on a half-integer sits on a rounding tie
    that either package may break either way. Modes of equal power make
    the eigenvectors of the orthogonalization ill-conditioned: any unitary
    mix of them is as good, and psi does not see which was taken.
    """
    from tike_tpu.ptycho.probe import add_modes_cartesian_hermite

    gen = rng(seed)
    r, c = np.mgrid[:p, :p] + 0.5
    amp = np.exp(-((r - 0.52 * p) ** 2 + (c - 0.46 * p) ** 2) / (0.3 * p) ** 2)
    base = (amp * np.exp(1j * gen.uniform(-np.pi, np.pi, (p, p))))[None, None, None]
    modes = add_modes_cartesian_hermite(base.astype(np.complex64), nmodes)
    scale = np.linspace(1.0, 0.4, nmodes)[:, None, None]
    return (modes * scale).astype(np.complex64)


# The configurations of the fused path that the slice parity tests run,
# by name: (solver, algorithm options, object options, probe options,
# extra), where extra holds exit-wave options and ``eigen`` (bench_eigen's
# eigen probe and weights), ``distinct_modes`` (distinct_modes_probe as
# the start) and ``brightness``.
FUSED_CASES = {
    "rpie_compact": ("rpie", dict(batch_method="compact"), {}, {}, {}),
    "rpie_wobbly_center": ("rpie", dict(batch_method="wobbly_center"), {}, {}, {}),
    "rpie_random": ("rpie", dict(batch_method="random"), {}, {}, {}),
    "rpie_adam": (
        "rpie",
        dict(batch_method="wobbly_center"),
        dict(use_adaptive_moment=True),
        dict(use_adaptive_moment=True, update_period=2),
        dict(brightness=100.0),
    ),
    "rpie_checked": (
        "rpie",
        dict(batch_method="compact"),
        dict(use_adaptive_moment=True),
        dict(use_adaptive_moment=True),
        {},
    ),
    "rpie_constraints": (
        "rpie",
        dict(batch_method="wobbly_center"),
        dict(positivity_constraint=0.05, smoothness_constraint=0.01, clip_magnitude=True),
        dict(
            force_orthogonality=True,
            force_centered_intensity=True,
            probe_support=0.05,
            additional_probe_penalty=0.05,
            median_filter_abs_probe=True,
            median_filter_abs_probe_px=(2.0, 2.0),
            force_sparsity=0.05,
        ),
        dict(distinct_modes=True),
    ),
    "rpie_photons": (
        "rpie",
        dict(batch_method="wobbly_center", rescale_method="constant_probe_photons"),
        {},
        {},
        {},
    ),
    "rpie_eigen": ("rpie", dict(batch_method="wobbly_center"), {}, {}, dict(eigen=True)),
    "rpie_poisson": (
        "rpie", dict(batch_method="compact"), {}, {}, dict(noise_model="poisson")
    ),
    "lstsq_wobbly_momentum": (
        "lstsq",
        dict(batch_method="wobbly_center"),
        dict(use_adaptive_moment=True),
        dict(use_adaptive_moment=True),
        {},
    ),
    "lstsq_compact_checked": (
        "lstsq",
        dict(batch_method="compact"),
        dict(use_adaptive_moment=True),
        dict(use_adaptive_moment=True),
        {},
    ),
    "lstsq_poisson_all_modes": (
        "lstsq", dict(batch_method="wobbly_center"), {}, {}, dict(noise_model="poisson")
    ),
    "lstsq_poisson_dominant_mode": (
        "lstsq",
        dict(batch_method="compact"),
        {},
        {},
        dict(noise_model="poisson", step_length_usemodes="dominant_mode"),
    ),
}


def fused_case_data(data, case):
    """The slice's data, or for a case with a ``brightness`` the data of a
    probe that many times brighter.

    Non-compact rPIE with object AdaM adds a scale-free step (about 1 per
    pixel) divided by the illumination (ROADMAP.md §3). At the slice's own
    brightness the illumination is weak, and the object, and the cost,
    blow up in both packages alike (3 epochs: 459 then 1.4e12); with a
    100x brighter probe the cost falls.
    """
    b = FUSED_CASES[case][4].get("brightness", 1.0)
    return (data * b * b).astype(np.float32)


def fused_parameters(pkg, scan, probe, psi0, case, det=24):
    """The parameters of case ``case`` in package ``pkg`` (tike_tpu.ptycho
    or tike_tpu_torch.ptycho): 3 batches, rescale every 2 epochs."""
    solver, algo, oopts, popts, extra = FUSED_CASES[case]
    extra = dict(extra)
    eigen = extra.pop("eigen", False)
    probe = (probe * extra.pop("brightness", 1.0)).astype(np.complex64)
    if extra.pop("distinct_modes", False):
        probe = distinct_modes_probe(p=probe.shape[-1])
    options = pkg.RpieOptions if solver == "rpie" else pkg.LstsqOptions
    eig, weights = bench_eigen(probe, len(scan)) if eigen else (None, None)
    return pkg.PtychoParameters(
        probe=probe,
        psi=psi0,
        scan=scan,
        eigen_probe=eig,
        eigen_weights=weights,
        algorithm_options=options(num_batch=3, rescale_period=2, **algo),
        object_options=pkg.ObjectOptions(**oopts),
        probe_options=pkg.ProbeOptions(**popts),
        exitwave_options=pkg.ExitWaveOptions(
            measured_pixels=np.ones((det, det), bool), **extra
        ),
    )


def run_jax_fused(data, params, epochs=3):
    """``epochs`` of tike_tpu's fused path from ``params``, as the arrays
    and histories of ``convert.parameters_to_numpy``."""
    import tike_tpu.ptycho as jp
    from tike_tpu_torch import convert

    with jp.Reconstruction(data, params, random_seed=0) as context:
        assert context._fused_eligible()
        context.iterate(epochs)
        return convert.parameters_to_numpy(context.get_result())


# Fields and costs of a 3-epoch slice agree to this, relative to the
# largest value.
SLICE_TOL = 1e-5
# Moment states are normalized or accumulated gradients: residuals whose
# float32 rounding is larger, relative to their own size, than that of the
# fields (measured up to 3.9e-5 after 3 epochs).
MOMENT_TOL = 1e-4


def fused_slice(slice_data, case):
    """Run slice case ``case`` for 3 epochs from ``slice_data`` (scan,
    probe, starting psi, data) in both packages, with the same seed;
    return ``(got, want)``, the port's and tike_tpu's results."""
    import tike_tpu.ptycho as jp
    import tike_tpu_torch.ptycho as tp
    from tike_tpu_torch import convert

    scan, probe, psi0, data = slice_data
    data = fused_case_data(data, case)
    det = data.shape[-1]
    jparams = fused_parameters(jp, scan, probe, psi0, case, det)
    tparams = convert.parameters_from_jax(jparams)
    want = run_jax_fused(data, jparams)
    with tp.Reconstruction(data, tparams, device="cpu", random_seed=0) as context:
        context.iterate(3)
        got = convert.parameters_to_numpy(context.get_result())
    return got, want


def check_fused_slice(got, want, case):
    """Assert that a port result ``got`` matches tike_tpu's ``want`` (both
    from ``convert.parameters_to_numpy``) for slice case ``case``: costs,
    fields, eigen state and moment states; orthogonalized probes up to one
    phase per mode."""
    assert np.all(np.isfinite(got["costs"])) and got["costs"][-1] < got["costs"][0]
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=SLICE_TOL)
    ortho = FUSED_CASES[case][3].get("force_orthogonality", False)
    for key in ("psi", "probe", "eigen_probe", "eigen_weights"):
        if want[key] is None:
            assert got[key] is None, key
            continue
        value = got[key]
        if ortho and key == "probe":
            value = phase_aligned(value, want[key])
        assert_close(value, want[key], rtol=SLICE_TOL, atol=SLICE_TOL, scale=True)
    for key in ("object_v", "object_m", "probe_v", "probe_m"):
        if want[key] is None:
            assert got[key] is None, key
            continue
        assert isinstance(got[key], np.ndarray) and got[key].shape == want[key].shape
        assert_close(got[key], want[key], rtol=MOMENT_TOL, atol=MOMENT_TOL, scale=True)
    moments = any(want[k] is not None for k in ("object_m", "probe_m"))
    assert moments == any(k in case for k in ("adam", "checked", "momentum"))


def fit_rng(seed: int = 0) -> np.random.Generator:
    """The generator the port's ``Reconstruction(random_seed=seed)`` gives
    its affine position fit."""
    return np.random.default_rng(np.random.SeedSequence(seed).spawn(1)[0])


def seed_jax_position_fit(monkeypatch, seed: int = 0) -> None:
    """Make tike_tpu's per-epoch affine position fit draw its RANSAC
    subsets as the port draws them. tike_tpu's ``iterate`` calls the fit
    unseeded; this wraps the name its module looks up, for the
    test's duration, and hands it :func:`fit_rng`."""
    import tike_tpu.ptycho.ptycho as entry

    fit, gen = entry.affine_position_regularization, fit_rng(seed)
    monkeypatch.setattr(
        entry,
        "affine_position_regularization",
        lambda updated, position_options: fit(updated, position_options, rng=gen),
    )


def epoch_loop_parameters(pkg, scan, probe, psi0, solver, algo, position=None, det=24):
    """Parameters of a small slice in package ``pkg``: 3 batches, rescale
    every 2 epochs, ``position`` the PositionOptions keywords or None."""
    options = pkg.RpieOptions if solver == "rpie" else pkg.LstsqOptions
    return pkg.PtychoParameters(
        probe=probe,
        psi=psi0,
        scan=scan,
        algorithm_options=options(**{"num_batch": 3, "rescale_period": 2, **algo}),
        object_options=pkg.ObjectOptions(),
        probe_options=pkg.ProbeOptions(),
        position_options=None
        if position is None
        else pkg.PositionOptions(initial_scan=scan, **position),
        exitwave_options=pkg.ExitWaveOptions(measured_pixels=np.ones((det, det), bool)),
    )


def run_both_packages(data, jparams, epochs, *, fused, store=None, history=None):
    """``iterate(epochs)`` from ``jparams`` in tike_tpu and, through
    ``convert``, in the port (seed 0), each asserted to take the fused
    (``fused=True``) or the per-epoch path; ``history`` (costs, times)
    stands for epochs already run. Returns ``(got, want)`` from
    ``convert.parameters_to_numpy``."""
    import tike_tpu.ptycho as jp
    import tike_tpu_torch.ptycho as tp
    from tike_tpu_torch import convert

    if history is not None:
        jparams.algorithm_options.costs = [[c] for c in history[0]]
        jparams.algorithm_options.times = list(history[1])
    tparams = convert.parameters_from_jax(jparams)
    out = []
    for pkg, params, kw in ((jp, jparams, {}), (tp, tparams, dict(device="cpu"))):
        with pkg.Reconstruction(
            data, params, random_seed=0, store_data_on_device=store, **kw
        ) as context:
            assert context._fused_eligible() == fused
            context.iterate(epochs)
            out.append(convert.parameters_to_numpy(context.get_result()))
    return out[1], out[0]


def check_epoch_run(got, want, scan_px: float = 1e-4):
    """Costs and fields at SLICE_TOL, positions to ``scan_px`` pixels, the
    same number of epochs run."""
    assert len(got["costs"]) == len(want["costs"]) == len(got["times"])
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=SLICE_TOL)
    for key in ("psi", "probe"):
        assert_close(got[key], want[key], rtol=SLICE_TOL, atol=SLICE_TOL, scale=True)
    assert_close(got["scan"], want["scan"], rtol=0, atol=scan_px)
