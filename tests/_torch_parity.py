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
