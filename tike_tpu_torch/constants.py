"""Universal constants and physical relation functions (units: keV, cm).

The port's own copy of :mod:`tike_tpu.constants` (numpy only), so that
nothing here imports the JAX package. Joint ADMM reads ``wavenumber``.
"""

__all__ = [
    "PLANCK_CONSTANT",
    "SPEED_OF_LIGHT",
    "wavelength",
    "wavenumber",
    "complex_amplitude",
    "complex_intensity",
    "complex_phase",
    "sum_square_norm",
]

import numpy as np

PLANCK_CONSTANT = 6.58211928e-19  # [keV*s]
SPEED_OF_LIGHT = 299792458e2  # [cm/s]


def wavelength(energy):
    """Return the wavelength [cm] for a given energy [keV]."""
    return 2 * np.pi * PLANCK_CONSTANT * SPEED_OF_LIGHT / energy


def wavenumber(energy):
    """Return the wavenumber [1/cm] given energy [keV]."""
    return energy / PLANCK_CONSTANT / SPEED_OF_LIGHT


def complex_amplitude(probe_grid):
    """Amplitude of the complex wave."""
    return np.abs(probe_grid)


def complex_intensity(probe_grid):
    """Intensity of the complex wave."""
    return np.square(np.abs(probe_grid))


def complex_phase(probe_grid):
    """Phase of the complex wave."""
    return np.angle(probe_grid)


def sum_square_norm(x, N=1):
    """Return x normalized such that the sum of squares of x equals N."""
    return np.sqrt(np.square(x) / np.sum(np.square(x)) * N)
