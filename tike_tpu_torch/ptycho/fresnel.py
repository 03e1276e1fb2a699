"""Probe initialization from a Fresnel zone-plate optics model.

Counterpart of :mod:`tike_tpu.ptycho.fresnel`, host numpy as there (it runs
once at set-up): build the zone plate's complex transmission,
Fresnel-propagate it to the (defocused) sample plane, and normalize.
"""

from __future__ import annotations

import numpy as np

from ..precision import cfloating

__all__ = ["single_probe", "MW_probe"]

_KNOWN_ZONE_PLATES = {
    "velo": {"radius": 90e-6, "outmost": 50e-9, "beamstop": 60e-6},
    "2idd": {"radius": 80e-6, "outmost": 70e-9, "beamstop": 60e-6},
    "lamni": {"radius": 114.8e-6 / 2, "outmost": 60e-9, "beamstop": 40e-6},
}


def _get_setup(zone_plate_params):
    if isinstance(zone_plate_params, str):
        if zone_plate_params in _KNOWN_ZONE_PLATES:
            return _KNOWN_ZONE_PLATES[zone_plate_params]
        raise ValueError(
            f"{zone_plate_params} is not a known zone plate. "
            f"Choose one of {list(_KNOWN_ZONE_PLATES)} or provide a "
            "dictionary with custom zone plate parameters."
        )
    return zone_plate_params


def _fzp_transfer(wavelength, dis_defocus, M, dx, zone_plate_params):
    """Zone-plate transmission function, its pixel size, and focal length."""
    p = _get_setup(zone_plate_params)
    FL = 2 * p["radius"] * p["outmost"] / wavelength
    dx_fzp = wavelength * (FL + dis_defocus) / M / dx
    grid = -dx_fzp * np.arange(-np.floor(M / 2), np.ceil(M / 2))
    X, Y = np.meshgrid(grid, grid)
    R2 = X**2 + Y**2
    # Thin-lens phase chirp restricted to the zone plate annulus.
    T = np.exp(-1j * np.pi / wavelength * R2 / FL)
    annulus = (np.sqrt(R2) <= p["radius"]) & (
        np.sqrt(R2) >= p["beamstop"] / 2
    )
    return T * annulus, dx_fzp, FL


def _fresnel_propagation(field, dxy, z, wavelength):
    """Single-FFT Fresnel propagation of a field by distance z."""
    M, N = field.shape
    k = 2 * np.pi / wavelength
    mg = np.arange(-np.floor(M / 2), np.ceil(M / 2))
    ng = np.arange(-np.floor(N / 2), np.ceil(N / 2))
    X, Y = np.meshgrid(mg * dxy, ng * dxy)
    fu = wavelength * z / dxy
    Fx, Fy = np.meshgrid(mg * fu / M, ng * fu / N)
    if z > 0:
        pf = np.exp(1j * k * z) * np.exp(1j * k * (Fx**2 + Fy**2) / 2 / z)
        kern = field * np.exp(1j * k * (X**2 + Y**2) / 2 / z)
        cgh = np.fft.fft2(np.fft.fftshift(kern))
        return np.fft.fftshift(cgh * np.fft.fftshift(pf))
    pf = np.exp(1j * k * z) * np.exp(1j * k * (X**2 + Y**2) / 2 / z)
    cgh = np.fft.ifft2(
        np.fft.fftshift(field * np.exp(1j * k * (Fx**2 + Fy**2) / 2 / z))
    )
    return np.fft.fftshift(cgh) * pf


def single_probe(probe_shape, lambda0, dx, dis_defocus, zone_plate_params):
    """Estimate the probe via a Fresnel model of the focusing optics.

    probe_shape is the probe's width in pixels, lambda0 the wavelength
    [m], dx the pixel size at the sample [m], dis_defocus the distance
    from the focus to the sample [m], and zone_plate_params a known zone
    plate's name ('velo', '2idd', 'lamni') or a dict of its 'radius',
    'outmost' zone width and 'beamstop' diameter [m]. Returns
    (1, 1, 1, W, H) complex64 of unit L2 norm.
    """
    T, dx_fzp, FL0 = _fzp_transfer(
        lambda0, dis_defocus, probe_shape, dx, zone_plate_params
    )
    probe = _fresnel_propagation(T, dx_fzp, FL0 + dis_defocus, lambda0)
    probe = probe / np.sqrt(np.sum(np.abs(probe) ** 2))
    return probe[None, None, None].astype(cfloating)


def _gaussian_spectrum(lambda0, bandwidth, energy):
    spectrum = np.zeros((energy, 2))
    sigma = lambda0 * bandwidth / 2.355
    d_lam = sigma * 4 / (energy - 1)
    spectrum[:, 0] = (
        np.arange(-np.floor(energy / 2), np.ceil(energy / 2)) * d_lam
        + lambda0
    )
    spectrum[:, 1] = np.exp(-((spectrum[:, 0] - lambda0) ** 2) / sigma**2)
    return spectrum


def MW_probe(
    probe_shape,
    lambda0,
    dx,
    dis_defocus,
    zone_plate_params,
    energy=1,
    bandwidth=0.01,
    spectrum=None,
):
    """Estimate multi-energy probes (one mode per wavelength).

    The parameters are :func:`single_probe`'s, and ``energy`` wavelengths
    are taken from a Gaussian spectrum of relative width ``bandwidth``, or
    from ``spectrum`` (energy, 2) rows of (wavelength, intensity). Returns
    (1, 1, energy, W, H) complex64 sorted by spectral intensity.
    """
    if spectrum is None:
        spectrum = _gaussian_spectrum(lambda0, bandwidth, energy)
    else:
        spectrum = spectrum[:: spectrum.shape[0] // energy, :][:energy, :]
        lambda0 = spectrum[np.argmax(spectrum[1, :]), 0]
    spectrum = spectrum[np.argsort(-spectrum[:, 1])]

    _, _, FL0 = _fzp_transfer(
        spectrum[0, 0], dis_defocus, probe_shape, dx, zone_plate_params
    )
    probes = []
    for i in range(energy):
        T, dx_fzp, _ = _fzp_transfer(
            spectrum[i, 0], dis_defocus, probe_shape, dx, zone_plate_params
        )
        p = _fresnel_propagation(
            T, dx_fzp, FL0 + dis_defocus, spectrum[i, 0]
        )
        p = p / np.sqrt(np.sum(np.abs(p) ** 2))
        probes.append(p * np.sqrt(spectrum[i, 1]))
    return np.stack(probes, axis=0)[None, None].astype(cfloating)
