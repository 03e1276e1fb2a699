"""Loading and preprocessing raw beamline data from disk.

Counterpart of :mod:`tike_tpu.ptycho.io`, host numpy as there: the APS
Velociprobe and LYNX instrument loaders and position unit conversion. The
readers import ``h5py`` when called, so this module imports without it.
"""

from __future__ import annotations

import logging
import typing
import warnings

import numpy as np
import numpy.typing as npt

from ..constants import wavelength
from ..precision import floating, integer

logger = logging.getLogger(__name__)

__all__ = [
    "position_units_to_pixels",
    "read_aps_velociprobe",
    "read_aps_lynx",
]


def position_units_to_pixels(
    positions,
    detector_distance,
    detector_pixel_count,
    detector_pixel_width,
    photon_energy,
):
    """Convert scanning positions from meters to pixel coordinates.

    The reconstruction pixel size is lambda * z / (N * p) for detector
    distance z, pixel count N, pixel width p.
    """
    pixel_per_meter = (detector_pixel_width * detector_pixel_count) / (
        detector_distance * wavelength(photon_energy / 1000) / 100
    )
    logger.info(
        f"For a detector of {detector_pixel_count:d} pixels"
        f" each {detector_pixel_width:.3e} m wide"
        f" with propagation distance {detector_distance:.3e} m"
        f" and photon energy {photon_energy:.3e} eV;"
        f" the reconstruction pixel size will be {1 / pixel_per_meter:.3e} m."
    )
    return positions * pixel_per_meter


def _autodetect_radius(beam_center_x, beam_center_y, w, h, max_crop):
    """Largest power-of-two half-width fitting around the beam center."""
    max_radius = max_crop // 2
    radius = 2
    while (
        radius <= max_radius
        and beam_center_x + radius < w
        and beam_center_y + radius < h
        and beam_center_x - radius >= 0
        and beam_center_y - radius >= 0
    ):
        radius *= 2
    return radius // 2


def _crop_bin_shift(x, bcy, bcx, radius, binned_pix, gap_value=None):
    """Crop square around beam center, bin pixels, ifftshift peak to corner."""
    cropped = np.asarray(
        x[..., bcy - radius : bcy + radius, bcx - radius : bcx + radius]
    )
    if gap_value is not None:
        cropped[cropped == gap_value] = 0
    binned_width = (2 * radius) // binned_pix
    binned = np.sum(
        cropped.reshape(
            -1, binned_width, binned_pix, binned_width, binned_pix
        ),
        axis=(-3, -1),
        dtype=cropped.dtype,
    )
    return np.fft.ifftshift(binned, axes=(-2, -1))


def read_aps_velociprobe(
    diffraction_path,
    position_path,
    xy_columns: typing.Tuple[int, int] = (5, 1),
    trigger_column: int = 7,
    max_crop: int = 2048,
    binned_pix: int = 1,
) -> typing.Tuple[npt.NDArray, npt.NDArray]:
    """Load ptychography data from the APS Velociprobe.

    Expects an HDF5 master file, with the detector's metadata under
    /entry/instrument/detector, the stage's chi angle at
    /entry/sample/goniometer/chi and the frames under /entry/data, plus
    CSV position file(s) whose ``xy_columns`` hold the positions and
    ``trigger_column`` the frame each row belongs to. Returns (data (FRAME, W, H) fft-shifted,
    scan (POSI, 2) float32 in pixel units, uncentered).
    """
    import h5py

    with h5py.File(diffraction_path, "r") as f:
        det = f["/entry/instrument/detector"]
        photon_energy = det["detectorSpecific/photon_energy"][()]  # eV
        detect_width = int(det["detectorSpecific/x_pixels_in_detector"][()])
        detect_height = int(det["detectorSpecific/y_pixels_in_detector"][()])
        detector_dist = det["detector_distance"][()]  # meter
        det_pix_width = det["x_pixel_size"][()]  # meter
        beam_center_x = int(det["beam_center_x"][()])
        beam_center_y = int(det["beam_center_y"][()])
        chi = float(f["entry/sample/goniometer/chi"][0])
        logger.info(
            "Loading 2-ID-D ptychography data:\n"
            f"\tstage rotation {chi} degrees\n"
            f"\tphoton energy {photon_energy} eV\n"
            f"\twidth: {detect_width}, center: {beam_center_x}\n"
            f"\theight: {detect_height}, center: {beam_center_y}"
        )
        radius = _autodetect_radius(
            beam_center_x, beam_center_y, detect_width, detect_height, max_crop
        )
        logger.info(f"Autodetected diffraction size is {2 * radius}.")
        if ((2 * radius) // binned_pix) * binned_pix != 2 * radius:
            raise ValueError(
                f"Invalid pixel binning provided! {2 * radius} cannot be "
                f"evenly collected into bins of {binned_pix}."
            )

        data = []
        for x in f["/entry/data"]:
            try:
                data.append(
                    _crop_bin_shift(
                        f[f"/entry/data/{x}"],
                        beam_center_y,
                        beam_center_x,
                        radius,
                        binned_pix,
                    )
                )
            except KeyError:
                # Master files may contain links to files never written.
                break
            except OSError as error:
                warnings.warn(
                    "The HDF5 compression plugin is probably missing. See "
                    "the conda-forge hdf5-external-filter-plugins package."
                )
                raise error
        data = np.concatenate(data, axis=0)

    paths = (
        position_path if isinstance(position_path, list) else [position_path]
    )
    raw_position = np.concatenate(
        [
            np.genfromtxt(
                p,
                usecols=(*xy_columns, trigger_column),
                delimiter=",",
                dtype=integer,
            )
            for p in paths
        ],
        axis=0,
    )

    # Group positions by trigger number; average first and last per trigger.
    sections = np.nonzero(np.diff(raw_position[:, -1]))[0] + 1
    groups = np.split(raw_position[:, :-1], sections, axis=0)
    scan = np.concatenate(
        [(g[:1] + g[-1:]) / 2 for g in groups], axis=0
    )

    # Rescale according to the velociprobe stage geometry.
    scan[:, 0] *= -1e-9
    scan -= np.mean(scan, axis=0, keepdims=True)
    scan[:, 1] *= 1e-9 * np.cos(chi / 180 * np.pi)
    logger.info(f"Loaded {len(scan)} scan positions.")

    if len(data) != len(scan):
        warnings.warn(
            f"The number of positions {scan.shape} and frames {data.shape}"
            " is not equal. One of the two will be truncated."
        )
        num_frame = min(len(data), len(scan))
        scan = scan[:num_frame]
        data = data[:num_frame]

    scan = position_units_to_pixels(
        scan,
        detector_dist,
        data.shape[-1],
        det_pix_width * binned_pix,
        photon_energy,
    )

    if not np.all(np.isfinite(data)):
        warnings.warn(
            "Some values in the diffraction data are not finite. "
            "Photon counts must be >= 0 and finite."
        )
    if np.any(data < 0):
        warnings.warn(
            "Some values in the diffraction data are negative. "
            "Photon counts must be >= 0 and finite."
        )
    return data, scan.astype(floating)


def read_aps_lynx(
    diffraction_path,
    position_path,
    photon_energy,
    beam_center_x,
    beam_center_y,
    detector_dist,
    xy_columns: typing.Tuple[int, int] = (6, 3),
    trigger_column: int = 0,
    max_crop: int = 2048,
    gap_value: int = 2**12 - 1,
    binned_pix: int = 1,
) -> typing.Tuple[npt.NDArray, npt.NDArray]:
    """Load ptychography data from APS LYNX.

    Expects an HDF5 file with /entry/data/eiger_4 and a space-separated DAT
    position file with two header rows (positions in nanometers).
    """
    import h5py

    with h5py.File(diffraction_path, "r") as f:
        dset = f["/entry/data/eiger_4"]
        det_pix_width = dset.attrs["Pixel_size"].item()  # meter
        _, detect_height, detect_width = dset.shape
        logger.info(
            "Loading 28-ID-C ptychography data:\n"
            f"\tphoton energy {photon_energy} eV\n"
            f"\twidth: {detect_width}, center: {beam_center_x}\n"
            f"\theight: {detect_height}, center: {beam_center_y}\n"
            f"\tdetector pixel width: {det_pix_width} m\n"
        )
        radius = _autodetect_radius(
            beam_center_x, beam_center_y, detect_width, detect_height, max_crop
        )
        logger.info(f"Autodetected diffraction size is {2 * radius}.")
        if ((2 * radius) // binned_pix) * binned_pix != 2 * radius:
            raise ValueError(
                f"Invalid pixel binning provided! {2 * radius} cannot be "
                f"evenly collected into bins of {binned_pix}."
            )
        try:
            data = _crop_bin_shift(
                dset,
                beam_center_y,
                beam_center_x,
                radius,
                binned_pix,
                gap_value=gap_value,
            )
        except OSError as error:
            warnings.warn(
                "The HDF5 compression plugin is probably missing. See "
                "the conda-forge hdf5-external-filter-plugins package."
            )
            raise error

    raw_position = np.genfromtxt(
        position_path,
        usecols=(*xy_columns, trigger_column),
        skip_header=2,
        dtype=np.float64,
    )
    sections = np.nonzero(np.diff(raw_position[:, -1]))[0] + 1
    groups = np.split(raw_position[:, :-1], sections, axis=0)
    scan = np.concatenate(
        [np.mean(g, axis=0, keepdims=True) for g in groups], axis=0
    )
    # nanometers -> meters; vertical axis flipped.
    scan *= 1e-9
    scan[:, 0] *= -1
    scan -= np.mean(scan, axis=0, keepdims=True)
    logger.info(f"Loaded {len(scan)} scan positions.")

    if len(data) != len(scan):
        warnings.warn(
            f"The number of positions {scan.shape} and frames {data.shape}"
            " is not equal. One of the two will be truncated."
        )
        num_frame = min(len(data), len(scan))
        scan = scan[:num_frame]
        data = data[:num_frame]

    scan = position_units_to_pixels(
        scan,
        detector_dist,
        data.shape[-1],
        det_pix_width * binned_pix,
        photon_energy,
    )
    return data, scan.astype(floating)
