"""The port's zone-plate probes, instrument loaders, training-patch helper
and view against tike_tpu's.

fresnel, io and the numerics of view are host numpy in both packages and
give the same bits on the same inputs. ``learn.extract_patches`` gathers
with the port's ``patch_fwd`` (its plain version on the CPU) and agrees
with tike_tpu's to 1e-6 relative to the largest value. The loaders read
synthetic HDF5 and CSV files built in ``tmp_path`` in the instruments'
layouts; the plots run under the Agg backend on tensors and on numpy.
"""

import warnings

import numpy as np
import pytest
import torch

import tike_tpu.ptycho.fresnel as jfresnel
import tike_tpu.ptycho.io as jio
import tike_tpu.ptycho.learn as jlearn
import tike_tpu.view as jview
from tike_tpu_torch.ptycho import fresnel as tfresnel
from tike_tpu_torch.ptycho import io as tio
from tike_tpu_torch.ptycho import learn as tlearn
from tike_tpu_torch.ptycho.position import AffineTransform
import tike_tpu_torch.view as tview

from . import _torch_parity as H

OPTICS = dict(lambda0=1.24e-9 / 10, dx=20e-9, dis_defocus=800e-6)


@pytest.mark.parametrize(
    "zone_plate", ["velo", "2idd", dict(radius=90e-6, outmost=50e-9, beamstop=0.0)],
    ids=["velo", "2idd", "custom"],
)
def test_single_probe_matches_jax_bitwise(zone_plate):
    kw = dict(probe_shape=64, zone_plate_params=zone_plate, **OPTICS)
    got = tfresnel.single_probe(**kw)
    assert got.shape == (1, 1, 1, 64, 64) and got.dtype == np.complex64
    np.testing.assert_allclose(np.sum(np.abs(got) ** 2), 1.0, rtol=1e-4)
    np.testing.assert_array_equal(got, jfresnel.single_probe(**kw))


@pytest.mark.parametrize("spectrum", [False, True], ids=["gaussian", "given"])
def test_mw_probe_matches_jax_bitwise(spectrum):
    kw = dict(probe_shape=32, zone_plate_params="velo", energy=3, bandwidth=0.02, **OPTICS)
    if spectrum:
        lam = OPTICS["lambda0"] * np.linspace(0.99, 1.01, 9)
        kw["spectrum"] = np.stack([lam, np.exp(-np.linspace(-2, 2, 9) ** 2)], -1)
    got = tfresnel.MW_probe(**kw)
    assert got.shape == (1, 1, 3, 32, 32)
    powers = np.sum(np.abs(got[0, 0]) ** 2, axis=(-2, -1))
    assert np.all(np.diff(powers) <= 1e-6), powers
    np.testing.assert_array_equal(got, jfresnel.MW_probe(**kw))


def test_unknown_zone_plate_raises():
    with pytest.raises(ValueError, match="not a known zone plate"):
        tfresnel.single_probe(probe_shape=8, zone_plate_params="nope", **OPTICS)


@pytest.mark.parametrize("energy", [8000.0, 10000.0])
def test_position_units_to_pixels_matches_jax_bitwise(energy):
    positions = H.rng(30).uniform(-1e-6, 1e-6, (20, 2)).astype(np.float32)
    kw = dict(
        detector_distance=2.0, detector_pixel_count=512, detector_pixel_width=75e-6,
        photon_energy=energy,
    )
    np.testing.assert_array_equal(
        tio.position_units_to_pixels(positions, **kw),
        jio.position_units_to_pixels(positions, **kw),
    )


def _velociprobe_files(tmpdir, nframes):
    """A master file and a CSV position file in the Velociprobe layout;
    two rows per trigger, one trigger short of the frames when
    ``nframes`` is odd (the loader truncates)."""
    import h5py

    gen = H.rng(31)
    det = 64
    h5path = f"{tmpdir}/master.h5"
    with h5py.File(h5path, "w") as f:
        d = f.create_group("entry/instrument/detector")
        d["detectorSpecific/photon_energy"] = 10000.0
        d["detectorSpecific/x_pixels_in_detector"] = det
        d["detectorSpecific/y_pixels_in_detector"] = det
        d["detector_distance"] = 2.0
        d["x_pixel_size"] = 75e-6
        d["beam_center_x"] = det // 2 + 3
        d["beam_center_y"] = det // 2 - 2
        f["entry/sample/goniometer/chi"] = np.array([15.0])
        f["entry/data/data_000001"] = gen.integers(0, 100, (nframes, det, det)).astype(np.int32)
    rows = []
    for t in range(nframes - nframes % 2):
        for r in range(2):
            row = [0] * 8
            row[5] = int(1000 * (t + 1) + 10 * r + gen.integers(0, 5))
            row[1] = int(2000 * (t + 1) + 10 * r)
            row[7] = t
            rows.append(",".join(str(v) for v in row))
    csvpath = f"{tmpdir}/positions.csv"
    with open(csvpath, "w") as f:
        f.write("\n".join(rows))
    return h5path, csvpath


@pytest.mark.parametrize("nframes, binned_pix", [(6, 1), (7, 2)])
def test_read_aps_velociprobe_matches_jax_bitwise(tmp_path, nframes, binned_pix):
    h5path, csvpath = _velociprobe_files(tmp_path, nframes)
    kw = dict(binned_pix=binned_pix)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        data, scan = tio.read_aps_velociprobe(h5path, csvpath, **kw)
        want_data, want_scan = jio.read_aps_velociprobe(h5path, csvpath, **kw)
    assert len(caught) == (2 if nframes % 2 else 0)
    assert scan.dtype == np.float32 and data.shape[0] == scan.shape[0] == nframes - nframes % 2
    np.testing.assert_array_equal(data, want_data)
    np.testing.assert_array_equal(scan, want_scan)


@pytest.mark.parametrize("gap_value", [2**12 - 1, 7])
def test_read_aps_lynx_matches_jax_bitwise(tmp_path, gap_value):
    import h5py

    gen = H.rng(32)
    det, nframes = 32, 4
    h5path = f"{tmp_path}/lynx.h5"
    with h5py.File(h5path, "w") as f:
        dset = f.create_dataset(
            "entry/data/eiger_4", data=gen.integers(0, 50, (nframes, det, det)).astype(np.int32)
        )
        dset.attrs["Pixel_size"] = 75e-6
    lines = ["header1", "header2"]
    for t in range(nframes):
        for r in range(2):
            row = [0.0] * 7
            row[0] = t
            row[6] = 100.0 * (t + 1) + r
            row[3] = 200.0 * (t + 1) - r
            lines.append(" ".join(str(v) for v in row))
    datpath = f"{tmp_path}/positions.dat"
    with open(datpath, "w") as f:
        f.write("\n".join(lines))
    kw = dict(
        photon_energy=10000.0, beam_center_x=det // 2, beam_center_y=det // 2,
        detector_dist=2.0, gap_value=gap_value,
    )
    data, scan = tio.read_aps_lynx(h5path, datpath, **kw)
    want_data, want_scan = jio.read_aps_lynx(h5path, datpath, **kw)
    assert data.shape[0] == scan.shape[0] == nframes
    np.testing.assert_array_equal(data, want_data)
    np.testing.assert_array_equal(scan, want_scan)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_extract_patches_matches_jax(kind):
    gen = H.rng(33)
    psi = H.crandn(gen, 64, 72)
    scan = H.positions(gen, 30, 64, 72, 8)
    scan[0] = (3.0, 5.0)  # an integer corner: the direct window
    want = jlearn.extract_patches(psi, scan, 8)
    if kind == "tensor":
        got = tlearn.extract_patches(H.t(psi), H.t(scan), 8)
        assert isinstance(got, torch.Tensor)
    else:
        got = tlearn.extract_patches(psi, scan, 8, device="cpu")
        assert isinstance(got, np.ndarray) and got.dtype == np.complex64
    H.assert_close(got, want, rtol=1e-6, atol=1e-6, scale=True)
    np.testing.assert_allclose(H.n(got)[0], psi[3:11, 5:13], rtol=1e-6)
    with pytest.raises(ValueError, match="Scan positions"):
        tlearn.extract_patches(psi, np.array([[0.5, 3.0]], np.float32), 8, device="cpu")


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_complex_hsv_to_rgb_matches_jax(kind):
    z = H.crandn(H.rng(34), 16, 12)
    got = tview.complexHSV_to_RGB(H.t(z) if kind == "tensor" else z)
    assert got.shape == (16, 12, 3) and got.min() >= 0 and got.max() <= 1
    np.testing.assert_array_equal(got, jview.complexHSV_to_RGB(z))


@pytest.mark.parametrize("interpolation", [None, 2, 4])
@pytest.mark.parametrize("scale", [(2, 2), (0.5, 1.5)])
def test_resize_complex_image_matches_jax_bitwise(interpolation, scale):
    z = H.crandn(H.rng(35), 24, 20)
    got = tview.resize_complex_image(z, scale, interpolation)
    np.testing.assert_array_equal(got, jview.resize_complex_image(z, scale, interpolation))


def test_coverage_histogram_matches_jax_bitwise():
    gen = H.rng(36)
    theta, v, h = gen.uniform(0, 3, 200), gen.uniform(-0.4, 0.4, 200), gen.uniform(-0.4, 0.4, 200)
    kw = dict(bins=(4, 3, 2), probe_grid=np.array([[1, 0], [1, 1]]), probe_shape=(0.1, 0.1))
    got = tview.coverage_histogram(H.t(theta), v, h, **kw)
    np.testing.assert_array_equal(got, jview.coverage_histogram(theta, v, h, **kw))


def _plots(convert):
    gen = H.rng(37)
    probe = convert(H.crandn(gen, 1, 1, 3, 16, 16))
    true = gen.uniform(0, 10, (32, 2)).astype(np.float32)
    estimate = convert(true + gen.normal(0, 0.3, true.shape).astype(np.float32))
    theta = np.linspace(0, np.pi, 16)
    z = convert(H.crandn(gen, 8, 8))
    return {
        "plot_probe_power": (probe,),
        "plot_probe_power_series": ([convert(gen.random(3)) for _ in range(4)],),
        "plot_position_error": (convert(true), estimate),
        "plot_positions": (convert(true), estimate),
        "plot_positions_convergence": (convert(true), estimate),
        "plot_complex": (z,),
        "plot_phase": (z,),
        "trajectory": (convert(theta), convert(np.cos(theta))),
        "plot_footprint": (theta, convert(np.cos(theta)), np.sin(theta)),
        "plot_trajectories": (theta, convert(np.cos(theta)), np.sin(theta), theta),
        "plot_cost_convergence": ([convert(gen.random(3)) for _ in range(6)], gen.random(6)),
        "plot_eigen_weights": (convert(gen.standard_normal((64, 2, 3))),),
        "plot_affine_transform": (
            AffineTransform(scale0=1.01, scale1=0.99, shear1=0.01, angle=0.02), estimate
        ),
        "plot_sino_coverage": (theta, convert(np.cos(theta) * 0.2), np.sin(theta) * 0.2),
    }


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_every_plot_runs(kind):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    plots = _plots(H.t if kind == "tensor" else np.asarray)
    assert set(tview.__all__) - {"complexHSV_to_RGB", "resize_complex_image"} == (
        set(plots) - {"plot_sino_coverage"}
    )
    try:
        for name, args in plots.items():
            getattr(tview, name)(*args)
            plt.close("all")
    finally:
        plt.close("all")
