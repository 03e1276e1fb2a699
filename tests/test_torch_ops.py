"""tike_tpu_torch's operators and host helpers against tike_tpu's.

Covers the far-field propagation, the noise models, the single-slice
forward model, ``linalg.mnorm``, the batch clustering that both packages
run on the host, and the parameter converter. All float32 / complex64;
tolerances are 1e-5 relative unless a comment says otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tike_tpu.cluster as jcluster
import tike_tpu.linalg as jlinalg
import tike_tpu.ptycho as jptycho
from tike_tpu.ops import objective as jobj
from tike_tpu.ops import propagation as jprop
from tike_tpu.ops import ptycho as jops

import tike_tpu_torch.cluster as tcluster
import tike_tpu_torch.linalg as tlinalg
import tike_tpu_torch.ptycho as tptycho
from tike_tpu_torch import convert
from tike_tpu_torch.ops import objective as tobj
from tike_tpu_torch.ops import propagation as tprop
from tike_tpu_torch.ops import ptycho as tops

from . import _torch_parity as H


@pytest.mark.parametrize("direction", ["fwd", "adj"])
def test_propagation_matches_jax(direction):
    x = H.crandn(H.rng(1), 4, 2, 24, 24)
    jf = getattr(jprop, f"propagation_{direction}")
    tf = getattr(tprop, f"propagation_{direction}")
    H.assert_close(tf(H.t(x)), jf(jnp.asarray(x)), rtol=1e-5, atol=1e-6)


def _noise_inputs():
    gen = H.rng(2)
    farplane = H.crandn(gen, 5, 1, 2, 12, 12)
    intensity = np.sum(np.abs(farplane) ** 2, axis=(1, 2)).astype(np.float32)
    data = gen.poisson(intensity).astype(np.float32)
    return data, farplane, intensity


@pytest.mark.parametrize("model", ["gaussian", "poisson"])
@pytest.mark.parametrize("table", ["ELEMENTWISE", "EACH_PATTERN", "COST"])
def test_objectives_match_jax(model, table):
    data, _, intensity = _noise_inputs()
    want = getattr(jobj, table)[model](jnp.asarray(data), jnp.asarray(intensity))
    got = getattr(tobj, table)[model](H.t(data), H.t(intensity))
    H.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model", ["gaussian", "poisson"])
def test_gradients_match_jax(model):
    data, farplane, intensity = _noise_inputs()
    want = jobj.GRAD[model](
        jnp.asarray(data), jnp.asarray(farplane), jnp.asarray(intensity)
    )
    got = tobj.GRAD[model](H.t(data), H.t(farplane), H.t(intensity))
    H.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _forward_inputs(det):
    gen = H.rng(4)
    h, p, n = 64, 16, 9
    psi = H.crandn(gen, 1, h, h)
    scan = H.positions(gen, n, h, h, p)
    probe = H.crandn(gen, 1, 1, 2, p, p)
    jcfg = jops.PtychoConfig(probe_shape=p, detector_shape=det, nz=h, n=h)
    tcfg = tops.PtychoConfig(probe_shape=p, detector_shape=det, nz=h, n=h)
    return jcfg, tcfg, psi, scan, probe


@pytest.mark.parametrize("det", [16, 24, 25])
def test_pad_and_crop_match_jax(det):
    jcfg, tcfg, *_ = _forward_inputs(det)
    x = H.crandn(H.rng(5), 3, 2, 16, 16)
    padded = tops._pad_to_detector(H.t(x), tcfg)
    H.assert_close(padded, jops._pad_to_detector(jnp.asarray(x), jcfg), rtol=0)
    H.assert_close(tops._crop_from_detector(padded, tcfg), x, rtol=0)


@pytest.mark.parametrize("det", [16, 24])
def test_ptycho_fwd_and_intensity_match_jax(det):
    jcfg, tcfg, psi, scan, probe = _forward_inputs(det)
    jargs = (jnp.asarray(psi), jnp.asarray(scan), jnp.asarray(probe[:, 0]))
    targs = (H.t(psi), H.t(scan), H.t(probe[:, 0]))
    far_j = jops.ptycho_fwd(jcfg, *jargs)
    far_t = tops.ptycho_fwd(tcfg, *targs)
    H.assert_close(far_t, far_j, rtol=1e-5, atol=1e-5, scale=True)
    H.assert_close(
        tops.intensity_from_farplane(far_t),
        jops.intensity_from_farplane(far_j),
        rtol=1e-5,
        atol=1e-5,
        scale=True,
    )
    H.assert_close(
        tops.simulate_intensity(tcfg, *targs),
        jops.simulate_intensity(jcfg, *jargs),
        rtol=1e-5,
        atol=1e-5,
        scale=True,
    )


def test_ptycho_cost_matches_jax():
    jcfg, tcfg, psi, scan, probe = _forward_inputs(24)
    data = np.asarray(
        jops.simulate_intensity(
            jcfg, jnp.asarray(psi * 0.9), jnp.asarray(scan), jnp.asarray(probe[:, 0])
        )
    )
    want = jops.ptycho_cost(
        jcfg, jnp.asarray(data), jnp.asarray(psi), jnp.asarray(scan),
        jnp.asarray(probe[:, 0]),
    )
    got = tops.ptycho_cost(tcfg, H.t(data), H.t(psi), H.t(scan), H.t(probe[:, 0]))
    H.assert_close(got, want, rtol=1e-5)


def test_multislice_raises():
    tcfg = tops.PtychoConfig(probe_shape=8, detector_shape=8, nz=32, n=32, nslices=2)
    with pytest.raises(NotImplementedError, match="multislice"):
        tops.ptycho_fwd(
            tcfg,
            torch.zeros(2, 32, 32, dtype=torch.complex64),
            torch.ones(1, 2),
            torch.zeros(1, 1, 8, 8, dtype=torch.complex64),
        )


@pytest.mark.parametrize("real", [False, True])
def test_mnorm_matches_jax(real):
    x = H.crandn(H.rng(6), 3, 7, 5)
    x = x.real.copy() if real else x
    H.assert_close(tlinalg.mnorm(H.t(x)), jlinalg.mnorm(jnp.asarray(x)), rtol=1e-6)
    H.assert_close(
        tlinalg.mnorm(H.t(x), dim=(-2, -1), keepdim=True),
        jlinalg.mnorm(jnp.asarray(x), axis=(-2, -1), keepdims=True),
        rtol=1e-6,
    )


@pytest.mark.parametrize("num_batch", [1, 3, 7])
def test_compact_batches_match_jax(num_batch):
    scan = H.positions(H.rng(7), 90, 200, 150, 16)
    jorder, jbatches, jstart = jcluster.by_scan_stripes_contiguous(
        scan, 1, "compact", num_batch, rng=np.random.default_rng(11)
    )
    torder, tbatches, tstart = tcluster.by_scan_stripes_contiguous(
        scan, 1, "compact", num_batch, rng=np.random.default_rng(11)
    )
    assert jstart == tstart
    np.testing.assert_array_equal(torder[0], jorder[0])
    for a, b in zip(jcluster.batches_padded(jbatches[0]), tcluster.batches_padded(tbatches[0])):
        np.testing.assert_array_equal(b, a)


def test_unported_batch_method_raises():
    """Every batch method of tike_tpu is ported; another name raises."""
    assert sorted(tcluster.BATCH_METHODS) == sorted(jcluster.BATCH_METHODS)
    with pytest.raises(NotImplementedError, match="no_such_method"):
        tcluster.by_scan_stripes_contiguous(
            H.positions(H.rng(8), 10, 64, 64, 8), 1, "no_such_method", 2
        )


def test_host_helpers_match_jax():
    np.testing.assert_array_equal(tptycho.gaussian(17), jptycho.gaussian(17))
    scan = H.positions(H.rng(9), 20, 80, 90, 16) + 3.0
    probe = np.zeros((1, 1, 1, 16, 16), np.complex64)
    jpsi, jscan = jptycho.get_padded_object(scan, probe)
    tpsi, tscan = tptycho.get_padded_object(scan, probe)
    np.testing.assert_array_equal(tpsi, jpsi)
    np.testing.assert_array_equal(tscan, jscan)
    tptycho.check_allowed_positions(tscan, tpsi[None], probe.shape)
    with pytest.raises(ValueError, match="Scan positions"):
        tptycho.check_allowed_positions(tscan - 2, tpsi[None], probe.shape)


def test_parameters_round_trip_through_converter():
    scan, psi, probe, psi0 = H.slice_inputs(npos=20, h=64)
    jp = jptycho.PtychoParameters(
        probe=probe,
        psi=psi0,
        scan=scan,
        algorithm_options=jptycho.LstsqOptions(
            num_batch=3, batch_method="compact", rescale_period=2
        ),
        object_options=jptycho.ObjectOptions(),
        probe_options=jptycho.ProbeOptions(probe_photons=5.0),
        exitwave_options=jptycho.ExitWaveOptions(
            measured_pixels=np.ones((24, 24), bool), noise_model="gaussian"
        ),
    )
    tp = convert.parameters_from_jax(jp)
    assert isinstance(tp, tptycho.PtychoParameters)
    assert tp.algorithm_options.name == "lstsq_grad"
    assert tp.algorithm_options.num_batch == 3
    assert tp.algorithm_options.rescale_period == 2
    assert tp.probe_options.probe_photons == 5.0
    assert tp.exitwave_options.measured_pixels.shape == (24, 24)
    a, b = convert.parameters_to_numpy(jp), convert.parameters_to_numpy(tp)
    for key in ("probe", "psi", "scan"):
        np.testing.assert_array_equal(b[key], a[key])
        assert b[key].dtype == a[key].dtype
    dev = tp.copy_to_device("cpu")
    assert dev.psi.dtype == torch.complex64 and dev.scan.dtype == torch.float32
    back = dev.copy_to_host()
    np.testing.assert_array_equal(back.psi, b["psi"])
