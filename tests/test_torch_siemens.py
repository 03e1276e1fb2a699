"""rPIE on the measured siemens-star data: the port against tike_tpu.

``bench_all.py::bench_rpie_siemens``'s options (``RpieOptions(num_batch=5,
batch_method='compact')``, default object and probe options, its object
and scan set-up) for 3 epochs on the 516 measured 128x128 patterns. The
start is a constant 0.5 object, where many far-field pixels are modeled
near 0 and the Gaussian gradient carries float32 rounding (ROADMAP.md
§3), so the port is held to the reference's own sensitivity: moving the
reference's starting probe and psi by one float32 ulp must move its
result at least half as far as the port is from it.
"""

import bz2
import os

import numpy as np

import tike_tpu.ptycho as jp

import tike_tpu_torch.ptycho as tp
from tike_tpu_torch import convert

from . import _torch_parity as H

DATA = os.path.join(os.path.dirname(__file__), "data", "siemens-star-small.npz.bz2")


def siemens():
    """bench_all.py's _siemens(): data, scan, probe and a constant object
    covering the scan with a 20-pixel margin."""
    with bz2.open(DATA, "rb") as f:
        a = np.load(f)
        scan = a["scan"][0].astype(np.float32)
        data = a["data"][0].astype(np.float32)
        probe = a["probe"][0].astype(np.complex64)
    scan = scan - np.amin(scan, axis=-2) + 20
    w = probe.shape[-1]
    h = int(np.ceil(scan[:, 0].max())) + w + 21
    ww = int(np.ceil(scan[:, 1].max())) + w + 21
    psi = np.full((1, h, ww), 0.5 + 0j, dtype=np.complex64)
    return data, scan, probe, psi


def _parameters(scan, probe, psi):
    return jp.PtychoParameters(
        probe=probe,
        psi=psi,
        scan=scan,
        algorithm_options=jp.RpieOptions(num_batch=5, batch_method="compact"),
        object_options=jp.ObjectOptions(),
        probe_options=jp.ProbeOptions(),
    )


def test_rpie_siemens_matches_jax():
    data, scan, probe, psi = siemens()
    assert data.shape == (516, 128, 128)

    def run_jax(probe, psi):
        with jp.Reconstruction(data, _parameters(scan, probe, psi), random_seed=0) as c:
            c.iterate(3)
            return convert.parameters_to_numpy(c.get_result())

    want = run_jax(probe, psi)
    gen = H.rng(1)
    nudged = run_jax(H.one_ulp(gen, probe), H.one_ulp(gen, psi))
    tparams = convert.parameters_from_jax(_parameters(scan, probe, psi))
    with tp.Reconstruction(data, tparams, device="cpu", random_seed=0) as c:
        c.iterate(3)
        got = convert.parameters_to_numpy(c.get_result())

    costs = np.ravel(got["costs"])
    assert np.all(np.isfinite(costs)) and np.all(np.diff(costs) < 0)
    gap = np.max(np.abs(costs / np.ravel(want["costs"]) - 1))
    own = np.max(np.abs(np.ravel(nudged["costs"]) / np.ravel(want["costs"]) - 1))
    assert gap <= max(2 * own, 1e-5), (gap, own)
    for key in ("psi", "probe"):
        gap = np.max(np.abs(got[key] - want[key]))
        own = np.max(np.abs(nudged[key] - want[key]))
        assert gap <= 2 * own, (key, gap, own)
