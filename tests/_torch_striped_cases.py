"""Shared cases of the striped-object tests (``object_sharding="striped"``),
for the CPU parity tests and the card's tests alike: no JAX here.

:func:`problem` is ``tests/parallel/test_striped.py``'s ``_setup`` (a
160 x 160 object, a 16 x 16 Gaussian probe with a 0.2 rad phase, seeded
uniform positions) with the intensities simulated by the port on the CPU,
so that the card's tests need no JAX; the parity tests hand the same
arrays to both packages. :func:`start` is a perturbed 0.5 object: from a
constant start with a smooth probe, many far-field pixels are near 0,
where the Gaussian gradient follows the FFT's rounding (ROADMAP.md §3).
"""

from __future__ import annotations

import numpy as np

HW, P = 160, 16


def problem(n: int = 128, seed: int = 0, nmodes: int = 1, hw: int = HW, p: int = P):
    """``(psi, probe, scan, data)``: the true object (1, hw, hw), the probe
    (1, 1, nmodes, p, p), the (n, 2) positions and the (n, p, p) float32
    intensities."""
    import tike_tpu_torch.ptycho as tp

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw] / hw
    psi = (
        np.exp(1j * 0.5 * np.sin(5 * yy) * np.cos(3 * xx)) * (0.9 + 0.1 * np.cos(7 * xx))
    ).astype(np.complex64)[None]
    g = tp.gaussian(p)
    probe = (g * np.exp(1j * 0.2 * g))[None, None, None].astype(np.complex64)
    if nmodes > 1:
        probe = np.asarray(tp.add_modes_cartesian_hermite(probe, nmodes)).astype(np.complex64)
    scan = np.stack(
        [rng.uniform(2, hw - p - 3, n), rng.uniform(2, hw - p - 3, n)], -1
    ).astype(np.float32)
    data = tp.simulate(p, probe, scan, psi, device="cpu").astype(np.float32)
    return psi, probe, scan, data


def start(psi: np.ndarray, seed: int = 1) -> np.ndarray:
    """The starting object: 0.5 perturbed by 0.05 of a seeded normal."""
    gen = np.random.default_rng(seed)
    return (0.5 + 0.05 * gen.standard_normal(psi.shape)).astype(np.complex64)


def parameters(pkg, probe, psi0, scan, solver="lstsq", *, algo=None, probe_options=True,
               **fields):
    """Parameters of package ``pkg`` (tike_tpu.ptycho or
    tike_tpu_torch.ptycho): ``solver`` with 2 compact batches and 3
    epochs unless ``algo`` says otherwise, object recovery, probe recovery
    without the initial rescale (``probe_options`` a dict of more keywords,
    or None for a fixed probe), and ``fields`` (eigen probes, position or
    exit-wave options)."""
    options = pkg.RpieOptions if solver == "rpie" else pkg.LstsqOptions
    popts = None
    if probe_options is not None:
        extra = probe_options if isinstance(probe_options, dict) else {}
        popts = pkg.ProbeOptions(**{"init_rescale_from_measurements": False, **extra})
    return pkg.PtychoParameters(
        probe=probe.copy(),
        psi=psi0.copy(),
        scan=scan.copy(),
        algorithm_options=options(
            **{"num_batch": 2, "num_iter": 3, "batch_method": "compact", **(algo or {})}
        ),
        object_options=pkg.ObjectOptions(),
        probe_options=popts,
        **fields,
    )


def interior_correlation(a, b, edge: int = 24) -> float:
    """|<a, b>| / (|a| |b|) over the well-lit interior (``edge`` rows and
    columns in from each side), as ``tests/parallel/test_striped.py``
    compares a striped result with the replicated one."""
    inner = (slice(None), slice(edge, -edge), slice(edge, -edge))
    a, b = np.asarray(a)[inner], np.asarray(b)[inner]
    return float(np.abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def run_both(data, jparams, stripes: int, epochs: int = 3, **kwargs):
    """``epochs`` striped epochs from ``jparams`` (tike_tpu's parameters) in
    tike_tpu on ``make_mesh(stripes)`` and, through ``convert``, in the
    port on as many CPU shards, both from seed 0; returns ``(got, want)``
    from ``convert.parameters_to_numpy``. Each context's exit copies the
    parameters to the host, which checks the positions."""
    import tike_tpu.parallel as jpar
    import tike_tpu.ptycho as jp

    import tike_tpu_torch.parallel as tpar
    import tike_tpu_torch.ptycho as tp
    from tike_tpu_torch import convert

    tparams = convert.parameters_from_jax(jparams)
    out = []
    for pkg, params, mesh, kw in (
        (jp, jparams, jpar.make_mesh(stripes), {}),
        (tp, tparams, tpar.make_mesh(devices=["cpu"] * stripes), dict(device="cpu")),
    ):
        with pkg.Reconstruction(
            data, params, mesh=mesh, object_sharding="striped", random_seed=0, **kwargs, **kw
        ) as context:
            context.iterate(epochs)
            out.append(convert.parameters_to_numpy(context.get_result()))
    return out[1], out[0]


def check(got, want, keys=("psi", "probe", "eigen_probe", "eigen_weights"), scan_px=1e-4):
    """Finite costs, costs and ``keys`` at ``_torch_parity.SLICE_TOL`` of
    the largest value, positions within ``scan_px`` pixels."""
    from . import _torch_parity as H

    assert np.all(np.isfinite(got["costs"]))
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=H.SLICE_TOL)
    for key in keys:
        if want[key] is None:
            assert got[key] is None, key
            continue
        H.assert_close(got[key], want[key], rtol=H.SLICE_TOL, atol=H.SLICE_TOL, scale=True)
    H.assert_close(got["scan"], want["scan"], rtol=0, atol=scan_px)
