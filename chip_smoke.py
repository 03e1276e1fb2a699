#!/usr/bin/env python3
"""Drive the PyTorch port (tike_tpu_torch) once on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (``nvcc``), and imports nothing
of JAX. Phases, in order; any failure raises and the script exits non-zero
without printing the final ``ok`` line:

1. environment: torch, CUDA, card, power limit and nvcc versions;
2. build: compile ``tike_tpu_torch/csrc/patch.cu`` for sm_90a;
3. kernel parity at the main path's shapes (1500^2 complex object, 1,000
   positions, P=128, some windows past the bottom/right edges): each CUDA
   kernel against its plain PyTorch version, with times from CUDA events;
4. forward model: the port's ``simulate`` on the card against a numpy
   forward model (the math of ``bench.py``'s ``_simulate_numpy``) on 256
   positions, with one probe mode, 3 modes, and 3 modes with an eigen
   probe and per-position weights;
5. small slices: 3-epoch LSQML reconstructions on the card against the
   port's plain-PyTorch path on the CPU, on the same seeded input: one
   probe mode, then config 2's features (3 modes, eigen probe and weights,
   position correction);
6. main path: 10,000 simulated 128^2 patterns of a 1500^2 object, LSQML
   with compact batching (num_batch=10), ``iterate(1)`` then a timed
   ``iterate(3)``; costs must be finite and decreasing, and both patch
   kernels must have been launched by it;
7. config 2 (``bench_all.py``'s ``lsqml_opr_pos``, BASELINE.md config 2):
   the same scan and object with 3 probe modes, one eigen probe with
   per-position weights and position correction, data simulated on the
   card; ``iterate(1)`` then a timed ``iterate(3)``; costs finite and
   decreasing, both patch kernels launched, eigen probe and weights
   finite and moved, positions moved inside the allowed window and by at
   most twice the update limit per epoch;
8. rPIE at full width (BASELINE.md config 1's solver): the same scan and
   object with 3 probe modes, ``RpieOptions(num_batch=5)`` (wobbly-center
   batches, alpha 0.05), object AdaM and magnitude clipping, probe
   orthogonalization, centering and AdaM; ``iterate(1)`` then a timed
   ``iterate(3)``; costs finite and decreasing, both patch kernels
   launched, the mode powers in descending order after each
   orthogonalization, and ``|psi| <= 1``;
9. rPIE on the measured siemens-star data (``bench_all.py``'s
   ``rpie_siemens``: 516 patterns of 128^2, ``num_batch=5``, compact),
   3 epochs on the card against the port's CPU path, costs finite and
   decreasing.

Phase 5 also runs two more small slices card against CPU (5c): rPIE with
wobbly-center batches, 3 modes, an eigen probe and weights, every probe
constraint, the object smoothness and positivity constraints, object and
probe AdaM and ``constant_probe_photons``; and one-mode LSQML with Poisson
noise and wobbly-center batches.

The line before the last lists each kernel (its launches in phase 6 as
``launches``, in phase 7 as ``launches_config2`` and in phase 8 as
``launches_rpie``, its error against the plain version and both times);
the last line is ``{"ok": true, "device": {...}}``.
"""

import bz2
import importlib.metadata
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import tike_tpu_torch.ptycho as tp
from tike_tpu_torch import kernels
from tike_tpu_torch.ops import patch

# The main path's configuration (bench.py: 10,000 x 128^2 from a 1500^2
# object, LSQML, num_batch=10, compact batches).
N_PATTERNS, DET, PROBE, HW, NUM_BATCH = 10_000, 128, 128, 1500, 10
BATCH = N_PATTERNS // NUM_BATCH

# patch_fwd: a float32 4-term blend in both versions (the kernel uses FMA).
FWD_TOL = 1e-5
# patch_adj: float32 atomics add overlapping windows in an order that varies
# from run to run; error relative to the largest |value| of the image.
ADJ_TOL = 1e-5
# simulate vs numpy: float32 FFTs from two libraries; near-zero far-field
# pixels get an absolute floor relative to the largest intensity.
SIM_RTOL, SIM_ATOL = 1e-4, 1e-6
# Small slice, card vs CPU: atomics reorder the adjoint's sums, and 3
# epochs of LSQML carry that rounding forward.
SLICE_TOL = 1e-4
# The same for positions, in pixels: the position step divides the summed
# gradient terms by their own magnitudes, which carries their rounding.
SLICE_SCAN_TOL = 1e-3
# Config 2 (bench_all.py:134-176): 3 probe modes, one eigen probe,
# position correction with this per-epoch update limit (pixels).
MODES, POS_LIMIT = 3, 2.0
# rPIE at full width: RpieOptions' own default number of batches, and the
# photon count of the probe's modes together. Non-compact rPIE with object
# AdaM adds a scale-free step divided by the illumination (ROADMAP.md
# section 3), so the unit-scale model of phases 6 and 7 (under one photon
# per detector pixel) blows the object up; the probe is scaled to counts
# like measured data's instead.
RPIE_NUM_BATCH, RPIE_PHOTONS = 5, 1e7
# The rPIE slice's data and probe are this much brighter than the model's
# (intensity x BRIGHT^2): non-compact rPIE with object AdaM adds a
# scale-free step divided by the illumination, and at the model's own
# brightness the object blows up (ROADMAP.md section 3).
BRIGHT = 100.0
# bench_all.py's measured siemens-star data (516 patterns of 128^2).
SIEMENS = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "tests", "data", "siemens-star-small.npz.bz2",
)

KERNELS = {
    "patch_fwd": "tike_tpu/ops/patch_pallas.py:110",  # also :181
    "patch_adj": "tike_tpu/ops/patch_pallas.py:283",
}


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _installed_version(package: str) -> str:
    try:
        return importlib.metadata.version(package)
    except importlib.metadata.PackageNotFoundError:
        return "not installed"


def phase_environment() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nvcc = kernels.find_nvcc()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[-1]
    env = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": nvidia_smi_line(),
        "nvcc": nvcc_version,
        "triton": _installed_version("triton"),
    }
    log(f"[env] python {sys.version.split()[0]} torch {env['torch']} "
        f"cuda {env['cuda']}")
    log(f"[env] device {env['device']} (count {env['count']})")
    log(f"[env] nvidia-smi: {env['nvidia_smi']}")
    log(f"[env] nvcc: {nvcc_version}; triton: {env['triton']}")
    return env


def phase_build() -> None:
    kernels.load("patch")
    info = kernels.BUILD_INFO["patch"]
    log(f"[build] csrc/patch.cu -> {info['path']} in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")


def _ms_per_call(fn, reps: int) -> float:
    """Device ms per call over ``reps`` back-to-back calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def median_ms_in_turns(kernel, plain, reps: int = 20, rounds: int = 3):
    """Median ms per call of each, in turns: plain, kernel, kernel, plain."""
    kernel()
    plain()
    torch.cuda.synchronize()
    t_kernel, t_plain = [], []
    for _ in range(rounds):
        t_plain.append(_ms_per_call(plain, reps))
        t_kernel.append(_ms_per_call(kernel, reps))
        t_kernel.append(_ms_per_call(kernel, reps))
        t_plain.append(_ms_per_call(plain, reps))
    return statistics.median(t_kernel), statistics.median(t_plain)


def _max_abs(a, b) -> float:
    return float(torch.max(torch.abs(a - b)))


def phase_kernel_parity(device) -> dict:
    gen = np.random.default_rng(0)
    image = torch.tensor(
        (gen.standard_normal((HW, HW)) + 1j * gen.standard_normal((HW, HW))).astype(
            np.complex64
        ),
        device=device,
    )
    pos = np.stack(
        [gen.uniform(1, HW - PROBE - 2, BATCH), gen.uniform(1, HW - PROBE - 2, BATCH)],
        -1,
    )
    # Windows past the bottom and right edges (those pixels read 0).
    pos[:10, 0] = gen.uniform(HW - PROBE - 1, HW - 1, 10)
    pos[10:20, 1] = gen.uniform(HW - PROBE - 1, HW - 1, 10)
    pos[20:25] = gen.uniform(HW - PROBE - 1, HW - 1, (5, 2))
    positions = torch.tensor(pos.astype(np.float32), device=device)
    patches = torch.tensor(
        (
            gen.standard_normal((BATCH, PROBE, PROBE))
            + 1j * gen.standard_normal((BATCH, PROBE, PROBE))
        ).astype(np.complex64),
        device=device,
    )
    out = {}

    # complex64 on the main path; float32 is the kernels' other
    # instantiation (the gather psi preconditioner spreads |probe|^2).
    err = 0.0
    for img in (image, image.real.contiguous()):
        got = patch.patch_fwd_cuda(img, positions, PROBE)
        torch.cuda.synchronize()
        want = patch.patch_fwd_plain(img, positions, PROBE)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=FWD_TOL, atol=FWD_TOL)
        err = max(err, _max_abs(got, want))
    ms, plain_ms = median_ms_in_turns(
        lambda: patch.patch_fwd_cuda(image, positions, PROBE),
        lambda: patch.patch_fwd_plain(image, positions, PROBE),
    )
    out["patch_fwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    log(f"[parity] patch_fwd {BATCH}x{PROBE}^2 from {HW}^2: max|err| {err:.3e} "
        f"(tol {FWD_TOL:g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    errs = []
    real = torch.square(torch.abs(patches))
    for name, pat, init in (
        ("complex64", patches, None),
        ("complex64 + initial image", patches, image),
        ("float32", real, None),
    ):
        got = patch.patch_adj_cuda(pat, positions, (HW, HW), init)
        torch.cuda.synchronize()
        want = patch.patch_adj_plain(pat, positions, (HW, HW), init)
        torch.cuda.synchronize()
        err = _max_abs(got, want)
        scale = float(torch.max(torch.abs(want)))
        if not err <= ADJ_TOL * scale:
            raise AssertionError(
                f"patch_adj ({name}) differs from its plain version by "
                f"{err:.3e} > {ADJ_TOL:g} x {scale:.3e}"
            )
        errs.append(err)
        log(f"[parity] patch_adj ({name}): max|err| {err:.3e} <= "
            f"{ADJ_TOL:g} x max|value| {scale:.3e}")
    ms, plain_ms = median_ms_in_turns(
        lambda: patch.patch_adj_cuda(patches, positions, (HW, HW)),
        lambda: patch.patch_adj_plain(patches, positions, (HW, HW)),
    )
    out["patch_adj"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)
    log(f"[parity] patch_adj {BATCH}x{PROBE}^2 into {HW}^2: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    return out


def make_inputs(n_patterns, probe_shape=PROBE, hw=HW):
    """bench.py's _make_inputs recipe (seed 0): scan, object, probe."""
    rng = np.random.default_rng(0)
    scan = np.stack(
        [
            rng.uniform(2, hw - probe_shape - 3, n_patterns),
            rng.uniform(2, hw - probe_shape - 3, n_patterns),
        ],
        -1,
    ).astype(np.float32)
    yy, xx = np.mgrid[0:hw, 0:hw] / hw
    psi = (
        np.exp(1j * 0.5 * np.sin(17 * yy) * np.cos(13 * xx))
        * (0.9 + 0.1 * np.cos(23 * xx * yy))
    ).astype(np.complex64)[None]
    win = tp.gaussian(probe_shape)
    probe = (win * np.exp(1j * 0.2 * win))[None, None, None].astype(np.complex64)
    return scan, psi, probe


def simulate_numpy(det, probe, scan, psi, eigen_probe=None, eigen_weights=None):
    """Numpy forward model: bilinear patch, probe product, zero-pad, ortho
    FFT, intensity summed over probe modes (bench.py's _simulate_numpy).

    With eigen weights, the probe at position k is ``w[k, 0] * probe +
    sum_e w[k, 1 + e] * eigen_probe[e]``, mode by mode."""
    p = probe.shape[-1]
    probe2d = probe[0, 0][None]  # (1, M, P, P)
    if eigen_weights is not None:
        w = eigen_weights[:, :, :, None, None]
        probe2d = w[:, 0] * probe[0, 0]
        if eigen_probe is not None:
            m = eigen_probe.shape[-3]
            probe2d[:, :m] += np.sum(w[:, 1:, :m] * eigen_probe[0][None, :, :m], axis=1)
    corner = np.floor(scan).astype(np.int64)
    frac = scan - corner
    pats = np.empty((len(scan), p, p), np.complex64)
    for k, (c, f) in enumerate(zip(corner, frac)):
        win = psi[0, c[0] : c[0] + p + 1, c[1] : c[1] + p + 1]
        fy, fx = f
        pats[k] = (
            (1 - fy) * (1 - fx) * win[:-1, :-1]
            + (1 - fy) * fx * win[:-1, 1:]
            + fy * (1 - fx) * win[1:, :-1]
            + fy * fx * win[1:, 1:]
        )
    near = pats[:, None] * probe2d
    pad = (det - p) // 2
    if pad or det != p:
        near = np.pad(near, ((0, 0), (0, 0), (pad, det - p - pad), (pad, det - p - pad)))
    far = np.fft.fft2(near, norm="ortho")
    return np.sum(np.abs(far) ** 2, axis=1).astype(np.float32)


def phase_forward_model(device, scan, psi, probe, n=256) -> None:
    probe3 = tp.add_modes_cartesian_hermite(probe, MODES)
    eigen_probe, weights = config2_eigen(probe3, n)
    # Weights that differ per position, so the blend is exercised.
    weights[:, 1] = np.linspace(-50, 50, n, dtype=np.float32)[:, None]
    for name, probe_k, eig, w in (
        ("1 mode", probe, None, None),
        (f"{MODES} modes", probe3, None, None),
        (f"{MODES} modes + eigen probe", probe3, eigen_probe, weights),
    ):
        got = tp.simulate(
            DET, probe_k, scan[:n], psi, eigen_probe=eig, eigen_weights=w,
            device=device,
        )
        torch.cuda.synchronize()
        want = simulate_numpy(DET, probe_k, scan[:n], psi, eig, w)
        atol = SIM_ATOL * float(np.max(want))
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=SIM_RTOL, atol=atol)
        err = float(np.max(np.abs(got.cpu().numpy() - want)))
        log(f"[forward] simulate {name}, {n}x{DET}^2 on {device} vs numpy: "
            f"max|err| {err:.3e} (rtol {SIM_RTOL:g}, atol {atol:.3e})")


def _small_slice_parameters(scan, probe, psi0, det, config2=False):
    extra = {}
    if config2:
        probe = tp.add_modes_cartesian_hermite(probe, MODES)
        extra = config2_extra(scan, probe)
    return tp.PtychoParameters(
        probe=probe,
        psi=psi0,
        scan=scan,
        algorithm_options=tp.LstsqOptions(
            num_batch=3, batch_method="compact", rescale_period=2
        ),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
        exitwave_options=tp.ExitWaveOptions(
            measured_pixels=np.ones((det, det), bool)
        ),
        **extra,
    )


def _slice_inputs(gen, probe_fn, h=160, p=16, n=120):
    """The small slices' scan, true object, starting probe (``probe_fn(gen,
    p)``) and perturbed starting object, drawn from ``gen`` in that
    order."""
    scan = gen.uniform(2, h - p - 3, (n, 2)).astype(np.float32)
    _, psi, _ = make_inputs(1, probe_shape=p, hw=h)
    probe = probe_fn(gen, p)
    psi0 = (
        0.5
        + 0.05 * (gen.standard_normal(psi.shape) + 1j * gen.standard_normal(psi.shape))
    ).astype(np.complex64)
    return scan, psi, probe, psi0


def _random_phase_probe(gen, p):
    """The soft-edged aperture with a random phase, one mode."""
    return (tp.gaussian(p) * np.exp(1j * gen.uniform(-np.pi, np.pi, (p, p))))[
        None, None, None
    ].astype(np.complex64)


def _card_vs_cpu(name, device, data, make_params, keys=("psi", "probe"), phase=False):
    """3 epochs of ``make_params()`` on the card and on the CPU from the
    same data and seed; costs and ``keys`` must agree to SLICE_TOL (probes
    up to one phase per mode with ``phase``). Returns both results."""
    results = {}
    for dev in ("cpu", device):
        with tp.Reconstruction(data, make_params(), device=dev, random_seed=0) as context:
            context.iterate(3)
            results[str(dev)] = context.get_result()
    ref, got = results["cpu"], results[str(device)]
    c_ref = np.asarray(ref.algorithm_options.costs)
    c_got = np.asarray(got.algorithm_options.costs)
    if not (np.all(np.isfinite(c_got)) and c_got[-1, 0] < c_got[0, 0]):
        raise AssertionError(f"{name}: costs not finite and decreasing: {c_got.ravel()}")
    np.testing.assert_allclose(c_got, c_ref, rtol=SLICE_TOL)
    errs = {}
    for key in keys:
        a, b = getattr(got, key), getattr(ref, key)
        if phase and key == "probe":
            inner = np.sum(np.conj(a) * b, axis=(-2, -1), keepdims=True)
            a = a * np.exp(1j * np.angle(inner))
        np.testing.assert_allclose(a, b, rtol=SLICE_TOL, atol=SLICE_TOL * np.abs(b).max())
        errs[key] = float(np.max(np.abs(a - b)) / np.abs(b).max())
    log(f"[slice] {name}: 3 epochs on {device} vs cpu: costs {c_got.ravel().tolist()} "
        f"vs {c_ref.ravel().tolist()} (rtol {SLICE_TOL:g}); max|err| / max|value| "
        f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (tol {SLICE_TOL:g})")
    return got, ref


def phase_small_slice(device, config2=False) -> None:
    """3 LSQML epochs at 160^2 / P=16 / 24^2 detector, card vs CPU; with
    ``config2`` the probe has 3 modes, an eigen probe and weights, and the
    positions are corrected."""
    scan, psi, probe, psi0 = _slice_inputs(np.random.default_rng(1), _random_phase_probe)
    det = 24
    data = tp.simulate(det, probe, scan, psi, device="cpu").numpy()
    name = "config-2 slice (3 modes, eigen probe, positions)" if config2 else "slice"
    keys = ("psi", "probe") + (("eigen_probe", "eigen_weights") if config2 else ())
    got, ref = _card_vs_cpu(
        name, device, data,
        lambda: _small_slice_parameters(scan, probe, psi0, det, config2), keys,
    )
    scan_err = float(np.max(np.abs(got.scan - ref.scan)))
    np.testing.assert_allclose(got.scan, ref.scan, rtol=0, atol=SLICE_SCAN_TOL)
    if config2 and not np.max(np.abs(got.scan - scan)) > 0.1:
        raise AssertionError("config-2 slice: the positions did not move")
    log(f"[slice] {name}: scan max|err| {scan_err:.3e} px (tol {SLICE_SCAN_TOL:g})")


def _distinct_modes_probe(gen, p):
    """3 Hermite modes of a random-phase blob, at distinct powers, centered
    off the half-integers: equal powers make the orthogonalization's
    eigenvectors ill-conditioned, and a half-integer center is a rounding
    tie for the centering constraint."""
    r, c = np.mgrid[:p, :p] + 0.5
    amp = np.exp(-((r - 0.52 * p) ** 2 + (c - 0.46 * p) ** 2) / (0.3 * p) ** 2)
    base = (amp * np.exp(1j * gen.uniform(-np.pi, np.pi, (p, p))))[None, None, None]
    modes = tp.add_modes_cartesian_hermite(base.astype(np.complex64), MODES)
    return (modes * np.linspace(1.0, 0.4, MODES)[:, None, None]).astype(np.complex64)


def phase_rpie_slices(device) -> None:
    """5c: the rPIE slice with every constraint and moment of this path,
    then one-mode LSQML with Poisson noise, card vs CPU."""
    gen = np.random.default_rng(2)
    scan, psi, probe, psi0 = _slice_inputs(gen, _distinct_modes_probe)
    det = 24
    ones = np.ones((det, det), bool)
    probe = (BRIGHT * probe).astype(np.complex64)
    data = tp.simulate(det, probe, scan, psi, device="cpu").numpy()
    eigen_probe, weights = config2_eigen(probe, len(scan))

    def rpie_params():
        return tp.PtychoParameters(
            probe=probe,
            psi=psi0,
            scan=scan,
            eigen_probe=eigen_probe,
            eigen_weights=weights,
            algorithm_options=tp.RpieOptions(
                num_batch=3, rescale_method="constant_probe_photons", rescale_period=2
            ),
            object_options=tp.ObjectOptions(
                smoothness_constraint=0.01,
                positivity_constraint=0.05,
                use_adaptive_moment=True,
            ),
            probe_options=tp.ProbeOptions(
                force_orthogonality=True,
                force_centered_intensity=True,
                probe_support=0.05,
                median_filter_abs_probe=True,
                median_filter_abs_probe_px=(3.0, 3.0),
                force_sparsity=0.05,
                use_adaptive_moment=True,
            ),
            exitwave_options=tp.ExitWaveOptions(measured_pixels=ones),
        )

    _card_vs_cpu(
        "rPIE slice (wobbly center, 3 modes, eigen probe, every probe "
        "constraint, object constraints, AdaM, constant_probe_photons)",
        device, data, rpie_params,
        ("psi", "probe", "eigen_probe", "eigen_weights"), phase=True,
    )
    probe1 = _random_phase_probe(gen, 16)
    data1 = tp.simulate(det, probe1, scan, psi, device="cpu").numpy()
    _card_vs_cpu(
        "LSQML slice (1 mode, Poisson, wobbly center)",
        device, data1,
        lambda: tp.PtychoParameters(
            probe=probe1,
            psi=psi0,
            scan=scan,
            algorithm_options=tp.LstsqOptions(num_batch=3, rescale_period=2),
            object_options=tp.ObjectOptions(),
            probe_options=tp.ProbeOptions(),
            exitwave_options=tp.ExitWaveOptions(measured_pixels=ones, noise_model="poisson"),
        ),
    )


def config2_eigen(probe, n_positions):
    """bench_all.py's config-2 eigen state: one eigen probe, 0.01 of the
    shared modes, and weights of 1 on the shared component and 0 on it."""
    eigen_probe = (0.01 * probe[:, :1]).astype(np.complex64)
    weights = np.zeros((n_positions, 2, probe.shape[-3]), np.float32)
    weights[:, 0, :] = 1.0
    return eigen_probe, weights


def config2_extra(scan, probe) -> dict:
    """The PtychoParameters fields config 2 adds to the main path."""
    eigen_probe, weights = config2_eigen(probe, len(scan))
    return dict(
        eigen_probe=eigen_probe,
        eigen_weights=weights,
        position_options=tp.PositionOptions(
            initial_scan=scan, update_magnitude_limit=POS_LIMIT
        ),
    )


def path_parameters(scan, psi, probe, config2=False):
    """The main path's parameters (bench.py), or config 2's
    (bench_all.py:134-176) for a probe that already has its 3 modes."""
    return tp.PtychoParameters(
        probe=probe,
        psi=np.full_like(psi, 0.5),
        scan=scan,
        algorithm_options=tp.LstsqOptions(
            num_batch=NUM_BATCH, num_iter=1, batch_method="compact"
        ),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
        **(config2_extra(scan, probe) if config2 else {}),
    )


def _drive(tag, device, probe, scan, psi, card, params) -> dict:
    """Simulate the data on the card, then enter a Reconstruction of
    ``params`` and run ``iterate(1)`` and a timed ``iterate(3)``, with the
    kernel counts set to 0 just before and read just after. Checks what
    every path shares."""
    start = time.perf_counter()
    data = tp.simulate(DET, probe, scan, psi, device=device)
    torch.cuda.synchronize()
    log(f"[{tag}] simulated {tuple(data.shape)} {data.dtype} on {device} with "
        f"{probe.shape[-3]} probe mode(s) in {time.perf_counter() - start:.2f} s")
    if not bool(torch.isfinite(data).all()):
        raise AssertionError("simulated data is not finite")

    for name in patch.LAUNCHES:
        patch.LAUNCHES[name] = 0
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    context = tp.Reconstruction(data, params, device=device, random_seed=0)
    context.__enter__()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start
    log(f"[{tag}] Reconstruction entered in {setup_s:.2f} s "
        f"({params.algorithm_options.batch_method} batches "
        f"{context.batches[0].shape}, fft_precond "
        f"{bool(context._make_plan().fft_precond)}) ({card})")
    before = dict(patch.LAUNCHES)
    start = time.perf_counter()
    context.iterate(1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - start
    scan1 = context.get_scan()
    start = time.perf_counter()
    context.iterate(3)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - start
    launches = dict(patch.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    costs = [c[0] for c in context.get_convergence()[0]]
    result = context.get_result()
    context.__exit__(None, None, None)
    log(f"[{tag}] per-epoch costs {costs}")
    if len(costs) != 4 or not np.all(np.isfinite(costs)):
        raise AssertionError(f"costs are not 4 finite values: {costs}")
    if not costs[-1] < costs[0]:
        raise AssertionError(f"cost did not decrease: {costs}")
    for name in patch.LAUNCHES:
        if not launches[name] > before[name]:
            raise AssertionError(f"iterate launched no {name} kernel: {launches}")
    if result.psi.shape != psi.shape or not np.all(np.isfinite(result.psi)):
        raise AssertionError("reconstructed psi is not finite or has the wrong shape")
    if result.probe.shape != probe.shape or not np.all(np.isfinite(result.probe)):
        raise AssertionError("reconstructed probe is not finite or has the wrong shape")
    per_epoch = timed_s / 3
    log(f"[{tag}] iterate(1) {first_s:.3f} s; iterate(3) {timed_s:.3f} s = "
        f"{per_epoch:.4f} s/epoch, {len(scan) / per_epoch:.1f} patterns/s "
        f"({card})")
    log(f"[{tag}] set-up {setup_s:.2f} s; peak device memory {peak} bytes "
        f"({peak / 2**30:.3f} GiB) ({card})")
    log(f"[{tag}] kernel launches {launches} (iterate alone: "
        f"{ {k: launches[k] - before[k] for k in launches} })")
    return dict(launches=launches, result=result, scan1=scan1)


def phase_main_path(device, scan, psi, probe, card: str) -> dict:
    params = path_parameters(scan, psi, probe)
    return _drive("main", device, probe, scan, psi, card, params)["launches"]


def phase_config2(device, scan, psi, probe, card: str) -> dict:
    """Config 2 at full width: 3 modes, one eigen probe, positions."""
    probe3 = tp.add_modes_cartesian_hermite(probe, MODES)
    params = path_parameters(scan, psi, probe3, config2=True)
    out = _drive("config2", device, probe3, scan, psi, card, params)
    result = out["result"]
    eigen_probe, weights = config2_eigen(probe3, len(scan))
    for key, start in (("eigen_probe", eigen_probe), ("eigen_weights", weights)):
        value = getattr(result, key)
        if value.shape != start.shape or not np.all(np.isfinite(value)):
            raise AssertionError(f"{key} is not finite or has the wrong shape")
        moved = float(np.max(np.abs(value - start)))
        if not moved > 0:
            raise AssertionError(f"{key} did not move from its start")
        log(f"[config2] {key} {value.shape}: finite, max|change| {moved:.3e}")
    # The host-side affine fit that ends every iterate call with position
    # correction, timed alone: it is inside each iterate's wall time.
    start = time.perf_counter()
    tp.affine_position_regularization(
        result.scan, result.position_options, rng=np.random.default_rng(0)
    )
    log(f"[config2] host affine position fit at {len(scan)} positions: "
        f"{time.perf_counter() - start:.4f} s")
    tp.check_allowed_positions(result.scan, psi, probe3.shape)
    # Each epoch's step is clipped to the limit, then the trimmed mean
    # (itself within the limit) is subtracted.
    for before, after, epochs in ((scan, out["scan1"], 1), (out["scan1"], result.scan, 3)):
        step = float(np.max(np.abs(after - before)))
        if not 0 < step <= 2 * POS_LIMIT * epochs:
            raise AssertionError(
                f"positions moved by {step} px in {epochs} epoch(s); expected "
                f"(0, {2 * POS_LIMIT * epochs}]"
            )
        log(f"[config2] positions moved up to {step:.4f} px in {epochs} epoch(s) "
            f"(bound {2 * POS_LIMIT * epochs:g}); all inside the allowed window")
    return out["launches"]


def rpie_probe(probe):
    """Phase 8's probe: 3 Hermite modes of ``probe`` holding RPIE_PHOTONS
    photons together."""
    probe3 = tp.add_modes_cartesian_hermite(probe, MODES)
    return (probe3 * np.sqrt(RPIE_PHOTONS / np.sum(np.abs(probe3) ** 2))).astype(
        np.complex64
    )


def rpie_parameters(scan, psi, probe):
    """Phase 8's parameters: rPIE with its defaults (wobbly-center batches,
    alpha 0.05) and the constraints and moments users add to it."""
    return tp.PtychoParameters(
        probe=probe,
        psi=np.full_like(psi, 0.5),
        scan=scan,
        algorithm_options=tp.RpieOptions(num_batch=RPIE_NUM_BATCH),
        object_options=tp.ObjectOptions(use_adaptive_moment=True, clip_magnitude=True),
        probe_options=tp.ProbeOptions(
            force_orthogonality=True,
            force_centered_intensity=True,
            use_adaptive_moment=True,
        ),
    )


def phase_rpie(device, scan, psi, probe, card: str) -> dict:
    """rPIE at full width: 3 modes holding RPIE_PHOTONS photons,
    wobbly-center batches, orthogonal and centered probe modes, AdaM,
    magnitude clipping."""
    probe3 = rpie_probe(probe)
    out = _drive("rpie", device, probe3, scan, psi, card, rpie_parameters(scan, psi, probe3))
    result = out["result"]
    powers = np.asarray(result.probe_options.power)
    log(f"[rpie] probe mode powers after each epoch's orthogonalization "
        f"{powers.tolist()}")
    if not np.all(np.diff(powers, axis=-1) <= 0):
        raise AssertionError(f"mode powers not in descending order: {powers}")
    final = np.sum(np.abs(result.probe) ** 2, axis=(-2, -1)).ravel()
    log(f"[rpie] final probe mode powers {final.tolist()}")
    top = float(np.max(np.abs(result.psi)))
    if not top <= 1.0 + 1e-6:
        raise AssertionError(f"max |psi| {top} > 1 with clip_magnitude")
    log(f"[rpie] max |psi| {top:.7f} <= 1 (clip_magnitude)")
    return out["launches"]


def siemens():
    """bench_all.py's _siemens(): the measured data, scan and probe, and a
    constant object covering the scan with a 20-pixel margin."""
    with bz2.open(SIEMENS, "rb") as f:
        a = np.load(f)
        scan = a["scan"][0].astype(np.float32)
        data = a["data"][0].astype(np.float32)
        probe = a["probe"][0].astype(np.complex64)
    scan = scan - np.amin(scan, axis=-2) + 20
    w = probe.shape[-1]
    h = int(np.ceil(scan[:, 0].max())) + w + 21
    ww = int(np.ceil(scan[:, 1].max())) + w + 21
    return data, scan, probe, np.full((1, h, ww), 0.5 + 0j, dtype=np.complex64)


def phase_siemens(device, card: str) -> None:
    """bench_all.py's rpie_siemens on the card against the CPU path."""
    data, scan, probe, psi = siemens()

    def params():
        return tp.PtychoParameters(
            probe=probe,
            psi=psi,
            scan=scan,
            algorithm_options=tp.RpieOptions(num_batch=5, batch_method="compact"),
            object_options=tp.ObjectOptions(),
            probe_options=tp.ProbeOptions(),
        )

    got, _ = _card_vs_cpu(
        f"rpie_siemens ({data.shape[0]} measured {data.shape[-1]}^2 patterns)",
        device, data, params,
    )
    epoch_s = float(np.mean(got.algorithm_options.times))
    log(f"[siemens] {epoch_s:.4f} s/epoch on the card (mean of 3, first epoch "
        f"included), {data.shape[0] / epoch_s:.1f} patterns/s ({card})")


def main() -> None:
    env = phase_environment()
    device = torch.device("cuda", 0)
    phase_build()
    timings = phase_kernel_parity(device)
    scan, psi, probe = make_inputs(N_PATTERNS)
    phase_forward_model(device, scan, psi, probe)
    phase_small_slice(device)
    phase_small_slice(device, config2=True)
    phase_rpie_slices(device)
    launches = phase_main_path(device, scan, psi, probe, env["nvidia_smi"])
    launches2 = phase_config2(device, scan, psi, probe, env["nvidia_smi"])
    launches3 = phase_rpie(device, scan, psi, probe, env["nvidia_smi"])
    phase_siemens(device, env["nvidia_smi"])
    report = [
        {
            "name": name,
            "route": "cuda",
            "source": "tike_tpu_torch/csrc/patch.cu",
            "replaces": KERNELS[name],
            "launches": launches[name],
            "launches_config2": launches2[name],
            "launches_rpie": launches3[name],
            **timings[name],
        }
        for name in KERNELS
    ]
    log(env["nvidia_smi"])
    log(json.dumps({"kernels": report}))
    log(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
