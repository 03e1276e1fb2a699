#!/usr/bin/env python3
"""Drive the PyTorch port (tike_tpu_torch) once on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (``nvcc``), and imports nothing
of JAX. Phases, in order; any failure raises and the script exits non-zero
without printing the final ``ok`` line:

1. environment: torch, CUDA, card, power limit and nvcc versions;
2. build: compile ``tike_tpu_torch/csrc/patch.cu``, ``usfft.cu`` and
   ``probe.cu`` for sm_90a, one nvcc each, all started together;
3. kernel parity at the main path's shapes (1500^2 complex object, 1,000
   positions, P=128, some windows past the bottom/right edges): each CUDA
   kernel against its plain PyTorch version, two launches of each on the
   same inputs bitwise equal, and the edge cases of
   ``tests/_torch_patch_cases.py`` (negative corners, windows wholly
   outside the image, N = 0 and 1, P = 100, an odd P, float32 with an odd
   W, 5,000 windows on one tile), and the positions of one compact batch
   of the main path; times of each kernel, its plain version and one
   PyTorch call that computes the same function (``grid_sample`` and its
   input gradient), from CUDA events, beside the kernel's bound for those
   positions (the bytes they need at the card's HBM rate), and the
   kernel's and the library call's on the compact batch beside its own
   bound;
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

Phase 3 is followed by the KB kernels' parity (3b): ``kb_gather`` and
``kb_scatter`` against their plain versions and against adjointness
(<gather(G), f> = <G, scatter(f)>) on laminography's points at
``bench_all.py``'s 128^3 / 64 angles (upsample 1, m = 1; upsample 2, a
256^3 grid, m = 2), on flat random points of which a third wrap (m = 1, 2,
4 and 7) and on a 256^3 / 128-angle transform (8,388,608 points); two
launches of each kernel on one geometry plan, and a third that builds its
own, bitwise equal on every case; times (the plan's build; a CUDA graph of
the kernel's launches on a plan built beforehand; eager calls with that
plan and building their own) beside each bound and the plain version's,
and at 128^3 / 64 angles the einsum chain of ``tike_tpu``'s
``gather_kb_rows``/``scatter_kb_rows`` as the yardstick.

After phase 9:

10. a laminography slice, card against CPU: ``simulate``, then cgrad and
    CGLS, 3 outer iterations on a 16^3 volume at 8 angles, upsample 2;
11. laminography at full width (``bench_all.py``'s ``lamino_cgrad`` and
    ``lamino_cgls``: a 128^3 volume, 64 angles, tilt pi/3, eps 1e-3,
    upsample 1, ``cg_iter=4``): ``simulate`` on the card against the CPU,
    then for each solver one warm-up outer iteration and 5 timed ones, with
    the kernel counts set to 0 before and read after; costs finite and
    decreasing, both KB kernels launched; s/iteration (and that of two more
    timed runs, for the spread), set-up, peak memory and the line search's
    host reads; then the warm-up once more from the same start, whose cost
    and volume must equal the first one's bit for bit;
12. the seven feature probes (``tike_tpu_torch/toolchain_probe.py``): each
    launched once on ``arange``-valued inputs and equal to its plain
    version bit for bit, then timed beside its bound: in a CUDA graph with
    the index check left out (the kernel's own time) and as an eager call
    with it, and the library call likewise.

The line before the last lists each kernel (its launches in phase 6 as
``launches``, in phase 7 as ``launches_config2`` and in phase 8 as
``launches_rpie``; the KB kernels' in phase 11's cgrad as ``launches`` and
``launches_lamino_cgrad`` and in its CGLS as ``launches_lamino_cgls``; the
probes' in phase 12; its error against the plain version, its time, the
plain version's and the library call's, its bound in bytes and ms and its
share of that bound, the same on the compact batch, whether it is
deterministic); each full-width path also logs each kernel's bound per
launch over its batches. The last line is
``{"ok": true, "device": {...}}``.
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

import tike_tpu_torch.lamino as tl
import tike_tpu_torch.ptycho as tp
from tests import _torch_patch_cases as cases
from tests import _torch_usfft_cases as cases_usfft
from tike_tpu_torch import kernels, opt, toolchain_probe
from tike_tpu_torch.ops import patch, usfft

# The main path's configuration (bench.py: 10,000 x 128^2 from a 1500^2
# object, LSQML, num_batch=10, compact batches).
N_PATTERNS, DET, PROBE, HW, NUM_BATCH = 10_000, 128, 128, 1500, 10
BATCH = N_PATTERNS // NUM_BATCH

# simulate vs numpy: float32 FFTs from two libraries; near-zero far-field
# pixels get an absolute floor relative to the largest intensity.
SIM_RTOL, SIM_ATOL = 1e-4, 1e-6
# Small slice, card vs CPU: the card's kernels, cuFFT and reductions sum in
# other orders than the CPU's plain versions, and 3 epochs of LSQML carry
# that rounding forward.
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
# The KB kernels replace XLA code with no Pallas kernel: the row-structured
# einsum chains laminography runs (also the tap scans gather_kb :214 and
# scatter_kb :244).
USFFT_KERNELS = {
    "usfft_gather_kb": "tike_tpu/ops/usfft.py:330",
    "usfft_scatter_kb": "tike_tpu/ops/usfft.py:364",
}
# The feature probes' pl.pallas_call lines.
PROBE_KERNELS = {
    "trivial": "scripts/pallas_probe.py:45",
    "gridded": "scripts/pallas_probe.py:56",
    "prefetch": "scripts/pallas_probe.py:84",
    "static_dma": "scripts/pallas_probe.py:102",
    "dynamic_dma": "scripts/pallas_probe.py:146",
    "element_static": "scripts/pallas_probe.py:161",
    "element_prefetch": "scripts/pallas_probe.py:199",
}
SOURCES = ("patch", "usfft", "probe")

# Laminography (bench_all.py's lamino_cgrad and lamino_cgls): a 128^3
# volume, 64 angles, tilt pi/3, eps 1e-3, upsample 1, one warm-up outer
# iteration, then 5 timed, cg_iter 4 inner steps each.
LAMINO_CG_ITER, LAMINO_TIMED = 4, 5
# Timed runs of each solver: the first is the counted one, the others show
# the spread of the host's clock.
LAMINO_ROUNDS = 3
# The small laminography slice, card against CPU: n = 16, 8 angles,
# upsample 2, 3 outer iterations; cgrad with one CG step per outer
# iteration, so that no line-search trial is a tie (tests/
# test_torch_lamino_solvers.py), CGLS with 4. The card's kernels sum in
# another order than the plain versions and cuFFT rounds otherwise than
# pocketfft; CGLS carries that forward (relative, costs and volume).
LAMINO_SLICE = dict(n=16, ntheta=8, upsample=2, num_iter=3)
LAMINO_SLICE_CG_ITER = {"cgrad": 1, "cgls": 4}
LAMINO_SLICE_TOL = 1e-4
# simulate at full width, card against CPU, relative to the largest value:
# the same taps (make_grids is the same bits on both), other FFT libraries.
LAMINO_SIM_TOL = 1e-5


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
    """Build every source with one nvcc each, all started together."""
    start = time.perf_counter()
    kernels.build_all(SOURCES)
    log(f"[build] {len(SOURCES)} sources in {time.perf_counter() - start:.2f} s")
    for name in SOURCES:
        kernels.load(name)
        info = kernels.BUILD_INFO[name]
        log(f"[build] csrc/{name}.cu -> {info['path']} in {info['seconds']:.2f} s")
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


def graph_ms_per_call(fn, reps: int = 20, rounds: int = 3) -> float:
    """Device ms per call of ``fn``, captured ``reps`` times into one CUDA
    graph and replayed ``rounds`` times (median): the kernels' own time,
    without the host's launch overhead between eager calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return statistics.median(_ms_per_call(graph.replay, 1) / reps for _ in range(rounds))


def median_ms_in_turns(fns: dict, reps: int = 20, rounds: int = 3) -> dict:
    """Median ms per call of each function of ``fns``, timed in turns: in
    their order, then in the reverse order, ``rounds`` times (plain,
    library, kernel, kernel, library, plain)."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    order = list(fns)
    for _ in range(rounds):
        for name in order + order[::-1]:
            times[name].append(_ms_per_call(fns[name], reps))
    return {name: statistics.median(t) for name, t in times.items()}


def compact_batch_positions(device):
    """1,000 positions as one compact batch of the main path holds them: of
    10,000 drawn as ``make_inputs`` draws them, the 1,000 nearest the scan's
    centre (a disc of a tenth of its area), in ascending index. Their windows
    pile up about ten deep, where uniform ones are seven deep, and touch only
    the disc and a window's width around it."""
    scan, _, _ = make_inputs(N_PATTERNS)
    dist = np.linalg.norm(scan - np.mean(scan, axis=0), axis=1)
    nearest = np.sort(np.argsort(dist)[:BATCH])
    return torch.tensor(scan[nearest], device=device)


def _library_calls(image, patches, positions):
    """One PyTorch call for each kernel that computes the same function on
    these inputs (``grid_sample`` and its input gradient, on a planar copy
    of the image made here), and the calls' outputs checked against the
    kernels' to ``cases.LIBRARY_TOL``: the calls and their errors."""
    planar, grid = cases.grid_sample_inputs(image, positions, PROBE)
    grad = torch.view_as_real(patches).permute(3, 0, 1, 2).reshape(
        1, 2, BATCH * PROBE, PROBE
    ).contiguous()
    calls = {
        "patch_fwd": lambda: torch.nn.functional.grid_sample(
            planar, grid, mode="bilinear", padding_mode="zeros", align_corners=True
        ),
        "patch_adj": lambda: torch.ops.aten.grid_sampler_2d_backward(
            grad, planar, grid, 0, 0, True, [True, False]
        )[0],
    }
    errs = {
        "patch_fwd": cases.check_library(
            "patch_fwd",
            cases.planar_to_complex(calls["patch_fwd"](), (BATCH, PROBE, PROBE)),
            patch.patch_fwd_cuda(image, positions, PROBE),
        ),
        "patch_adj": cases.check_library(
            "patch_adj",
            cases.planar_to_complex(calls["patch_adj"](), (HW, HW)),
            patch.patch_adj_cuda(patches, positions, (HW, HW)),
        ),
    }
    return calls, errs


LIBRARY = {
    "patch_fwd": "torch.nn.functional.grid_sample (bilinear, zeros, align_corners)",
    "patch_adj": "torch.ops.aten.grid_sampler_2d_backward (input gradient)",
}


def phase_kernel_parity(device, card: str) -> dict:
    image, positions, patches = cases.main_path_patch_inputs(device)
    # complex64 on the main path; float32 is the kernels' other
    # instantiation (the gather psi preconditioner spreads |probe|^2).
    errs = cases.check_patch_kernels(image, positions, patches, PROBE, "complex64")
    real = cases.check_patch_kernels(
        image.real.contiguous(), positions, torch.square(torch.abs(patches)),
        PROBE, "float32",
    )
    for name in errs:
        errs[name] = max(errs[name], real[name])
    log(f"[parity] {BATCH}x{PROBE}^2 at {HW}^2, complex64 and float32: "
        f"patch_fwd max|err| {errs['patch_fwd']:.3e} (tol {cases.FWD_TOL:g}), "
        f"patch_adj {errs['patch_adj']:.3e} (tol {cases.ADJ_TOL:g} x max|value|); "
        "two launches of each bitwise equal")
    compact = compact_batch_positions(device)
    errs_compact = cases.check_patch_kernels(image, compact, patches, PROBE, "compact batch")
    log(f"[parity] one compact batch: patch_fwd max|err| "
        f"{errs_compact['patch_fwd']:.3e}, patch_adj {errs_compact['patch_adj']:.3e}; "
        "two launches of each bitwise equal")
    for name in cases.EDGE_CASES:
        edge = cases.check_patch_kernels(*cases.edge_case(name, device), name)
        log(f"[parity] edge case {name}: patch_fwd max|err| "
            f"{edge['patch_fwd']:.3e}, patch_adj {edge['patch_adj']:.3e}; "
            "two launches of each bitwise equal")

    # Each kernel, its plain version and its library call on the uniform
    # positions; then the kernel and the library call on one compact
    # batch's, as the main path's epochs give them. Each bound counts what
    # those positions need (cases.roofline).
    library, lib_err = _library_calls(image, patches, positions)
    library_compact, _ = _library_calls(image, patches, compact)
    calls = {
        "patch_fwd": dict(
            plain=lambda: patch.patch_fwd_plain(image, positions, PROBE),
            library=library["patch_fwd"],
            kernel=lambda: patch.patch_fwd_cuda(image, positions, PROBE),
        ),
        "patch_adj": dict(
            plain=lambda: patch.patch_adj_plain(patches, positions, (HW, HW)),
            library=library["patch_adj"],
            kernel=lambda: patch.patch_adj_cuda(patches, positions, (HW, HW)),
        ),
    }
    compact_calls = {
        "patch_fwd": dict(
            library=library_compact["patch_fwd"],
            kernel=lambda: patch.patch_fwd_cuda(image, compact, PROBE),
        ),
        "patch_adj": dict(
            library=library_compact["patch_adj"],
            kernel=lambda: patch.patch_adj_cuda(patches, compact, (HW, HW)),
        ),
    }
    out = {}
    for name, fns in calls.items():
        ms = median_ms_in_turns(fns)
        ms_compact = median_ms_in_turns(compact_calls[name])
        bound = cases.roofline(name, positions, PROBE, (HW, HW), torch.complex64)
        bound_compact = cases.roofline(name, compact, PROBE, (HW, HW), torch.complex64)
        out[name] = dict(
            max_abs_err=errs[name],
            ms=ms["kernel"],
            plain_ms=ms["plain"],
            library_ms=ms["library"],
            library=LIBRARY[name],
            library_max_abs_err=lib_err[name],
            **bound,
            roofline_share=bound["bound_ms"] / ms["kernel"],
            ms_compact_batch=ms_compact["kernel"],
            bound_bytes_compact_batch=bound_compact["bound_bytes"],
            bound_ms_compact_batch=bound_compact["bound_ms"],
            roofline_share_compact_batch=bound_compact["bound_ms"] / ms_compact["kernel"],
            library_ms_compact_batch=ms_compact["library"],
            deterministic=True,
            card=card,
        )
        log(f"[parity] {name} {BATCH}x{PROBE}^2 / {HW}^2: kernel {ms['kernel']:.4f} "
            f"ms, plain {ms['plain']:.4f} ms, library {ms['library']:.4f} ms "
            f"({LIBRARY[name]}; max|err| vs kernel {lib_err[name]:.3e}); bound "
            f"{bound['bound_ms']:.4f} ms ({bound['bound_bytes']} bytes at "
            f"{cases.HBM_BYTES_PER_S:g} B/s), {100 * out[name]['roofline_share']:.1f}% "
            f"of it ({card})")
        log(f"[parity] {name} on one compact batch: kernel "
            f"{ms_compact['kernel']:.4f} ms, bound {bound_compact['bound_ms']:.4f} ms "
            f"({bound_compact['bound_bytes']} bytes), "
            f"{100 * out[name]['roofline_share_compact_batch']:.1f}% of it; "
            f"library {ms_compact['library']:.4f} ms ({card})")
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
        if not (isinstance(got, np.ndarray) and got.dtype == np.float32):
            raise AssertionError(f"simulate returned {type(got)}, not a float32 numpy array")
        want = simulate_numpy(DET, probe_k, scan[:n], psi, eig, w)
        atol = SIM_ATOL * float(np.max(want))
        np.testing.assert_allclose(got, want, rtol=SIM_RTOL, atol=atol)
        err = float(np.max(np.abs(got - want)))
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
    data = tp.simulate(det, probe, scan, psi, device="cpu")
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
    data = tp.simulate(det, probe, scan, psi, device="cpu")
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
    data1 = tp.simulate(det, probe1, scan, psi, device="cpu")
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
    data = tp.simulate_device(DET, probe, scan, psi, device=device)
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
    # Each kernel's bound per launch on this path: the mean, over the
    # batches at their starting positions, of what a batch's positions
    # need (cases.roofline).
    batch_scan = torch.as_tensor(scan[context.order[context.batches[0]]], device=device)
    bounds = {
        name: statistics.mean(
            cases.roofline(name, b, probe.shape[-1], psi.shape[-2:], torch.complex64)[
                "bound_ms"
            ]
            for b in batch_scan
        )
        for name in patch.LAUNCHES
    }
    log(f"[{tag}] bound per launch, mean over the {len(batch_scan)} batches of "
        f"{batch_scan.shape[1]}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in bounds.items())
        + f" ({card})")
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


def _usfft_cases(device):
    """The KB kernels' parity cases: name -> (grid size, m, beta, points):
    laminography's rows at bench_all.py's 128^3 / 64 angles (upsample 1 and
    2), flat random points of which about a third wrap, at m = 1, 2, 4 and
    7 (the generic path; upsample 2 at eps 1e-12), and the rows of a 256^3
    / 128-angle transform."""
    gen = np.random.default_rng(0)
    rows = cases_usfft.lamino_rows(128, 64, device).reshape(-1, 3)
    flat = cases_usfft.flat_points(gen, 200_000, device)
    eps = cases_usfft.LAMINO_EPS
    return {
        "128^3 / 64 angles, upsample 1": (*cases_usfft.window_for(128, eps, 1), rows),
        "128^3 / 64 angles, upsample 2": (*cases_usfft.window_for(128, eps, 2), rows),
        "flat wrapped points, m = 1": (*cases_usfft.window_for(64, eps, 1), flat),
        "flat wrapped points, m = 2": (*cases_usfft.window_for(32, eps, 2), flat),
        "flat wrapped points, m = 4": (*cases_usfft.window_for(32, 1e-6, 2), flat),
        "flat wrapped points, m = 7": (*cases_usfft.window_for(32, 1e-12, 2), flat),
        "256^3 / 128 angles, upsample 1": (
            *cases_usfft.window_for(256, eps, 1),
            cases_usfft.lamino_rows(256, 128, device).reshape(-1, 3),
        ),
    }


def _timed_plan(x, n, m, beta, tile=None, rounds=3):
    """A KB plan of these points and the median host ms of building it
    (synchronised before and after)."""
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        start = time.perf_counter()
        plan = usfft.kb_plan(x, n, m, beta, tile)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - start))
    return plan, statistics.median(times)


def phase_usfft_parity(device, card: str) -> dict:
    """The KB kernels against their plain versions and adjointness on every
    case of ``_usfft_cases``, every repeated launch bitwise equal; times
    beside the bounds, with the einsum formulation of tike_tpu (cuBLAS,
    TF32 off) as the yardstick at 128^3 / 64 angles."""
    gen = torch.Generator(device=device).manual_seed(0)
    inputs, errs = {}, {}
    for name, (n, m, beta, x) in _usfft_cases(device).items():
        grid = torch.randn((n, n, n), dtype=torch.complex64, device=device, generator=gen)
        f = torch.randn(x.shape[0], dtype=torch.complex64, device=device, generator=gen)
        e = cases_usfft.check_kb_kernels(grid, x, f, n, m, beta, name)
        inputs[name], errs[name] = (grid, x, f, n, m, beta), e
        log(f"[usfft] {name}: grid {n}^3, m = {m}, {x.shape[0]} points: gather "
            f"max|err| {e['usfft_gather_kb_abs']:.3e} ({e['usfft_gather_kb']:.2e} of "
            f"max|value|), scatter {e['usfft_scatter_kb_abs']:.3e} "
            f"({e['usfft_scatter_kb']:.2e}; tol {cases_usfft.KB_TOL:g}); adjointness "
            f"{e['adjoint']:.2e} (tol {cases_usfft.ADJOINT_TOL:g}); three gathers and "
            "three scatters (two on one plan, one building its own) bitwise equal")

    main = "128^3 / 64 angles, upsample 1"
    timed = (main, "128^3 / 64 angles, upsample 2", "256^3 / 128 angles, upsample 1")
    # Each kernel's plan as laminography builds it (the gather's own order
    # at m = 1), with the time of building it.
    plans = {}
    for case in timed:
        _, x, _, n, m, beta = inputs[case]
        plans[case] = {
            "usfft_gather_kb": _timed_plan(x, n, m, beta, usfft.gather_tile(m)),
            "usfft_scatter_kb": _timed_plan(x, n, m, beta),
        }

    grid, x, f, n, m, beta = inputs[main]
    rows = x.reshape(64 * 128, 128, 3)
    f_rows = f.reshape(64 * 128, 128)
    einsum = {
        "usfft_gather_kb": lambda: cases_usfft.gather_rows_einsum(grid, rows, n, m, beta),
        "usfft_scatter_kb": lambda: cases_usfft.scatter_rows_einsum(f_rows, rows, n, m, beta),
    }
    einsum_err = {
        "usfft_gather_kb": cases_usfft.max_rel(
            einsum["usfft_gather_kb"]().reshape(-1), usfft.gather_kb_cuda(grid, x, n, m, beta)
        ),
        "usfft_scatter_kb": cases_usfft.max_rel(
            einsum["usfft_scatter_kb"](), usfft.scatter_kb_cuda(f, x, n, m, beta)
        ),
    }
    for name, err in einsum_err.items():
        if not err <= cases_usfft.EINSUM_TOL:
            raise AssertionError(f"{name}: the einsum yardstick differs by {err:.3e}")

    def calls(case, name):
        grid, x, f, n, m, beta = inputs[case]
        plan = plans[case][name][0]
        if name == "usfft_gather_kb":
            return dict(
                plain=lambda: usfft.gather_kb_plain(grid, x, n, m, beta),
                kernel=lambda: usfft.gather_kb_cuda(grid, x, n, m, beta, plan),
                own_plan=lambda: usfft.gather_kb_cuda(grid, x, n, m, beta),
            )
        return dict(
            plain=lambda: usfft.scatter_kb_plain(f, x, n, m, beta),
            kernel=lambda: usfft.scatter_kb_cuda(f, x, n, m, beta, plan),
            own_plan=lambda: usfft.scatter_kb_cuda(f, x, n, m, beta),
        )

    out = {}
    for name in USFFT_KERNELS:
        plan, plan_ms = plans[main][name]
        ms = median_ms_in_turns({**calls(main, name), "library": einsum[name]})
        graph_ms = graph_ms_per_call(calls(main, name)["kernel"])
        bound = cases_usfft.roofline(name, x, n, m)
        flops = cases_usfft.einsum_flops(64 * 128, 128, n)
        out[name] = dict(
            max_abs_err=errs[main][f"{name}_abs"],
            max_rel_err_all_cases=max(e[name] for e in errs.values()),
            ms=graph_ms,
            ms_eager_call=ms["kernel"],
            ms_eager_call_own_plan=ms["own_plan"],
            plan_ms=plan_ms,
            plan_bytes=plan.nbytes,
            plain_ms=ms["plain"],
            library_ms=ms["library"],
            library="the einsum chain of tike_tpu's "
            + ("gather_kb_rows" if name == "usfft_gather_kb" else "scatter_kb_rows")
            + " (torch.einsum, cuBLAS, TF32 off)",
            library_flops=flops,
            library_max_rel_err=einsum_err[name],
            bound_bytes=bound["bound_bytes"],
            bound_ms=bound["bound_ms"],
            bound_by=bound["bound_by"],
            roofline_share=bound["bound_ms"] / graph_ms,
            deterministic=True,
            card=card,
        )
        log(f"[usfft] {name} at {main} ({x.shape[0]} points): kernel "
            f"{graph_ms:.4f} ms (CUDA graph, plan built beforehand; eager call "
            f"{ms['kernel']:.4f} ms, building its own plan {ms['own_plan']:.4f} ms; the plan "
            f"{plan_ms:.3f} ms, {plan.nbytes} bytes), plain {ms['plain']:.4f} ms, einsum "
            f"{ms['library']:.4f} ms ({flops:.3e} flops); bound {bound['bound_ms']:.4f} ms "
            f"({bound['bound_bytes']} bytes at {cases_usfft.HBM_BYTES_PER_S:g} B/s"
            + (f", {bound['touched_cells']} grid values touched" if bound["touched_cells"] else "")
            + f"), {100 * out[name]['roofline_share']:.1f}% of it ({card})")
        for case in timed[1:]:
            _, x_c, _, n_c, m_c, _ = inputs[case]
            plan_c, plan_ms_c = plans[case][name]
            ms_c = median_ms_in_turns(calls(case, name), reps=5)
            graph_c = graph_ms_per_call(calls(case, name)["kernel"], reps=5)
            bound_c = cases_usfft.roofline(name, x_c, n_c, m_c)
            key = "256" if case.startswith("256") else "upsample2"
            out[name].update({
                f"ms_{key}": graph_c,
                f"ms_eager_call_own_plan_{key}": ms_c["own_plan"],
                f"plan_ms_{key}": plan_ms_c,
                f"plan_bytes_{key}": plan_c.nbytes,
                f"plain_ms_{key}": ms_c["plain"],
                f"bound_ms_{key}": bound_c["bound_ms"],
                f"bound_bytes_{key}": bound_c["bound_bytes"],
            })
            log(f"[usfft] {name} at {case} ({x_c.shape[0]} points, grid {n_c}^3, m = "
                f"{m_c}): kernel {graph_c:.4f} ms (CUDA graph, plan built beforehand; eager "
                f"call building its own plan {ms_c['own_plan']:.4f} ms; the plan "
                f"{plan_ms_c:.3f} ms, {plan_c.nbytes} bytes), plain {ms_c['plain']:.4f} ms; "
                f"bound {bound_c['bound_ms']:.4f} ms ({bound_c['bound_bytes']} bytes), "
                f"{100 * bound_c['bound_ms'] / graph_c:.1f}% of it ({card})")
    return out


def lamino_volume(n: int) -> np.ndarray:
    """bench_all.py's laminography volume (seed 0): a Gaussian-windowed
    random complex n^3 volume."""
    rng = np.random.default_rng(0)
    obj = (
        rng.standard_normal((n, n, n)) + 1j * rng.standard_normal((n, n, n))
    ).astype(np.complex64) * np.exp(
        -((np.mgrid[0:n, 0:n, 0:n] - n / 2) ** 2).sum(0) / (n / 3) ** 2
    )
    return obj.astype(np.complex64)


def lamino_problem(device, n=cases_usfft.LAMINO_N, ntheta=cases_usfft.LAMINO_NTHETA,
                   upsample=1):
    """(volume, theta, data) numpy: bench_all.py's volume and angles, the
    data simulated on ``device``."""
    volume = lamino_volume(n)
    theta = cases_usfft.lamino_theta(ntheta).numpy()
    data = tl.simulate(volume, theta, cases_usfft.LAMINO_TILT, eps=cases_usfft.LAMINO_EPS,
                       upsample=upsample, device=device)
    return volume, theta, data


def _max_rel(a, b) -> float:
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def phase_lamino_slices(device) -> None:
    """cgrad and CGLS on a small problem, card against CPU."""
    c = LAMINO_SLICE
    volume, theta, data = lamino_problem("cpu", c["n"], c["ntheta"], c["upsample"])
    data_card = tl.simulate(volume, theta, cases_usfft.LAMINO_TILT, eps=cases_usfft.LAMINO_EPS,
                            upsample=c["upsample"], device=device)
    err = _max_rel(data_card, data)
    if not err <= LAMINO_SIM_TOL:
        raise AssertionError(f"lamino slice: simulate on the card differs by {err:.3e}")
    for algorithm, cg_iter in LAMINO_SLICE_CG_ITER.items():
        results = {
            str(dev): tl.reconstruct(
                data, theta, cases_usfft.LAMINO_TILT, algorithm, num_iter=c["num_iter"],
                eps=cases_usfft.LAMINO_EPS, upsample=c["upsample"], cg_iter=cg_iter, device=dev,
            )
            for dev in ("cpu", device)
        }
        ref, got = results["cpu"], results[str(device)]
        if not (np.all(np.isfinite(got["cost"])) and np.all(np.diff(got["cost"]) < 0)):
            raise AssertionError(f"lamino slice {algorithm}: costs {got['cost']}")
        np.testing.assert_allclose(got["cost"], ref["cost"], rtol=LAMINO_SLICE_TOL)
        obj_err = _max_rel(got["obj"], ref["obj"])
        if not obj_err <= LAMINO_SLICE_TOL:
            raise AssertionError(f"lamino slice {algorithm}: volume differs by {obj_err:.3e}")
        log(f"[lamino-slice] {algorithm} (cg_iter {cg_iter}), {c['n']}^3, {c['ntheta']} "
            f"angles, upsample {c['upsample']}, {c['num_iter']} outer iterations on {device} "
            f"vs cpu: costs {got['cost'].tolist()} vs {ref['cost'].tolist()} (rtol "
            f"{LAMINO_SLICE_TOL:g}); volume max|err| / max|value| {obj_err:.2e}; simulate "
            f"{err:.2e}")


def phase_lamino(device, algorithm: str, card: str, problem) -> dict:
    """bench_all.py's lamino_cgrad or lamino_cgls at full width: one
    warm-up outer iteration, then LAMINO_TIMED timed ones from the start,
    with the kernel counts set to 0 just before and read just after. Then
    LAMINO_ROUNDS - 1 more timed runs for the spread, and the warm-up once
    more: the same start must give the same cost and volume bit for bit."""
    volume, theta, data = problem
    kwargs = dict(eps=cases_usfft.LAMINO_EPS, upsample=1, cg_iter=LAMINO_CG_ITER, device=device)
    tag = f"lamino-{algorithm}"

    def run(num_iter):
        start = time.perf_counter()
        result = tl.reconstruct(
            data, theta, cases_usfft.LAMINO_TILT, algorithm, num_iter=num_iter, **kwargs
        )
        torch.cuda.synchronize()
        return result, time.perf_counter() - start

    for name in usfft.LAUNCHES:
        usfft.LAUNCHES[name] = 0
    opt.HOST_READS["line_search"] = 0
    torch.cuda.reset_peak_memory_stats()
    warm, first_s = run(1)
    result, timed_s = run(LAMINO_TIMED)
    launches = dict(usfft.LAUNCHES)
    reads = opt.HOST_READS["line_search"]
    peak = torch.cuda.max_memory_allocated()
    costs = result["cost"]
    log(f"[{tag}] costs per outer iteration {costs.tolist()} (warm-up {warm['cost'].tolist()})")
    if len(costs) != LAMINO_TIMED or not np.all(np.isfinite(costs)):
        raise AssertionError(f"costs are not {LAMINO_TIMED} finite values: {costs}")
    if not (costs[-1] < costs[0] and np.all(np.diff(costs) <= 1e-6 * costs[:-1])):
        raise AssertionError(f"costs do not decrease: {costs}")
    for name in usfft.LAUNCHES:
        if not launches[name] > 0:
            raise AssertionError(f"{tag} launched no {name} kernel: {launches}")
    obj = result["obj"]
    if obj.shape != volume.shape or not np.all(np.isfinite(obj)):
        raise AssertionError("reconstructed volume is not finite or has the wrong shape")
    per_iter = timed_s / LAMINO_TIMED
    more = [run(LAMINO_TIMED) for _ in range(LAMINO_ROUNDS - 1)]
    rounds = [per_iter] + [seconds / LAMINO_TIMED for _, seconds in more]
    log(f"[{tag}] {LAMINO_TIMED} outer iterations (cg_iter {LAMINO_CG_ITER}) in {timed_s:.3f} s "
        f"= {per_iter:.4f} s/iteration; first call (1 iteration) {first_s:.3f} s, so set-up "
        f"{first_s - per_iter:.3f} s ({card})")
    log(f"[{tag}] s/iteration of {LAMINO_ROUNDS} timed runs {[round(r, 5) for r in rounds]}, "
        f"median {statistics.median(rounds):.5f} ({card})")
    log(f"[{tag}] peak device memory {peak} bytes ({peak / 2**30:.3f} GiB); kernel launches "
        f"{launches}; line-search host reads {reads} ({card})")
    # Nothing on this path adds in an order that varies: the same start
    # gives the same bits, run after run.
    again, _ = run(1)
    repeats = [(again, warm, "the warm-up run twice")] + [
        (r, result, f"timed run {i + 2} against the first") for i, (r, _) in enumerate(more)
    ]
    for got, want, what in repeats:
        for key in ("cost", "obj"):
            if not np.array_equal(got[key], want[key]):
                diff = float(np.max(np.abs(got[key] - want[key])) / np.max(np.abs(want[key])))
                raise AssertionError(
                    f"{tag}: {what}: {key} differs by {diff:.3e} of the largest value from the "
                    "same start"
                )
    if not np.array_equal(costs[:1], warm["cost"]):
        raise AssertionError(f"{tag}: first timed cost {costs[0]} != warm-up's {warm['cost'][0]}")
    log(f"[{tag}] the warm-up run twice and the {LAMINO_ROUNDS} timed runs from the same start: "
        "costs and volumes bitwise equal")
    return launches


def phase_probes(device, card: str):
    """The seven feature probes: run each once through its entry point
    (counted), each output equal to its plain version bit for bit, then
    times beside the bounds: the kernel in a CUDA graph with its index
    check (a host read) left out, the eager call with it, and the library
    call both ways."""
    inp = toolchain_probe.inputs(device)
    for name in toolchain_probe.LAUNCHES:
        toolchain_probe.LAUNCHES[name] = 0
    outputs = toolchain_probe.run(inp)
    torch.cuda.synchronize()
    launches = dict(toolchain_probe.LAUNCHES)
    toolchain_probe.check(outputs, inp)
    for name, count in launches.items():
        if count != 1:
            raise AssertionError(f"probe {name} launched {count} times: {launches}")
    x0, x, big = inp["x"][0], inp["x"], inp["big"]
    rows, cols = toolchain_probe.ROWS, toolchain_probe.WINDOW_COLS

    width = big.shape[1]

    def windows(offset, step):
        return big.as_strided((8, rows, cols), (step, width, 1), offset)

    library = {
        "trivial": lambda: torch.mul(x0, 2.0),
        "gridded": lambda: torch.mul(x, 2.0),
        "prefetch": None,
        "static_dma": lambda: x0[0:rows, 0:toolchain_probe.COLS].clone(),
        "dynamic_dma": lambda: windows(0, 8 * width + 16).clone(),
        "element_static": lambda: torch.mul(windows(0, 8 * width + 16), 2.0),
        "element_prefetch": lambda: torch.mul(windows(3 * width + 5, 9 * width + 17), 2.0),
    }
    out = {}
    for name, fn in toolchain_probe.FUNCTIONS.items():
        args = toolchain_probe._args(name, inp)
        # The run above checked these indices.
        unchecked = {"check_indices": False} if name in toolchain_probe.INDEXED else {}
        fns = {"plain": lambda: toolchain_probe.PLAIN[name](*args), "kernel": lambda: fn(*args)}
        if library[name] is not None:
            if not torch.equal(library[name](), outputs[name]):
                raise AssertionError(f"probe {name}: the library call differs")
            fns["library"] = library[name]
        ms = median_ms_in_turns(fns)
        if not torch.equal(fn(*args, **unchecked), outputs[name]):
            raise AssertionError(f"probe {name}: the call without the index check differs")
        graph_ms = graph_ms_per_call(lambda: fn(*args, **unchecked))
        library_graph_ms = graph_ms_per_call(library[name]) if library[name] else None
        nbytes = toolchain_probe.bound_bytes(name, inp, outputs[name])
        bound_ms = 1e3 * nbytes / cases.HBM_BYTES_PER_S
        out[name] = dict(
            max_abs_err=0.0,
            ms=graph_ms,
            ms_eager_call=ms["kernel"],
            plain_ms=ms["plain"],
            library_ms=library_graph_ms,
            library_ms_eager_call=ms.get("library"),
            bound_bytes=nbytes,
            bound_ms=bound_ms,
            bound_by="bytes",
            roofline_share=bound_ms / graph_ms,
            deterministic=True,
            card=card,
        )
        lib = (
            f"{library_graph_ms:.4f} ms (CUDA graph; eager call {ms['library']:.4f} ms)"
            if "library" in ms else "none"
        )
        log(f"[probe] {name} ({toolchain_probe.PROBES[name][0]}): equal to its plain version "
            f"bit for bit; kernel {graph_ms:.4f} ms (CUDA graph, index check outside; eager call "
            f"{ms['kernel']:.4f} ms), plain {ms['plain']:.4f} ms, library {lib}; bound "
            f"{bound_ms:.5f} ms ({nbytes} bytes) ({card})")
    return launches, out


def main() -> None:
    env = phase_environment()
    device = torch.device("cuda", 0)
    card = env["nvidia_smi"]
    phase_build()
    timings = phase_kernel_parity(device, card)
    timings.update(phase_usfft_parity(device, card))
    scan, psi, probe = make_inputs(N_PATTERNS)
    phase_forward_model(device, scan, psi, probe)
    phase_small_slice(device)
    phase_small_slice(device, config2=True)
    phase_rpie_slices(device)
    launches = phase_main_path(device, scan, psi, probe, env["nvidia_smi"])
    launches2 = phase_config2(device, scan, psi, probe, env["nvidia_smi"])
    launches3 = phase_rpie(device, scan, psi, probe, env["nvidia_smi"])
    phase_siemens(device, env["nvidia_smi"])
    phase_lamino_slices(device)
    problem = lamino_problem(device)
    volume, theta, data = problem
    data_cpu = tl.simulate(volume, theta, cases_usfft.LAMINO_TILT, eps=cases_usfft.LAMINO_EPS,
                           upsample=1, device="cpu")
    err = _max_rel(data, data_cpu)
    if not err <= LAMINO_SIM_TOL:
        raise AssertionError(f"lamino: simulate on the card differs from the CPU's by {err:.3e}")
    log(f"[lamino] simulate {tuple(data.shape)} at {volume.shape[0]}^3 on the card vs the "
        f"CPU: max|err| / max|value| {err:.2e} (tol {LAMINO_SIM_TOL:g})")
    lamino_launches = {alg: phase_lamino(device, alg, card, problem) for alg in ("cgrad", "cgls")}
    probe_launches, probe_timings = phase_probes(device, card)
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
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "tike_tpu_torch/csrc/usfft.cu",
            "replaces": USFFT_KERNELS[name],
            "launches": lamino_launches["cgrad"][name],
            "launches_lamino_cgrad": lamino_launches["cgrad"][name],
            "launches_lamino_cgls": lamino_launches["cgls"][name],
            **timings[name],
        }
        for name in USFFT_KERNELS
    ] + [
        {
            "name": f"probe_{name}",
            "route": "cuda",
            "source": "tike_tpu_torch/csrc/probe.cu",
            "replaces": PROBE_KERNELS[name],
            "launches": probe_launches[name],
            **probe_timings[name],
        }
        for name in PROBE_KERNELS
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
