#!/usr/bin/env python3
"""Drive the PyTorch port (tike_tpu_torch) once on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (``nvcc``), and imports nothing
of JAX. Phases, in order; any failure raises and the script exits non-zero
without printing the final ``ok`` line:

1. environment: torch, CUDA, card, power limit and nvcc versions;
2. build: compile ``tike_tpu_torch/csrc/patch.cu``, ``usfft.cu`` and
   ``probe.cu`` for sm_90a, and ``probe.cu`` with its gridded and prefetch
   kernels in their parent's form (``kernel_sweep.parent_form``), one nvcc
   each, all started together;
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
    version bit for bit, the element windows also at every lead (``cx %
    4``) at ``big``'s edges, gridded and prefetch also at odd shapes and
    index arrays (``tests/_torch_probe_cases.py``), then timed beside its
    bound: in a CUDA graph with the index check left out (the kernel's own
    time), in turns with the launch floor (``csrc/probe.cu``'s empty kernel
    at the probe's grid), the library call (two calls for ``prefetch``) and,
    for gridded and prefetch, the kernel in its parent's form; and as an
    eager call with the index check, beside the plain version and the
    library call.

After phase 12, the joint-ADMM and host-streamed paths:

3c. (with phase 3) both patch kernels against their plain versions, two
    launches bitwise equal, at the two new paths' shapes: 200 windows of
    16^2 on a 64^2 image (complex64, and float32 as the ADMM coverage
    weights spread it) and one streamed batch of 10,000 windows of 64^2 on
    4096^2; each kernel's time beside its bound there;
13. small slices, card against CPU: a streamed rPIE and a streamed LSQML
    run (``store_data_on_device=False``) equal bit for bit to the resident
    run on the card and equal to the CPU's streamed run at phase 5's
    tolerance; a ``convergence_window`` run and a ``time_limit`` run that
    stop after the same epoch on the card as on the CPU; one joint-ADMM
    iteration (n = 16, 3 angles) card against CPU;
14. ``admm_joint`` at ``bench_all.py``'s size (n = 64, P = 16, 8 angles, 200
    positions per angle, rPIE ``num_batch=1``, ``ptycho_iter=2``,
    ``lamino_iter=2``, upsample 2): one warm-up iteration, then three timed
    runs of 3 iterations from the warm-up's result, the kernel counts set
    to 0 before the first and read after it; s/iteration, set-up, peak
    memory, finite and decreasing costs, the three runs bitwise equal, one
    ``LaminoPlan`` built per call;
15. ``stream_1m`` at ``bench_all.py``'s size (1,000,000 x 64^2 float32
    patterns in pinned host memory, a 4096^2 object, rPIE,
    ``num_batch=100``, ``batch_method="random"``, seed 0, the probe rescaled
    from the streamed data at set-up, one epoch): patterns/s, s/epoch,
    set-up split into clustering, pinning and rescale, peak device memory
    (it fails above 4 GB), a finite cost, and the overlap: the copy
    stream's busy time and the compute stream's wait on it. A host that
    cannot pin the data makes the phase halve the number of patterns and
    say so; nothing is copied from pageable memory. Then
    ``bench_all.py``'s comparison at 100,000 patterns (``num_batch=10``):
    resident against streamed s/epoch, and their results bitwise equal.

The line before the last lists each kernel (its launches in phase 14's
first timed run as ``launches_admm`` and in phase 15's epoch as
``launches_stream``; its launches in phase 6 as
``launches``, in phase 7 as ``launches_config2`` and in phase 8 as
``launches_rpie``; the KB kernels' in phase 11's cgrad as ``launches`` and
``launches_lamino_cgrad`` and in its CGLS as ``launches_lamino_cgls``; the
probes' in phase 12; its error against the plain version, its time, the
plain version's and the library call's, its bound in bytes and ms and its
share of that bound, the same on the compact batch, whether it is
deterministic; each probe's launch floor ``floor_ms``, for gridded and
prefetch the parent's form's time ``parent_form_ms``, and for prefetch,
which no single call computes, ``library_ms`` null beside
``library_two_calls_ms``); each full-width path also logs each kernel's bound per
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

import tike_tpu_torch.admm as tadmm
import tike_tpu_torch.lamino as tl
import tike_tpu_torch.ptycho as tp
from tests import _torch_patch_cases as cases
from tests import _torch_probe_cases as cases_probe
from tests import _torch_usfft_cases as cases_usfft
from tike_tpu_torch import kernel_sweep, kernels, opt, toolchain_probe
from tike_tpu_torch.constants import wavenumber
from tike_tpu_torch.ops import patch, usfft
from tike_tpu_torch.ops.lamino import LaminoPlan

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
# The probe kernels redesigned last, timed beside their parent's form.
PARENT_FORM_PROBES = ("gridded", "prefetch")

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


# Joint ADMM (bench_all.py's admm_joint): an n^3 volume, T angles, a
# P-pixel probe and NPOS positions per angle, 10 keV, 1e-7 cm voxels; one
# warm-up iteration, then ADMM_TIMED iterations, ADMM_ROUNDS times.
ADMM = dict(n=64, P=16, T=8, NPOS=200)
ADMM_SLICE = dict(n=16, P=8, T=3, NPOS=30)
# The KB kernels' case at the points of ADMM's volume fit and re-projection.
ADMM_USFFT_CASE = f"{ADMM['n']}^3 / {ADMM['T']} angles at tilt pi/2, upsample 2 (admm_joint)"
ADMM_ENERGY, ADMM_VOXEL = 10.0, 1e-7
ADMM_TIMED, ADMM_ROUNDS = 3, 3
# The ADMM slice, card against CPU: psi and the costs, which do not pass
# through the volume fit within one iteration, take SLICE_TOL. The fit is
# cgrad at cg_iter 4, whose line search decides some trials on ties that the
# FFT library's last bits break (ROADMAP.md section 3), so the iteration's
# own volumes may part and their gap is printed only; the fit of the same
# phi at cg_iter 1 and its re-projection take LAMINO_SLICE_TOL.
# Host streaming (bench_all.py's stream_1m): 1,000,000 patterns of 64^2, a
# 4096^2 object, rPIE, 100 random batches; its comparison at 100,000
# patterns in 10 batches. Peak device memory must stay under the limit:
# two batches and the model, whatever the number of patterns.
STREAM = dict(n_patterns=1_000_000, det=64, hw=4096, num_batch=100)
STREAM_COMPARE = dict(n_patterns=100_000, det=64, hw=4096, num_batch=10)
STREAM_PEAK_LIMIT = 4e9


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


def phase_build():
    """Build every source with one nvcc each, all started together, and
    ``probe.cu`` in its parent's form; returns the latter, loaded."""
    start = time.perf_counter()
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    probe_source = (kernels.CSRC / "probe.cu").read_text()
    parent = kernel_sweep.start_builds(
        "probe",
        {"parent form": kernel_sweep.variant_source(
            probe_source, kernel_sweep.parent_form(probe_source))},
        kernels.BUILD_DIR,
    )
    kernels.build_all(SOURCES)
    libs, failed = kernel_sweep.finish_builds("probe", parent)
    if failed:
        raise RuntimeError(f"nvcc failed on probe.cu in its parent's form:\n{failed}")
    log(f"[build] {len(SOURCES) + 1} sources in {time.perf_counter() - start:.2f} s")
    for name in SOURCES:
        kernels.load(name)
        info = kernels.BUILD_INFO[name]
        log(f"[build] csrc/{name}.cu -> {info['path']} in {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {line.strip()}")
    return libs["parent form"]


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


def graph_ms_in_turns(fns: dict) -> dict:
    """Median ms per call of each function of ``fns`` by
    :func:`graph_ms_per_call`, in turns: in their order, in the reverse
    order, in order again."""
    times = {name: [] for name in fns}
    order = list(fns)
    for turn in (order, order[::-1], order):
        for name in turn:
            times[name].append(graph_ms_per_call(fns[name]))
    return {name: statistics.median(t) for name, t in times.items()}


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
    7 (the generic path; upsample 2 at eps 1e-12), the rows of a 256^3
    / 128-angle transform, and the points of the joint-ADMM path (ADMM's
    volume and angles at tilt pi/2, upsample 2: every detector row in one
    plane of the grid)."""
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
        ADMM_USFFT_CASE: (
            *cases_usfft.window_for(ADMM["n"], eps, 2),
            cases_usfft.lamino_rows(ADMM["n"], ADMM["T"], device, np.pi / 2).reshape(-1, 3),
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
    timed = (
        main, "128^3 / 64 angles, upsample 2", "256^3 / 128 angles, upsample 1", ADMM_USFFT_CASE,
    )
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
            key = (
                "admm_shape" if case == ADMM_USFFT_CASE
                else "256" if case.startswith("256") else "upsample2"
            )
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


def phase_probes(device, card: str, parent_form):
    """The seven feature probes: run each once through its entry point
    (counted), each output equal to its plain version bit for bit, the odd
    shapes of gridded and prefetch likewise, then times beside the bounds:
    the kernel in a CUDA graph with its index check (a host read) left out,
    in turns with the launch floor, the library call and, for
    ``PARENT_FORM_PROBES``, the kernel in its parent's form (the library
    ``parent_form``); the eager call with the check, the plain version and
    the library call in turns."""
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
    # The element kernel's every lead (cx % 4) at big's edges, on the probes'
    # big and on a random narrower one.
    rng = np.random.default_rng(0)
    for big in (inp["big"], cases_probe.random_big(rng, cases_probe.BIG_SHAPES[1], device)):
        for lead in cases_probe.LEADS:
            cases_probe.check_windows(big, cases_probe.edge_corners(tuple(big.shape), lead))
    log(f"[probe] element_prefetch equal to its plain version bit for bit at every lead 0-3 at "
        f"the edges of big {list(cases_probe.BIG_SHAPES)}")
    cases_probe.check_odd_shapes(device)
    log(f"[probe] gridded at {list(cases_probe.GRIDDED_SHAPES)} (arange and random values) and "
        f"prefetch on 8 planes of {list(cases_probe.PREFETCH_PLANES)} ({', '.join(cases_probe.INDEX_KINDS)} "
        "indices): equal to their plain versions bit for bit")
    library = cases_probe.library_calls(inp)
    out = {}
    for name, fn in toolchain_probe.FUNCTIONS.items():
        args = toolchain_probe._args(name, inp)
        # The run above checked these indices.
        unchecked = {"check_indices": False} if name in toolchain_probe.INDEXED else {}
        if not torch.equal(library[name](), outputs[name]):
            raise AssertionError(f"probe {name}: the library call differs")
        ms = median_ms_in_turns({
            "plain": lambda: toolchain_probe.PLAIN[name](*args),
            "library": library[name],
            "kernel": lambda: fn(*args),
        })
        kernel = lambda: fn(*args, **unchecked)
        if not torch.equal(kernel(), outputs[name]):
            raise AssertionError(f"probe {name}: the call without the index check differs")
        fns = {"kernel": kernel, "floor": cases_probe.floor_call(name, inp), "library": library[name]}
        if name in PARENT_FORM_PROBES:

            def in_parent_form():
                with kernel_sweep.loaded("probe", parent_form):
                    return kernel()

            if not torch.equal(in_parent_form(), outputs[name]):
                raise AssertionError(f"probe {name}: the parent's form differs")
            fns["parent form"] = in_parent_form
        graph = graph_ms_in_turns(fns)
        nbytes = toolchain_probe.bound_bytes(name, inp, outputs[name])
        bound_ms = 1e3 * nbytes / cases.HBM_BYTES_PER_S
        # library_ms is one call's; prefetch's yardstick is two.
        one_call = name != "prefetch"
        out[name] = dict(
            max_abs_err=0.0,
            ms=graph["kernel"],
            ms_eager_call=ms["kernel"],
            plain_ms=ms["plain"],
            library_ms=graph["library"] if one_call else None,
            library_ms_eager_call=ms["library"] if one_call else None,
            **({} if one_call else {
                "library_two_calls_ms": graph["library"],
                "library_two_calls_ms_eager_call": ms["library"],
            }),
            library=cases_probe.LIBRARY_NAMES[name],
            bound_bytes=nbytes,
            bound_ms=bound_ms,
            bound_by="bytes",
            floor_ms=graph["floor"],
            roofline_share=bound_ms / graph["kernel"],
            deterministic=True,
            card=card,
        )
        parent = ""
        if "parent form" in graph:
            out[name]["parent_form_ms"] = graph["parent form"]
            parent = f"; the parent's form {graph['parent form']:.5f} ms (CUDA graph, same turns)"
        log(f"[probe] {name} ({toolchain_probe.PROBES[name][0]}): equal to its plain version "
            f"bit for bit; kernel {graph['kernel']:.5f} ms (CUDA graph, index check outside; eager "
            f"call {ms['kernel']:.4f} ms){parent}; launch floor (empty kernel at its grid) "
            f"{graph['floor']:.5f} ms; library ({cases_probe.LIBRARY_NAMES[name]}) "
            f"{graph['library']:.5f} ms (CUDA graph; eager {ms['library']:.4f} ms); plain "
            f"{ms['plain']:.4f} ms; bound {bound_ms:.5f} ms ({nbytes} bytes), "
            f"{100 * bound_ms / graph['kernel']:.1f}% of it ({card})")
    return launches, out


def phase_path_shapes(device, card: str) -> dict:
    """3c: the patch kernels at the ADMM and the streamed paths' shapes,
    against their plain versions (two launches bitwise equal), with each
    kernel's time beside its bound for those positions."""
    out = {}
    for name in cases.PATH_SHAPES:
        for dtype in (np.complex64, np.float32):
            image, positions, patches, p = cases.path_shape_inputs(name, device, dtype)
            label = f"{name}, {np.dtype(dtype).name}"
            errs = cases.check_patch_kernels(image, positions, patches, p, label)
            log(f"[parity] {label}: patch_fwd max|err| {errs['patch_fwd']:.3e}, patch_adj "
                f"{errs['patch_adj']:.3e}; two launches of each bitwise equal")
        image, positions, patches, p = cases.path_shape_inputs(name, device)
        shape = tuple(image.shape)
        fns = {
            "patch_fwd": lambda: patch.patch_fwd_cuda(image, positions, p),
            "patch_adj": lambda: patch.patch_adj_cuda(patches, positions, shape),
        }
        out[name] = {}
        for kernel, fn in fns.items():
            ms = graph_ms_per_call(fn, reps=10)
            bound = cases.roofline(kernel, positions, p, shape, torch.complex64)
            out[name][kernel] = dict(ms=ms, **bound)
            log(f"[parity] {kernel} at {name}: kernel {ms:.4f} ms (CUDA graph), bound "
                f"{bound['bound_ms']:.5f} ms ({bound['bound_bytes']} bytes, by "
                f"{bound['bound_by']}), {100 * bound['bound_ms'] / ms:.1f}% of it ({card})")
    return out


def _stream_slice_parameters(scan, probe, psi0, det, solver, **algo):
    options = tp.RpieOptions if solver == "rpie" else tp.LstsqOptions
    return tp.PtychoParameters(
        probe=probe,
        psi=psi0,
        scan=scan,
        algorithm_options=options(
            **{"num_batch": 3, "rescale_period": 2, "batch_method": "random", **algo}
        ),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
        exitwave_options=tp.ExitWaveOptions(measured_pixels=np.ones((det, det), bool)),
    )


def _run_slice(data, params, device, epochs, store=None, history=None):
    """``iterate(epochs)`` on ``device``; ``history`` (costs, times) stands
    for epochs already run. Returns the result."""
    if history is not None:
        params.algorithm_options.costs = [[c] for c in history[0]]
        params.algorithm_options.times = list(history[1])
    with tp.Reconstruction(
        data, params, device=device, random_seed=0, store_data_on_device=store
    ) as context:
        context.iterate(epochs)
        return context.get_result()


def phase_stream_slices(device) -> None:
    """13a: streamed rPIE and LSQML on the card, bit for bit the resident
    run's and within SLICE_TOL of the CPU's streamed run."""
    scan, psi, probe, psi0 = _slice_inputs(np.random.default_rng(3), _random_phase_probe)
    det = 24
    data = tp.simulate(det, probe, scan, psi, device="cpu")
    for solver, num_batch in (("rpie", 3), ("lstsq", 4)):
        # The resident run takes the per-epoch path too (a finite limit),
        # the path of a streamed run.
        make = lambda: _stream_slice_parameters(
            scan, probe, psi0, det, solver, num_batch=num_batch, time_limit=1e6
        )
        resident = _run_slice(data, make(), device, 3, store=True)
        streamed = _run_slice(data, make(), device, 3, store=False)
        on_cpu = _run_slice(data, make(), "cpu", 3, store=False)
        costs = np.ravel(streamed.algorithm_options.costs)
        if not (np.all(np.isfinite(costs)) and costs[-1] < costs[0]):
            raise AssertionError(f"streamed {solver} slice: costs {costs}")
        for key in ("psi", "probe"):
            if not np.array_equal(getattr(streamed, key), getattr(resident, key)):
                diff = _max_rel(getattr(streamed, key), getattr(resident, key))
                raise AssertionError(
                    f"streamed {solver} slice: {key} differs from the resident run's by "
                    f"{diff:.3e}: the copy stream and the compute stream race"
                )
        if streamed.algorithm_options.costs != resident.algorithm_options.costs:
            raise AssertionError(f"streamed {solver} slice: costs differ from the resident run's")
        np.testing.assert_allclose(
            costs, np.ravel(on_cpu.algorithm_options.costs), rtol=SLICE_TOL
        )
        errs = {}
        for key in ("psi", "probe"):
            a, b = getattr(streamed, key), getattr(on_cpu, key)
            np.testing.assert_allclose(a, b, rtol=SLICE_TOL, atol=SLICE_TOL * np.abs(b).max())
            errs[key] = f"{_max_rel(a, b):.2e}"
        log(f"[stream-slice] {solver}, {num_batch} random batches, 3 epochs streamed on "
            f"{device}: costs {costs.tolist()}; psi, probe and costs bitwise equal to the "
            f"resident run; vs the CPU's streamed run max|err| / max|value| {errs} "
            f"(tol {SLICE_TOL:g})")


def phase_stopping_slices(device) -> None:
    """13b: the stopping rules of ``iterate``, card against CPU: a run
    that continues three epochs of tiny recorded costs sees a rising cost
    in its ``convergence_window`` and stops after the first chunk; a
    ``time_limit`` below any epoch's time stops after the first epoch."""
    scan, psi, probe, psi0 = _slice_inputs(np.random.default_rng(4), _random_phase_probe)
    det = 24
    data = tp.simulate(det, probe, scan, psi, device="cpu")
    history = ([1e-9, 2e-9, 3e-9], [0.1, 0.1, 0.1])
    cases_ = (
        ("convergence_window=4, LSQML compact, fused chunks", "lstsq",
         dict(convergence_window=4, batch_method="compact"), history, 3 + 2),
        ("convergence_window=4 with a time_limit, rPIE, per epoch", "rpie",
         dict(convergence_window=4, time_limit=1e6), history, 3 + 1),
        ("time_limit=1e-9, rPIE", "rpie", dict(time_limit=1e-9), None, 1),
    )
    for name, solver, algo, hist, want_epochs in cases_:
        runs = {
            str(dev): _run_slice(
                data, _stream_slice_parameters(scan, probe, psi0, det, solver, **algo),
                dev, 6, history=hist,
            )
            for dev in ("cpu", device)
        }
        got, ref = runs[str(device)], runs["cpu"]
        n_got, n_ref = len(got.algorithm_options.costs), len(ref.algorithm_options.costs)
        if not n_got == n_ref == want_epochs:
            raise AssertionError(
                f"{name}: the card stopped after {n_got} epochs, the CPU after {n_ref}; "
                f"expected {want_epochs}"
            )
        np.testing.assert_allclose(
            np.ravel(got.algorithm_options.costs), np.ravel(ref.algorithm_options.costs),
            rtol=SLICE_TOL,
        )
        err = _max_rel(got.psi, ref.psi)
        if not err <= SLICE_TOL:
            raise AssertionError(f"{name}: psi differs from the CPU's by {err:.3e}")
        log(f"[stop-slice] {name}: asked for 6 epochs, stopped with {n_got} recorded on "
            f"{device} and on the cpu; psi max|err| / max|value| {err:.2e} (tol {SLICE_TOL:g})")


def admm_problem(device, n, P, T, NPOS):
    """bench_all.py's admm_joint problem (seed 0), made with the port: a
    cube of refractive index in an n^3 volume, its projections at T angles
    (tilt pi/2, upsample 2) exponentiated into transmissions, and their
    diffraction data at NPOS positions under a P-pixel Gaussian probe.
    Returns (data, parameters factory, theta)."""
    rng = np.random.default_rng(0)
    k = wavenumber(ADMM_ENERGY)
    delta = 0.5 / (k * ADMM_VOXEL * n / 2)
    obj = np.zeros((n, n, n), dtype=np.complex64)
    s = slice(n // 4, 3 * n // 4)
    obj[s, s, s] = delta * (1 + 0.1j)
    theta = np.linspace(0, np.pi, T, endpoint=False).astype(np.float32)
    lines = tl.simulate(obj, theta, np.pi / 2, eps=1e-3, upsample=2, device=device) * ADMM_VOXEL
    psi_true = np.exp(1j * k * lines).astype(np.complex64)
    probe = (tp.gaussian(P) * (1 + 0j))[None, None, None].astype(np.complex64)
    scan = np.stack(
        [rng.uniform(2, n - P - 3, NPOS), rng.uniform(2, n - P - 3, NPOS)], -1
    ).astype(np.float32)
    data = [
        tp.simulate(P, probe, scan, psi_true[t][None], device=device).astype(np.float32)
        for t in range(T)
    ]
    parameters = lambda: [
        tp.PtychoParameters(
            psi=np.ones((1, n, n), np.complex64),
            probe=probe.copy(),
            scan=scan.copy(),
            algorithm_options=tp.RpieOptions(num_batch=1, num_iter=1),
            object_options=tp.ObjectOptions(),
            probe_options=tp.ProbeOptions(init_rescale_from_measurements=False),
        )
        for _ in range(T)
    ]
    return data, parameters, theta


def _admm(data, parameters, theta, device, num_iter, obj=None):
    return tadmm.reconstruct_joint_admm(
        data, parameters, theta, obj=obj, voxelsize=ADMM_VOXEL, energy=ADMM_ENERGY,
        num_iter=num_iter, ptycho_iter=2, lamino_iter=2, device=device,
    )


def phase_admm_slice(device) -> None:
    """13c: one joint-ADMM iteration at n = 16, card against CPU: the
    costs and psi after the blend of the whole iteration, then the
    iteration's volume fit (cgrad at upsample 2, the KB kernels at m = 2
    and tilt pi/2) and re-projection from the card's phi, with the fit at
    one CG step an outer iteration, where no line-search trial is a tie."""
    data, parameters, theta = admm_problem("cpu", **ADMM_SLICE)
    runs = {str(dev): _admm(data, parameters(), theta, dev, 1) for dev in ("cpu", device)}
    got, ref = runs[str(device)], runs["cpu"]
    np.testing.assert_allclose(got["costs"], ref["costs"], rtol=SLICE_TOL)
    psi_err = max(
        _max_rel(g.psi, r.psi) for g, r in zip(got["parameters"], ref["parameters"])
    )
    obj_err = _max_rel(got["obj"], ref["obj"])
    if not psi_err <= SLICE_TOL:
        raise AssertionError(f"ADMM slice: psi after the blend differs by {psi_err:.3e}")
    if not np.all(np.isfinite(got["obj"])):
        raise AssertionError("ADMM slice: the volume is not finite")
    # Step 2 of the first iteration, where the dual is still zero.
    psi = np.stack([p.psi[0] for p in got["parameters"]])
    phi = ((-1j / wavenumber(ADMM_ENERGY)) * np.log(psi + 1e-12) / ADMM_VOXEL).astype(np.complex64)
    fits, lines = {}, {}
    for dev in ("cpu", device):
        fits[str(dev)] = tl.reconstruct(
            phi, theta, np.pi / 2, "cgrad", num_iter=2, eps=1e-3, upsample=2,
            cg_iter=LAMINO_SLICE_CG_ITER["cgrad"], device=dev,
        )
        lines[str(dev)] = tl.simulate(
            fits["cpu"]["obj"], theta, np.pi / 2, eps=1e-3, upsample=2, device=dev
        )
    fit_err = _max_rel(fits[str(device)]["obj"], fits["cpu"]["obj"])
    fwd_err = _max_rel(lines[str(device)], lines["cpu"])
    np.testing.assert_allclose(
        fits[str(device)]["cost"], fits["cpu"]["cost"], rtol=LAMINO_SLICE_TOL
    )
    if not (np.any(fits["cpu"]["obj"]) and fit_err <= LAMINO_SLICE_TOL):
        raise AssertionError(f"ADMM slice: the volume fit of phi differs by {fit_err:.3e}")
    if not fwd_err <= LAMINO_SLICE_TOL:
        raise AssertionError(f"ADMM slice: the re-projection differs by {fwd_err:.3e}")
    log(f"[admm-slice] 1 iteration at {ADMM_SLICE} on {device} vs cpu: costs {got['costs']} vs "
        f"{ref['costs']} (rtol {SLICE_TOL:g}); psi after the blend max|err| / max|value| "
        f"{psi_err:.2e} (tol {SLICE_TOL:g}); the volume fit of the card's phi at cg_iter "
        f"{LAMINO_SLICE_CG_ITER['cgrad']} (2 outer iterations, upsample 2, tilt pi/2) "
        f"{fit_err:.2e}, its costs {fits[str(device)]['cost'].tolist()} vs "
        f"{fits['cpu']['cost'].tolist()}, and the re-projection of that volume {fwd_err:.2e} "
        f"(tol {LAMINO_SLICE_TOL:g}); for information, the iteration's own volume at ADMM's "
        f"cg_iter 4, where cgrad decides trials on ties, {obj_err:.2e}")


def _reset_launches() -> None:
    """Every kernel's count to 0: the patch, the KB and the probe kernels'."""
    for counts in (patch.LAUNCHES, usfft.LAUNCHES, toolchain_probe.LAUNCHES):
        for name in counts:
            counts[name] = 0


def _read_launches(tag) -> dict:
    """The counts since ``_reset_launches``, the probes' under their
    ``probe_`` names; no path launches a probe, and one that did fails."""
    probes = {f"probe_{name}": count for name, count in toolchain_probe.LAUNCHES.items()}
    if any(probes.values()):
        raise AssertionError(f"{tag} launched probe kernels: {probes}")
    return {**patch.LAUNCHES, **usfft.LAUNCHES, **probes}


def phase_admm(device, card: str) -> dict:
    """14: bench_all.py's admm_joint. One warm-up iteration, then
    ADMM_ROUNDS runs of ADMM_TIMED iterations, each from the warm-up's
    parameters and volume; the first run is the counted one."""
    tag = "admm"
    start = time.perf_counter()
    data, parameters, theta = admm_problem(device, **ADMM)
    log(f"[{tag}] problem {ADMM} simulated on {device} in {time.perf_counter() - start:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    warm = _admm(data, parameters(), theta, device, 1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - start
    runs, seconds, plans = [], [], []
    for r in range(ADMM_ROUNDS):
        if r == 0:
            _reset_launches()
        built = LaminoPlan.built
        start = time.perf_counter()
        runs.append(_admm(data, warm["parameters"], theta, device, ADMM_TIMED, obj=warm["obj"]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        plans.append(LaminoPlan.built - built)
        if r == 0:
            launches = _read_launches(tag)
    peak = torch.cuda.max_memory_allocated()
    costs = runs[0]["costs"]
    log(f"[{tag}] warm-up cost {warm['costs']}; costs of the {ADMM_TIMED} timed iterations {costs}")
    if len(costs) != ADMM_TIMED or not np.all(np.isfinite(costs)):
        raise AssertionError(f"{tag}: costs are not {ADMM_TIMED} finite values: {costs}")
    if not (costs[-1] < costs[0] and costs[0] < warm["costs"][0]):
        raise AssertionError(f"{tag}: costs do not decrease: {warm['costs']} then {costs}")
    obj = runs[0]["obj"]
    if obj.shape != (ADMM["n"],) * 3 or not np.all(np.isfinite(obj)):
        raise AssertionError(f"{tag}: the volume is not finite or has the wrong shape")
    for name in (*KERNELS, *USFFT_KERNELS):
        if not launches[name] > 0:
            raise AssertionError(f"{tag} launched no {name} kernel: {launches}")
    if plans != [1] * ADMM_ROUNDS:
        raise AssertionError(f"{tag}: LaminoPlans built per call {plans}, expected 1 each")
    for other in runs[1:]:
        same = (
            np.array_equal(other["obj"], obj)
            and other["costs"] == costs
            and all(
                np.array_equal(a.psi, b.psi) and np.array_equal(a.probe, b.probe)
                for a, b in zip(other["parameters"], runs[0]["parameters"])
            )
        )
        if not same:
            raise AssertionError(
                f"{tag}: two runs from one start differ (volume by "
                f"{_max_rel(other['obj'], obj):.3e})"
            )
    per_iter = [sec / ADMM_TIMED for sec in seconds]
    log(f"[{tag}] {ADMM_TIMED} iterations (ptycho_iter 2, lamino_iter 2, upsample 2) in "
        f"{seconds[0]:.3f} s = {per_iter[0]:.4f} s/iteration; s/iteration of {ADMM_ROUNDS} runs "
        f"{[round(x, 5) for x in per_iter]}, median {statistics.median(per_iter):.5f}; the "
        f"warm-up call (1 iteration) {first_s:.3f} s, so set-up {first_s - per_iter[0]:.3f} s "
        f"({card})")
    log(f"[{tag}] peak device memory {peak} bytes ({peak / 2**30:.3f} GiB); kernel launches of "
        f"the first timed run {launches}; LaminoPlans built per call {plans}; the "
        f"{ADMM_ROUNDS} runs from one start: volumes, psi, probes and costs bitwise equal ({card})")
    return launches


def stream_problem(n_patterns, det, hw, num_batch):
    """bench_all.py's stream_1m inputs (seed 0): uniform scan positions on
    an hw^2 object, a Gaussian probe with a phase, a constant object, and
    uniform random patterns. The patterns are a CPU float32 tensor (made by
    PyTorch's generator: 16 GB of them take numpy several times as long);
    the probe is rescaled from the data at set-up, which streams it once
    more than bench_all.py's run does."""
    rng = np.random.default_rng(0)
    scan = np.stack(
        [rng.uniform(2, hw - det - 3, n_patterns), rng.uniform(2, hw - det - 3, n_patterns)],
        -1,
    ).astype(np.float32)
    probe = (tp.gaussian(det) * np.exp(1j * 0.1 * tp.gaussian(det)))[None, None, None].astype(
        np.complex64
    )
    data = torch.rand(
        (n_patterns, det, det), dtype=torch.float32, generator=torch.Generator().manual_seed(0)
    )
    psi = np.full((1, hw, hw), 0.5 + 0j, np.complex64)
    params = lambda **algo: tp.PtychoParameters(
        probe=probe.copy(),
        psi=psi,
        scan=scan,
        algorithm_options=tp.RpieOptions(
            num_batch=num_batch, num_iter=1, batch_method="random", **algo
        ),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(init_rescale_from_measurements=True),
    )
    return data, params


def phase_stream(device, card: str) -> dict:
    """15: bench_all.py's stream_1m, one epoch after set-up."""
    tag = "stream"
    cfg = dict(STREAM)
    while True:
        start = time.perf_counter()
        data, params = stream_problem(**cfg)
        made_s = time.perf_counter() - start
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        context = tp.Reconstruction(
            data, params(), device=device, random_seed=0, store_data_on_device=False
        )
        start = time.perf_counter()
        try:
            context.__enter__()
        except MemoryError as error:
            # Never pageable copies: a smaller size, and said so.
            log(f"[{tag}] this host cannot pin {cfg['n_patterns']} patterns ({error}); halving")
            del data, context
            cfg["n_patterns"] //= 2
            if cfg["n_patterns"] < cfg["num_batch"]:
                raise
            continue
        break
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start
    n = cfg["n_patterns"]
    host = context.data.host
    if host.is_cuda or not host.is_pinned():
        raise AssertionError(f"{tag}: the streamed data is not in pinned host memory")
    cut = "" if n == STREAM["n_patterns"] else f" (CUT from {STREAM['n_patterns']}: pinning failed)"
    log(f"[{tag}] {n} x {cfg['det']}^2 float32 patterns{cut} = {host.numel() * 4} bytes pinned on "
        f"the host as {tuple(host.shape)}; object {cfg['hw']}^2; made in {made_s:.2f} s; "
        f"Reconstruction entered in {setup_s:.2f} s: clustering "
        f"{context.setup_seconds['clustering']:.2f} s, pinning and filling "
        f"{context.setup_seconds['data']:.2f} s, streamed probe rescale "
        f"{context.setup_seconds['rescale']:.2f} s ({card})")
    context.data.stats()
    context.data.timing = True
    _reset_launches()
    start = time.perf_counter()
    context.iterate(1)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - start
    launches = _read_launches(tag)
    stats = context.data.stats()
    # A second epoch, which finds the allocator's blocks and cuFFT's plans
    # in place (bench_all.py times the first alone).
    start = time.perf_counter()
    context.iterate(1)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - start
    stats2 = context.data.stats()
    peak = torch.cuda.max_memory_allocated()
    cost, cost2 = (c[0] for c in context.get_convergence()[0])
    psi = context.get_psi()
    context.__exit__(None, None, None)
    if not np.all(np.isfinite([cost, cost2])) or not np.all(np.isfinite(psi)):
        raise AssertionError(f"{tag}: costs {cost}, {cost2} or psi are not finite")
    for name in patch.LAUNCHES:
        if not launches[name] > 0:
            raise AssertionError(f"{tag} launched no {name} kernel: {launches}")
    if stats["copies"] != cfg["num_batch"]:
        raise AssertionError(f"{tag}: {stats['copies']} copies for {cfg['num_batch']} batches")
    log(f"[{tag}] one epoch of {cfg['num_batch']} batches in {epoch_s:.3f} s = "
        f"{n / epoch_s:.1f} patterns/s; cost {cost}; kernel launches {launches} ({card})")
    rate = stats["bytes"] / (1e-3 * stats["copy_ms"]) / 1e9
    log(f"[{tag}] overlap: copy stream busy {stats['copy_ms']:.1f} ms for {stats['bytes']} bytes "
        f"in {stats['copies']} copies ({rate:.2f} GB/s), {100 * stats['copy_ms'] / (1e3 * epoch_s):.1f}% "
        f"of the epoch; compute stream waited {stats['wait_ms']:.1f} ms for copies, "
        f"{100 * stats['wait_ms'] / (1e3 * epoch_s):.1f}% of the epoch ({card})")
    log(f"[{tag}] second epoch {second_s:.3f} s = {n / second_s:.1f} patterns/s; cost {cost2}; copy stream busy "
        f"{stats2['copy_ms']:.1f} ms, compute stream waited {stats2['wait_ms']:.1f} ms ({card})")
    log(f"[{tag}] peak device memory {peak} bytes ({peak / 1e9:.3f} GB, limit "
        f"{STREAM_PEAK_LIMIT / 1e9:g} GB; the data is {host.numel() * 4 / 1e9:.1f} GB) ({card})")
    if not peak < STREAM_PEAK_LIMIT:
        raise AssertionError(f"{tag}: peak device memory {peak} bytes exceeds the limit")
    del data, context, host
    return launches


def phase_stream_compare(device, card: str) -> None:
    """bench_all.py's comparison at 100,000 patterns: the same problem
    resident and streamed, one warm-up epoch and two timed ones each. Both
    take the per-epoch path (the resident run through a finite
    ``time_limit``), so the two run the same kernels in the same order and
    their results must agree bit for bit. The resident run of the fused
    path, what a user gets by default, is timed beside them."""
    tag = "stream-compare"
    data, params = stream_problem(**STREAM_COMPARE)
    runs = {
        "resident": dict(store=True, algo=dict(time_limit=1e6)),
        "streamed": dict(store=False, algo={}),
        "resident, fused path": dict(store=True, algo={}),
    }
    out = {name: [] for name in runs}
    for name in (*runs, *reversed(runs)):
        with tp.Reconstruction(
            data, params(**runs[name]["algo"]), device=device, random_seed=0,
            store_data_on_device=runs[name]["store"],
        ) as context:
            context.iterate(1)
            torch.cuda.synchronize()
            start = time.perf_counter()
            context.iterate(2)
            torch.cuda.synchronize()
            seconds = (time.perf_counter() - start) / 2
            out[name].append((seconds, context.get_psi()))
    n = STREAM_COMPARE["n_patterns"]
    for name, results in out.items():
        times = [round(s, 5) for s, _ in results]
        log(f"[{tag}] {name}: {times} s/epoch (two runs), "
            f"{n / min(times):.1f} patterns/s at best ({card})")
        if not np.array_equal(results[0][1], results[1][1]):
            raise AssertionError(f"{tag}: two {name} runs differ")
    psi_r, psi_s = out["resident"][0][1], out["streamed"][0][1]
    if not np.array_equal(psi_r, psi_s):
        raise AssertionError(
            f"{tag}: streamed psi differs from resident by {_max_rel(psi_s, psi_r):.3e}: "
            "the copy stream and the compute stream race"
        )
    log(f"[{tag}] 3 epochs at {n} patterns, {STREAM_COMPARE['num_batch']} batches: streamed and "
        f"resident psi (both on the per-epoch path) bitwise equal; each run twice, bitwise "
        f"equal; the fused resident run differs from them by "
        f"{_max_rel(out['resident, fused path'][0][1], psi_r):.2e}")


def main() -> None:
    env = phase_environment()
    device = torch.device("cuda", 0)
    card = env["nvidia_smi"]
    parent_form = phase_build()
    timings = phase_kernel_parity(device, card)
    path_shape_timings = phase_path_shapes(device, card)
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
    probe_launches, probe_timings = phase_probes(device, card, parent_form)
    phase_stream_slices(device)
    phase_stopping_slices(device)
    phase_admm_slice(device)
    launches_admm = phase_admm(device, card)
    launches_stream = phase_stream(device, card)
    phase_stream_compare(device, card)
    admm_shape, stream_shape = list(cases.PATH_SHAPES)
    report = [
        {
            "name": name,
            "route": "cuda",
            "source": "tike_tpu_torch/csrc/patch.cu",
            "replaces": KERNELS[name],
            "launches": launches[name],
            "launches_config2": launches2[name],
            "launches_rpie": launches3[name],
            "launches_admm": launches_admm[name],
            "launches_stream": launches_stream[name],
            "ms_admm_shape": path_shape_timings[admm_shape][name]["ms"],
            "bound_ms_admm_shape": path_shape_timings[admm_shape][name]["bound_ms"],
            "ms_stream_batch": path_shape_timings[stream_shape][name]["ms"],
            "bound_ms_stream_batch": path_shape_timings[stream_shape][name]["bound_ms"],
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
            "launches_admm": launches_admm[name],
            "launches_stream": launches_stream[name],
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
            "launches_admm": launches_admm[f"probe_{name}"],
            "launches_stream": launches_stream[f"probe_{name}"],
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
