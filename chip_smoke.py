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
   positions;
5. small slice: a 3-epoch LSQML reconstruction on the card against the
   port's plain-PyTorch path on the CPU, on the same seeded input;
6. main path: 10,000 simulated 128^2 patterns of a 1500^2 object, LSQML
   with compact batching (num_batch=10), ``iterate(1)`` then a timed
   ``iterate(3)``; costs must be finite and decreasing, and both patch
   kernels must have been launched by it.

The line before the last lists each kernel (its launches in phase 6, its
error against the plain version and both times); the last line is
``{"ok": true, "device": {...}}``.
"""

import importlib.metadata
import json
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


def simulate_numpy(det, probe, scan, psi):
    """Numpy forward model: bilinear patch, probe product, zero-pad, ortho
    FFT, intensity summed over probe modes (bench.py's _simulate_numpy)."""
    p = probe.shape[-1]
    probe2d = probe[0, 0]
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
    near = pats[:, None] * probe2d[None]
    pad = (det - p) // 2
    if pad or det != p:
        near = np.pad(near, ((0, 0), (0, 0), (pad, det - p - pad), (pad, det - p - pad)))
    far = np.fft.fft2(near, norm="ortho")
    return np.sum(np.abs(far) ** 2, axis=1).astype(np.float32)


def phase_forward_model(device, scan, psi, probe, n=256) -> None:
    got = tp.simulate(DET, probe, scan[:n], psi, device=device)
    torch.cuda.synchronize()
    want = simulate_numpy(DET, probe, scan[:n], psi)
    atol = SIM_ATOL * float(np.max(want))
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=SIM_RTOL, atol=atol)
    err = float(np.max(np.abs(got.cpu().numpy() - want)))
    log(f"[forward] simulate {n}x{DET}^2 on {device} vs numpy: max|err| "
        f"{err:.3e} (rtol {SIM_RTOL:g}, atol {atol:.3e})")


def _small_slice_parameters(scan, probe, psi0, det):
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
    )


def phase_small_slice(device) -> None:
    """3 LSQML epochs at 160^2 / P=16 / 24^2 detector, card vs CPU."""
    gen = np.random.default_rng(1)
    h, p, det, n = 160, 16, 24, 120
    scan = gen.uniform(2, h - p - 3, (n, 2)).astype(np.float32)
    _, psi, _ = make_inputs(1, probe_shape=p, hw=h)
    amp = tp.gaussian(p)
    probe = (amp * np.exp(1j * gen.uniform(-np.pi, np.pi, (p, p))))[
        None, None, None
    ].astype(np.complex64)
    psi0 = (
        0.5
        + 0.05 * (gen.standard_normal(psi.shape) + 1j * gen.standard_normal(psi.shape))
    ).astype(np.complex64)
    data = tp.simulate(det, probe, scan, psi, device="cpu").numpy()
    results = {}
    for dev in ("cpu", device):
        params = _small_slice_parameters(scan, probe, psi0, det)
        with tp.Reconstruction(data, params, device=dev, random_seed=0) as context:
            context.iterate(3)
            results[str(dev)] = context.get_result()
    ref, got = results["cpu"], results[str(device)]
    c_ref = np.asarray(ref.algorithm_options.costs)
    c_got = np.asarray(got.algorithm_options.costs)
    np.testing.assert_allclose(c_got, c_ref, rtol=SLICE_TOL)
    for key in ("psi", "probe"):
        a, b = getattr(got, key), getattr(ref, key)
        np.testing.assert_allclose(a, b, rtol=SLICE_TOL, atol=SLICE_TOL * np.abs(b).max())
    log(f"[slice] 3 epochs {n}x{det}^2 on {device} vs cpu: costs "
        f"{c_got.ravel().tolist()} vs {c_ref.ravel().tolist()} (rtol {SLICE_TOL:g})")


def phase_main_path(device, scan, psi, probe, card: str) -> dict:
    start = time.perf_counter()
    data = tp.simulate(DET, probe, scan, psi, device=device)
    torch.cuda.synchronize()
    log(f"[main] simulated {tuple(data.shape)} {data.dtype} on {device} in "
        f"{time.perf_counter() - start:.2f} s")
    if not bool(torch.isfinite(data).all()):
        raise AssertionError("simulated data is not finite")
    params = tp.PtychoParameters(
        probe=probe,
        psi=np.full_like(psi, 0.5),
        scan=scan,
        algorithm_options=tp.LstsqOptions(
            num_batch=NUM_BATCH, num_iter=1, batch_method="compact"
        ),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
    )

    for name in patch.LAUNCHES:
        patch.LAUNCHES[name] = 0
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    context = tp.Reconstruction(data, params, device=device, random_seed=0)
    context.__enter__()
    torch.cuda.synchronize()
    log(f"[main] Reconstruction entered in {time.perf_counter() - start:.2f} s "
        f"(compact batches {context.batches[0].shape}, fft_precond "
        f"{bool(context._make_plan().fft_precond)})")
    before = dict(patch.LAUNCHES)
    start = time.perf_counter()
    context.iterate(1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - start
    start = time.perf_counter()
    context.iterate(3)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - start
    launches = dict(patch.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    costs = [c[0] for c in context.get_convergence()[0]]
    result = context.get_result()
    context.__exit__(None, None, None)
    log(f"[main] per-epoch costs {costs}")
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
    log(f"[main] iterate(1) {first_s:.3f} s; iterate(3) {timed_s:.3f} s = "
        f"{per_epoch:.4f} s/epoch, {N_PATTERNS / per_epoch:.1f} patterns/s "
        f"({card})")
    log(f"[main] peak device memory {peak} bytes ({peak / 2**30:.3f} GiB) ({card})")
    log(f"[main] kernel launches {launches} (iterate alone: "
        f"{ {k: launches[k] - before[k] for k in launches} })")
    return launches


def main() -> None:
    env = phase_environment()
    device = torch.device("cuda", 0)
    phase_build()
    timings = phase_kernel_parity(device)
    scan, psi, probe = make_inputs(N_PATTERNS)
    phase_forward_model(device, scan, psi, probe)
    phase_small_slice(device)
    launches = phase_main_path(device, scan, psi, probe, env["nvidia_smi"])
    report = [
        {
            "name": name,
            "route": "cuda",
            "source": "tike_tpu_torch/csrc/patch.cu",
            "replaces": KERNELS[name],
            "launches": launches[name],
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
