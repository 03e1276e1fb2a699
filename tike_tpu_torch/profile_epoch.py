"""Profile a path of the port on one CUDA card: where an epoch's time goes.

Run from the root of a checkout, on a machine with one CUDA card:

    python -m tike_tpu_torch.profile_epoch [--config CONFIG] [--trace PATH]

It builds a path of ``chip_smoke.py`` (10,000 simulated 128^2 patterns of
a 1500^2 object, ``random_seed=0``): by default the main path (LSQML, one
probe mode, ``num_batch=10``, compact batches); with ``--config config2``
BASELINE config 2 (the same with 3 probe modes, one eigen probe with
per-position weights, position correction); with ``--config rpie``
phase 8's rPIE (3 probe modes, ``num_batch=5`` wobbly-center batches,
probe orthogonalization and centering, object and probe AdaM, magnitude
clipping). Then it

1. times ``iterate(3)`` once with each psi preconditioner formulation
   (FFT and gather), after one warm-up epoch each;
2. traces one epoch with ``torch.profiler`` and prints the device time,
   launch count and share of each kernel class, the device's busy and idle
   share of the epoch's wall time, the port's spans (``tike.*``,
   :mod:`tike_tpu_torch.trace`: the call, the epoch, its beginning, its
   batches and its end, the host reads, the affine position fit) with their
   calls, host milliseconds and the device milliseconds that
   ``key_averages()`` puts on each (the kernels launched inside, and the
   span's range on the device's timeline), and the profiler's table of
   operators.

With ``--config lamino_cgrad`` or ``lamino_cgls`` it builds
``chip_smoke.py``'s laminography path instead (``bench_all.py``'s 128^3
volume, 64 angles, upsample 1, ``cg_iter=4``), runs two outer iterations
of the solver on device tensors and traces the third the same way.

With ``--config bucket`` it builds ``chip_smoke.py``'s Bucket laminography
path (phase 16: the 128^3 volume, 64 angles, tilt pi/3, eps 1e-1 so
precision 3, ``cg_iter=4``), runs two outer iterations of the solver on
device tensors and traces the third.

With ``--config admm`` it builds ``chip_smoke.py``'s joint-ADMM problem
(``bench_all.py``'s ``admm_joint``: n = 64, 8 angles, 200 positions each),
runs one ADMM iteration to warm up and traces the next. With ``--config
stream`` it builds the host-streamed comparison problem (100,000 patterns
of 64^2 in pinned host memory, a 4096^2 object, rPIE, 10 random batches),
runs one epoch and traces the next; the copies from the host (the
streamed batches, on the copy stream) are a class of their own, and the copy stream's busy time and the compute stream's wait
on it are printed beside the table. With ``--config align`` it makes
``chip_smoke.py`` phase 19c's stack (128 projections of 1024^2 complex64
on the card, a smooth flow, shifts of up to 8 px, a 0.05 rad rotation),
calls ``align.simulate`` once to warm up and traces the next call, numpy
out. Every configuration also prints the device time of the copies to the
host (memcpy DtoH), which the table counts with memsets and copies.

The chrome trace goes to PATH (by default
``tike_tpu_torch/_build/epoch_trace_<config>.json``, which git ignores). Every time printed stands beside the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time

import numpy as np
import torch
from torch.autograd import DeviceType

# Kernel classes, tried in order on the lower-cased kernel name.
CLASSES = (
    ("kb_gather_kernel (ours)", ("kb_gather_kernel",)),
    ("kb_scatter_kernel (ours)", ("kb_scatter_kernel",)),
    ("patch_fwd_kernel (ours)", ("patch_fwd_kernel",)),
    ("patch_adj_kernel (ours)", ("patch_adj_kernel",)),
    ("bucket_fwd_kernel (ours)", ("bucket_fwd",)),
    ("bucket_adj_kernel (ours)", ("bucket_adj",)),
    ("lanczos_fwd_kernel (ours)", ("lanczos_fwd",)),
    ("lanczos_adj_kernel (ours)", ("lanczos_adj",)),
    ("copies from the host (memcpy HtoD)", ("memcpy htod",)),
    ("cuFFT", ("fft",)),
    ("sort, index, cat, memset, memcpy", ("sort", "index", "cat", "memset", "memcpy")),
    ("reductions (sum, mean, amax)", ("reduce_kernel",)),
    ("elementwise (mul, copy, add, where, sqrt, abs, ...)", ("",)),
)


def kernel_class(name: str) -> str:
    name = name.lower()
    return next(c for c, keys in CLASSES if any(k in name for k in keys))


def device_breakdown(trace_events: list, wall_us: float) -> dict:
    """Per-class device time and launches, and the busy share of ``wall_us``,
    from chrome-trace events (kernels, memsets and memcpys)."""
    acts = [
        e
        for e in trace_events
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")
    ]
    by_class = collections.defaultdict(lambda: [0.0, 0])
    spans = []
    for e in acts:
        c = by_class[kernel_class(e["cat"] + " " + e["name"])]
        c[0] += e["dur"]
        c[1] += 1
        spans.append((e["ts"], e["ts"] + e["dur"]))
    busy, end = 0.0, -np.inf
    for lo, hi in sorted(spans):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return {"activities": len(acts), "busy_us": busy, "wall_us": wall_us, "classes": dict(by_class)}


def span_rows(averages) -> list:
    """The port's spans among ``key_averages()``, one row a span name, the
    longest on the host first: (name, calls, host ms, device ms of the
    kernels launched inside, device ms of its range on the device's
    timeline). The last is the profiler's ``gpu_user_annotation`` of the
    span, from the first of its kernels to the last, idle included (0
    where the profiler makes none)."""
    rows = collections.defaultdict(lambda: [0, 0.0, 0.0, 0.0])
    for a in averages:
        if not a.key.startswith("tike."):
            continue
        row = rows[a.key]
        if a.device_type == DeviceType.CPU:
            row[0] += a.count
            row[1] += a.cpu_time_total / 1e3
            row[2] += a.device_time_total / 1e3
        else:
            row[3] += a.device_time_total / 1e3
    return sorted(((k, *v) for k, v in rows.items()), key=lambda r: -r[2])


def parse_args(argv=None) -> argparse.Namespace:
    """The command line; ``trace`` defaults to a file named after the
    configuration."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--config",
        choices=(
            "main", "config2", "rpie", "lamino_cgrad", "lamino_cgls", "bucket", "admm", "stream",
            "align",
        ),
        default="main",
        help="the main path (one probe mode), BASELINE config 2, rPIE, "
        "laminography with cgrad, CGLS or the Bucket operator, joint ADMM, a "
        "host-streamed epoch, or one align.simulate",
    )
    parser.add_argument(
        "--trace",
        default=None,
        help="where to write the chrome trace",
    )
    args = parser.parse_args(argv)
    if args.trace is None:
        args.trace = os.path.join(
            os.path.dirname(__file__), "_build", f"epoch_trace_{args.config}.json"
        )
    return args


def _profile_ptycho(cs, config, card, device):
    """Time both psi preconditioners, then trace one epoch of a ptycho
    path; returns (profiler, wall seconds, what to close)."""
    import tike_tpu_torch.ptycho as tp
    from tike_tpu_torch.ptycho.solvers import _preconditioner
    from torch.profiler import ProfilerActivity, profile

    scan, psi, probe = cs.make_inputs(cs.N_PATTERNS)
    if config == "rpie":
        probe = cs.rpie_probe(probe)
        params = cs.rpie_parameters(scan, psi, probe)
    else:
        config2 = config == "config2"
        if config2:
            probe = tp.add_modes_cartesian_hermite(probe, cs.MODES)
        params = cs.path_parameters(scan, psi, probe, config2)
    data = tp.simulate_device(cs.DET, probe, scan, psi, device=device)
    context = tp.Reconstruction(data, params, device=device, random_seed=0)
    context.__enter__()
    chosen = _preconditioner.fft_precond_profitable
    print(f"fft_precond_profitable picks FFT: {context._make_plan().fft_precond}")
    for fft in (True, False):
        _preconditioner.fft_precond_profitable = lambda **_: fft
        context.iterate(1)
        torch.cuda.synchronize()
        start = time.perf_counter()
        context.iterate(3)
        torch.cuda.synchronize()
        seconds = (time.perf_counter() - start) / 3
        print(f"psi preconditioner {'FFT' if fft else 'gather'}: {seconds:.4f} s/epoch ({card})")
    _preconditioner.fft_precond_profitable = chosen

    context.iterate(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        context.iterate(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    return prof, wall, lambda: context.__exit__(None, None, None)


def _profile_lamino(cs, config, card, device):
    """Trace the third outer iteration of a laminography solver on device
    tensors (the first two, which estimate the step from a zero and then a
    first volume, warm up); returns (profiler, wall seconds, what to
    close). The solver gets one ``LaminoPlan`` for every iteration, as
    ``reconstruct`` gives it; ``reconstruct``'s own uploads and download
    are left out."""
    from tike_tpu_torch.lamino import solvers
    from tike_tpu_torch.ops.lamino import LaminoConfig, LaminoPlan
    from tike_tpu_torch.precision import as_tensor
    from torch.profiler import ProfilerActivity, profile

    solver = getattr(solvers, config.split("_")[1])
    _, theta, data = cs.lamino_problem(device)
    lam = cs.cases_usfft
    cfg = LaminoConfig(n=lam.LAMINO_N, tilt=float(lam.LAMINO_TILT), eps=lam.LAMINO_EPS, upsample=1)
    data = as_tensor(data, torch.complex64, device)
    theta = as_tensor(theta, torch.float32, device)
    plan = LaminoPlan(cfg, theta)
    result = {"obj": torch.zeros((cfg.n,) * 3, dtype=torch.complex64, device=device)}
    for _ in range(2):
        result = solver(cfg, data, theta, cg_iter=cs.LAMINO_CG_ITER, plan=plan, **result)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        solver(cfg, data, theta, cg_iter=cs.LAMINO_CG_ITER, plan=plan, **result)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    return prof, wall, lambda: None


def _profile_bucket(cs, config, card, device):
    """Trace the third outer iteration of the Bucket solver on device
    tensors (the first two, which estimate the step from a zero and then a
    first volume, warm up), with one angle table for every projection as
    ``bucket.reconstruct`` keeps it; returns (profiler, wall seconds, what
    to close)."""
    from tike_tpu_torch.lamino.solvers import bucket as solver
    from tike_tpu_torch.ops import bucket
    from torch.profiler import ProfilerActivity, profile

    c = cs.cases_bucket.FULL
    cfg = bucket.BucketConfig.from_eps(c["n"], c["tilt"], c["eps"])
    theta = cs.cases_usfft.lamino_theta(c["ntheta"], device)
    trig = bucket.bucket_trig(cfg, theta)
    volume = torch.as_tensor(cs.lamino_volume(c["n"]), device=device)
    data = bucket.bucket_fwd(cfg, volume, theta, trig=trig)
    result = {"obj": torch.zeros_like(volume)}
    for _ in range(2):
        result = solver(cfg, data, theta, cg_iter=c["cg_iter"], trig=trig, **result)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        solver(cfg, data, theta, cg_iter=c["cg_iter"], trig=trig, **result)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    return prof, wall, lambda: None


def _profile_admm(cs, config, card, device):
    """Trace one joint-ADMM iteration (8 angles of rPIE, the blend, the
    volume fit, the re-projection and the dual step) after one that warms
    up; returns (profiler, wall seconds, what to close)."""
    from torch.profiler import ProfilerActivity, profile

    data, parameters, theta = cs.admm_problem(device, **cs.ADMM)
    warm = cs._admm(data, parameters(), theta, device, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        cs._admm(data, warm["parameters"], theta, device, 1, obj=warm["obj"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    return prof, wall, lambda: None


def _profile_stream(cs, config, card, device):
    """Trace one host-streamed rPIE epoch at ``chip_smoke.py``'s comparison
    size after one that warms up, with the overlap statistics of the traced
    epoch; returns (profiler, wall seconds, what to close)."""
    import tike_tpu_torch.ptycho as tp
    from torch.profiler import ProfilerActivity, profile

    data, params = cs.stream_problem(**cs.STREAM_COMPARE)
    context = tp.Reconstruction(
        data, params(), device=device, random_seed=0, store_data_on_device=False
    )
    context.__enter__()
    context.iterate(1)
    context.data.stats()
    context.data.timing = True
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        context.iterate(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    stats = context.data.stats()
    print(
        f"streamed epoch of {stats['copies']} batches: wall {wall * 1e3:.2f} ms; copy stream "
        f"busy {stats['copy_ms']:.2f} ms for {stats['bytes']} bytes "
        f"({stats['bytes'] / (1e-3 * stats['copy_ms']) / 1e9:.2f} GB/s); compute stream "
        f"waited {stats['wait_ms']:.2f} ms for copies ({card})"
    )
    return prof, wall, lambda: context.__exit__(None, None, None)


def _profile_align(cs, config, card, device):
    """Trace one ``align.simulate`` of phase 19c's stack (flow, shifts and
    rotation; numpy out) after one that warms up; returns (profiler, wall
    seconds, what to close)."""
    from tike_tpu_torch import align
    from torch.profiler import ProfilerActivity, profile

    gen = np.random.default_rng(0)
    stack = cs.align_stack(device, cs.ALIGN_IMAGES, cs.ALIGN_N)
    flow = cs.cases_interp.smooth_flow(gen, cs.ALIGN_IMAGES, cs.ALIGN_N, device)
    shifts = gen.uniform(-cs.ALIGN_SHIFT, cs.ALIGN_SHIFT, (cs.ALIGN_IMAGES, 2)).astype(np.float32)
    kw = dict(shift=shifts, flow=flow, angle=cs.ALIGN_ANGLE, padded_shape=None, device=device)
    align.simulate(stack, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        align.simulate(stack, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    return prof, wall, lambda: None


def main() -> None:
    import chip_smoke as cs

    args = parse_args()
    trace = args.trace

    card = cs.nvidia_smi_line()
    print("card:", card, "config:", args.config)
    device = torch.device("cuda", 0)
    profilers = {"admm": _profile_admm, "bucket": _profile_bucket, "stream": _profile_stream,
                 "align": _profile_align}
    profiler = profilers.get(
        args.config, _profile_lamino if args.config.startswith("lamino") else _profile_ptycho
    )
    prof, wall, close = profiler(cs, args.config, card, device)
    os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    b = device_breakdown(events, wall * 1e6)
    device_us = sum(v[0] for v in b["classes"].values())
    print(
        f"profiled {'epoch' if profiler in (_profile_ptycho, _profile_stream) else 'call' if profiler is _profile_align else 'iteration'}: "
        f"wall {wall * 1e3:.2f} ms, device busy "
        f"{b['busy_us'] / 1e3:.2f} ms ({100 * b['busy_us'] / b['wall_us']:.1f}%), "
        f"idle {100 * (1 - b['busy_us'] / b['wall_us']):.1f}%, "
        f"{b['activities']} device activities ({card})"
    )
    to_host = [e["dur"] for e in events if e.get("ph") == "X" and e.get("cat") == "gpu_memcpy"
               and "dtoh" in e["name"].lower()]
    print(f"copies to the host (memcpy DtoH): {sum(to_host) / 1e3:.3f} ms in {len(to_host)} "
          f"({100 * sum(to_host) / max(device_us, 1e-9):.1f}% of device time; {card})")
    print("| Kernel class | Device ms | Launches | Share of device time |")
    print("|---|---|---|---|")
    for name, (us, n) in sorted(b["classes"].items(), key=lambda kv: -kv[1][0]):
        print(f"| {name} | {us / 1e3:.3f} | {n} | {100 * us / device_us:.1f}% |")
    averages = prof.key_averages()
    spans = span_rows(averages)
    if spans:
        print(f"| Span | Calls | Host ms | Device ms, its kernels | Device ms, its range ({card}) |")
        print("|---|---|---|---|---|")
        for name, calls, host_ms, kernels_ms, range_ms in spans:
            print(f"| {name} | {calls} | {host_ms:.3f} | {kernels_ms:.3f} | {range_ms:.3f} |")
    key = (
        "self_device_time_total"
        if hasattr(averages[0], "self_device_time_total")
        else "self_cuda_time_total"
    )
    print(averages.table(sort_by=key, row_limit=25, max_name_column_width=60))
    close()


if __name__ == "__main__":
    main()
