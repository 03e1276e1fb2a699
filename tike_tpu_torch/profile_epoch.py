"""Profile a path of the port on one CUDA card: where an epoch's time goes.

Run from the root of a checkout, on a machine with one CUDA card:

    python -m tike_tpu_torch.profile_epoch [--config {main,config2,rpie}] [--trace PATH]

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
   share of the epoch's wall time, and the profiler's table of operators.

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

# Kernel classes, tried in order on the lower-cased kernel name.
CLASSES = (
    ("patch_fwd_kernel (ours)", ("patch_fwd_kernel",)),
    ("patch_adj_kernel (ours)", ("patch_adj_kernel",)),
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


def parse_args(argv=None) -> argparse.Namespace:
    """The command line; ``trace`` defaults to a file named after the
    configuration."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--config",
        choices=("main", "config2", "rpie"),
        default="main",
        help="the main path (one probe mode), BASELINE config 2, or rPIE",
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


def main() -> None:
    import chip_smoke as cs
    import tike_tpu_torch.ptycho as tp
    from tike_tpu_torch.ptycho.solvers import _preconditioner
    from torch.profiler import ProfilerActivity, profile

    args = parse_args()
    trace = args.trace

    card = cs.nvidia_smi_line()
    print("card:", card, "config:", args.config)
    device = torch.device("cuda", 0)
    scan, psi, probe = cs.make_inputs(cs.N_PATTERNS)
    if args.config == "rpie":
        probe = cs.rpie_probe(probe)
        params = cs.rpie_parameters(scan, psi, probe)
    else:
        config2 = args.config == "config2"
        if config2:
            probe = tp.add_modes_cartesian_hermite(probe, cs.MODES)
        params = cs.path_parameters(scan, psi, probe, config2)
    data = tp.simulate(cs.DET, probe, scan, psi, device=device)
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
    os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    b = device_breakdown(events, wall * 1e6)
    device_us = sum(v[0] for v in b["classes"].values())
    print(
        f"profiled epoch: wall {wall * 1e3:.2f} ms, device busy "
        f"{b['busy_us'] / 1e3:.2f} ms ({100 * b['busy_us'] / b['wall_us']:.1f}%), "
        f"idle {100 * (1 - b['busy_us'] / b['wall_us']):.1f}%, "
        f"{b['activities']} device activities ({card})"
    )
    print("| Kernel class | Device ms | Launches | Share of device time |")
    print("|---|---|---|---|")
    for name, (us, n) in sorted(b["classes"].items(), key=lambda kv: -kv[1][0]):
        print(f"| {name} | {us / 1e3:.3f} | {n} | {100 * us / device_us:.1f}% |")
    averages = prof.key_averages()
    key = (
        "self_device_time_total"
        if hasattr(averages[0], "self_device_time_total")
        else "self_cuda_time_total"
    )
    print(averages.table(sort_by=key, row_limit=25, max_name_column_width=60))
    context.__exit__(None, None, None)


if __name__ == "__main__":
    main()
