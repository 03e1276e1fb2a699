#!/usr/bin/env python
"""The pattern axis beyond one card: 1M diffraction patterns streamed from
the host.

The port's counterpart of ``scripts/longaxis_demo.py``, with its own copy
of ``bench_all.py``'s ``stream_1m`` problem: 1,000,000 random 64^2
patterns (16.4 GB of float32) in pinned host memory, a 4096^2 object,
rPIE with 100 random batches, one epoch. With
``store_data_on_device=False`` the card holds two batches and the model:
batch k+1 is copied on a copy stream while batch k computes.

Usage:

    python scripts/torch/longaxis_demo.py [n_patterns] [det] [--report PATH] [--device cpu]

Prints one JSON line with the patterns/s, the host data size and the peak
memory; ``--report PATH`` also writes them as markdown to PATH.
"""

import argparse
import json
import os
import resource
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import tike_tpu_torch.ptycho as tp  # noqa: E402
from tike_tpu_torch.precision import checked_device  # noqa: E402

HW, NUM_BATCH = 4096, 100


def problem(n_patterns=1_000_000, det=64, hw=HW, num_batch=NUM_BATCH):
    """``(data, parameters)`` of ``bench_all.py``'s ``stream_1m``: random
    float32 patterns (a throughput and memory problem: plausible data
    suffices), uniform positions over an ``hw``^2 object of 0.5, a
    Gaussian probe with a 0.1 rad phase, rPIE with ``num_batch`` random
    batches (clustering is O(N num_batch) on the host; at 1M positions only
    the random partition is affordable) and no initial probe rescale."""
    rng = np.random.default_rng(0)
    scan = np.stack(
        [rng.uniform(2, hw - det - 3, n_patterns), rng.uniform(2, hw - det - 3, n_patterns)], -1
    ).astype(np.float32)
    probe = (tp.gaussian(det) * np.exp(1j * 0.1 * tp.gaussian(det)))[None, None, None].astype(
        np.complex64
    )
    data = rng.random((n_patterns, det, det), np.float32)
    psi = np.full((1, hw, hw), 0.5 + 0j, np.complex64)
    params = tp.PtychoParameters(
        probe=probe,
        psi=psi,
        scan=scan,
        algorithm_options=tp.RpieOptions(num_batch=num_batch, num_iter=1, batch_method="random"),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(init_rescale_from_measurements=False),
    )
    return data, params


def run(n_patterns=1_000_000, det=64, hw=HW, *, store_data_on_device=False, device="cuda"):
    """One timed epoch of the problem (seed 0); returns ``(record,
    result)``. Streamed unless ``store_data_on_device``."""
    device = checked_device(device)  # before the 16 GB host problem
    data, params = problem(n_patterns, det, hw)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with tp.Reconstruction(data, params, store_data_on_device=store_data_on_device,
                           device=device, random_seed=0) as context:
        start = time.perf_counter()
        context.iterate(1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - start
        result = context.get_result()
    costs = [float(np.mean(c)) for c in result.algorithm_options.costs]
    record = {
        "config": "stream_1m",
        "device": str(device),
        "streamed": not store_data_on_device,
        "patterns": n_patterns,
        "detector": det,
        "object": hw,
        "patterns_per_s": round(n_patterns / elapsed, 1),
        "epoch_s": round(elapsed, 4),
        "host_data_gb": round(data.nbytes / 2**30, 3),
        "peak_rss_gb": round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20, 3),
        "peak_device_gb": (round(torch.cuda.max_memory_allocated(device) / 2**30, 3)
                           if device.type == "cuda" else None),
        "costs": costs,
    }
    return record, result


def report(record) -> str:
    """The markdown report of one run."""
    n = record["patterns"]
    return (
        "# Long-axis (host-streaming) demo\n\n"
        "`bench_all.py`'s `stream_1m` on one device: the diffraction data in pinned "
        "host memory, each batch copied on a copy stream while the one before "
        "computes (`tike_tpu_torch/ptycho/stream.py`).\n\n"
        f"- device: {record['device']}\n"
        f"- patterns: {n:,} x {record['detector']}x{record['detector']} f32 "
        f"({record['host_data_gb']} GB host data), a {record['object']}^2 object\n"
        f"- rPIE epoch: {record['epoch_s']} s -> {record['patterns_per_s']:,} patterns/s\n"
        f"- peak host RSS: {record['peak_rss_gb']} GB; peak device memory: "
        f"{record['peak_device_gb'] or 'not measured'} GB (two {n // NUM_BATCH:,}-pattern "
        "batches and the model)\n"
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_patterns", nargs="?", type=int, default=1_000_000)
    parser.add_argument("det", nargs="?", type=int, default=64)
    parser.add_argument("--report", default=None, help="write a markdown report to this path")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    record, _ = run(args.n_patterns, args.det, device=args.device)
    print(json.dumps(record), flush=True)
    if args.report is not None:
        with open(args.report, "w") as f:
            f.write(report(record))
    return record


if __name__ == "__main__":
    main()
