"""Build variants of ``csrc/usfft.cu`` and time them beside the source as
it stands, on one CUDA card.

A development tool for the KB kernels: each variant is the source with a
few text substitutions (a tuning constant, a load instruction, a loop),
built by its own ``nvcc`` (all started together, a few seconds), held to
the plain PyTorch versions, launched twice for a bitwise comparison, and
timed in a CUDA graph at laminography's shapes (128^3 / 64 angles at
upsample 1 and 2, 256^3 / 128 angles). Then the gather of the source as it
stands is timed on plans sorted by tiles of several sizes. Run from the
root of a checkout:

    python -m tike_tpu_torch.kernel_sweep [--variants FILE]

``FILE`` holds a Python literal ``{name: [(old, new), ...]}``; every ``old``
must occur in the source. Without it the variants of ``VARIANTS`` run: the
choices the source's header comment reports as measured. A variant that
computes something else (``values_sorted`` reads the values as if a first
pass had sorted them) shows its error and is there for its time alone.
"""

from __future__ import annotations

import argparse
import ast
import ctypes
import os
import statistics
import subprocess
import tempfile

import torch

from . import kernels
from .ops import usfft

SOURCE = os.path.join(kernels.CSRC, "usfft.cu")

VARIANTS = {
    "as it stands": [],
    # An upper bound for a first pass that permutes the values into the
    # plan's order: the scatter reads them as if already sorted.
    "values_sorted": [("c.v = __ldg(values + __ldg(order + c.p));", "c.v = __ldg(values + c.p);")],
    "scatter_warps_2": [("constexpr int kScatterWarps = 4;", "constexpr int kScatterWarps = 2;")],
    "scatter_warps_3": [("constexpr int kScatterWarps = 4;", "constexpr int kScatterWarps = 3;")],
    # Eight copies of a row of kMaxN cells do not fit the 48 KB.
    "scatter_warps_8": [
        ("constexpr int kScatterWarps = 4;", "constexpr int kScatterWarps = 8;"),
        ("constexpr int kMaxN = 1290;", "constexpr int kMaxN = 768;"),
    ],
    "gather_threads_128": [
        ("constexpr int kGatherThreads = 256;", "constexpr int kGatherThreads = 128;")
    ],
    # The gather's plan loads and output stores through the ordinary path.
    "gather_not_streaming": [
        ("const int bin = __ldcs(bins + p);", "const int bin = __ldg(bins + p);"),
        ("r0[j] = __ldcs(w0 + j * npoints);", "r0[j] = __ldg(w0 + j * npoints);"),
        ("r1[j] = __ldcs(w1 + j * npoints);", "r1[j] = __ldg(w1 + j * npoints);"),
        ("r2[j] = __ldcs(w2 + j * npoints);", "r2[j] = __ldg(w2 + j * npoints);"),
        ("__stcs(out + __ldcs(order + p), acc);", "out[__ldg(order + p)] = acc;"),
    ],
}

# (volume n, angles, upsample) of the timed cases, and the tiles (cells on
# axes 1 and 2; None: bin order) the gather's plan is sorted by in turn.
CASES = {"128^3 / 64": (128, 64, 1), "upsample 2": (128, 64, 2), "256^3 / 128": (256, 128, 1)}
TILES = (None, (4, 4), (8, 8), (16, 16), (8, 32))


def variant_source(source: str, substitutions) -> str:
    """``source`` with each (old, new) applied; raises if an ``old`` is not
    there, so a variant never silently measures the unchanged source."""
    for old, new in substitutions:
        if old not in source:
            raise ValueError(f"not in the source: {old!r}")
        source = source.replace(old, new)
    return source


def _start_build(tag: str, source: str, directory: str):
    path = os.path.join(directory, f"usfft_{tag}.cu")
    with open(path, "w") as f:
        f.write(source)
    library = os.path.join(directory, f"usfft_{tag}.so")
    process = subprocess.Popen(
        [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o", library, path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return process, library


def _load(library: str):
    lib = ctypes.CDLL(library)
    for name, (argtypes, restype) in kernels.SIGNATURES["usfft"].items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def graph_ms(fn, reps: int = 10, rounds: int = 3) -> float:
    """Median device ms per call of ``fn`` over ``rounds`` replays of a CUDA
    graph that holds it ``reps`` times."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _launchers(lib, grid, f, plan, out, G):
    """(gather, scatter) closures that launch ``lib``'s kernels on a plan."""
    n, m, npoints = plan.n, plan.m, plan.npoints

    def gather():
        rc = lib.tike_kb_gather(
            grid.data_ptr(), plan.bins.data_ptr(), plan.order.data_ptr(),
            plan.weights.data_ptr(), out.data_ptr(), npoints, n, m,
            torch.cuda.current_stream().cuda_stream,
        )
        if rc:
            raise RuntimeError(f"kb_gather: CUDA error {rc}")

    def scatter():
        rc = lib.tike_kb_scatter(
            f.data_ptr(), plan.bins.data_ptr(), plan.order.data_ptr(),
            plan.bin_start.data_ptr(), plan.weights.data_ptr(), G.data_ptr(), npoints, n, m,
            torch.cuda.current_stream().cuda_stream,
        )
        if rc:
            raise RuntimeError(f"kb_scatter: CUDA error {rc}")

    return gather, scatter


def main(argv=None) -> None:
    from tests import _torch_usfft_cases as cases

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", default=None, help="a file holding {name: [(old, new), ...]}")
    args = parser.parse_args(argv)
    variants = VARIANTS
    if args.variants:
        with open(args.variants) as f:
            variants = {"as it stands": [], **ast.literal_eval(f.read())}
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    with open(SOURCE) as f:
        source = f.read()
    device = torch.device("cuda", 0)
    generator = torch.Generator(device=device).manual_seed(0)
    with tempfile.TemporaryDirectory() as directory:
        builds = {
            tag: _start_build(str(i), variant_source(source, subs), directory)
            for i, (tag, subs) in enumerate(variants.items())
        }
        libs = {}
        for tag, (process, library) in builds.items():
            _, err = process.communicate()
            if process.returncode:
                print(f"{tag}: build failed\n{err[-2000:]}")
            else:
                libs[tag] = _load(library)
        for name, (n_volume, ntheta, upsample) in CASES.items():
            n, m, beta = cases.window_for(n_volume, cases.LAMINO_EPS, upsample)
            x = cases.lamino_rows(n_volume, ntheta, device).reshape(-1, 3)
            grid = torch.randn((n, n, n), dtype=torch.complex64, device=device, generator=generator)
            f = torch.randn(x.shape[0], dtype=torch.complex64, device=device, generator=generator)
            want_gather = usfft.gather_kb_plain(grid, x, n, m, beta)
            want_scatter = usfft.scatter_kb_plain(f, x, n, m, beta)
            out, G = torch.empty_like(f), torch.empty_like(grid)
            plan = usfft.kb_plan(x, n, m, beta)
            for tag, lib in libs.items():
                gather, scatter = _launchers(lib, grid, f, plan, out, G)
                scatter_ms, gather_ms = graph_ms(scatter), graph_ms(gather)
                scatter()
                first = G.clone()
                scatter()
                torch.cuda.synchronize()
                same = torch.equal(torch.view_as_real(G), torch.view_as_real(first))
                print(f"{name:12s} {tag:22s} scatter {scatter_ms:.4f} ms (err "
                      f"{cases.max_rel(G, want_scatter):.1e}, two launches bitwise equal: {same})"
                      f"  gather in bin order {gather_ms:.4f} ms (err "
                      f"{cases.max_rel(out, want_gather):.1e})", flush=True)
            for tile in TILES:
                tiled = usfft.kb_plan(x, n, m, beta, tile)
                gather, _ = _launchers(libs["as it stands"], grid, f, tiled, out, G)
                ms = graph_ms(gather)
                order = "bin order" if tile is None else f"tiles of {tile[0]} x {tile[1]}"
                print(f"{name:12s} gather as it stands, plan in {order}: {ms:.4f} ms (err "
                      f"{cases.max_rel(out, want_gather):.1e})", flush=True)


if __name__ == "__main__":
    main()
