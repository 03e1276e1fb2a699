"""Build variants of a kernel source and time them beside the source as it
stands, on one CUDA card.

A development tool for the hand-written kernels: each variant is the source
with a few text substitutions (a tuning constant, a load instruction, a
loop), built by its own ``nvcc`` (as many at once as the host has cores, a
few seconds each) and held to the plain PyTorch versions. Run from the root of a checkout:

    python -m tike_tpu_torch.kernel_sweep [--source usfft|probe] [--variants FILE] [--parent FILE]

``--source usfft`` (the default), ``csrc/usfft.cu``: each variant launched
twice for a bitwise comparison and timed in a CUDA graph at laminography's
shapes (128^3 / 64 angles at upsample 1 and 2, 256^3 / 128 angles). Then
the gather of the source as it stands is timed on plans sorted by tiles of
several sizes. A variant that computes something else (``values_sorted``
reads the values as if a first pass had sorted them) shows its error and is
there for its time alone.

``--source probe``, ``csrc/probe.cu``: the element-window kernel in its
two forms, (a) the rows' spans staged in shared memory by bulk copies on
an mbarrier and (b) no shared memory, each at bands of 4, 8, 16 and 32 rows
and with float4 or 4-byte loads and stores; the static-DMA kernel at bands
of 4, 8, 16 and 32 rows of 64 or 128 threads; the gridded and prefetch
kernels at bands of 1, 2, 4, 8 and 16 rows, float4 or 4-byte, of 64, 128 or
256 threads, prefetch also with its index read through shared memory behind
a barrier, and in the parent's form (a block per plane). Each variant's
probes must equal ``toolchain_probe.PLAIN`` bit for bit (the element windows
also at every lead and at ``big``'s edges, gridded and prefetch at odd
shapes; ``tests/_torch_probe_cases.py``), and each probe a variant changes
is timed in a CUDA graph with the index check outside, beside its library
call and the empty kernel at the variant's grid for that probe (the launch
floor), 100 launches a graph, the median of 5 replays (``chip_smoke.py``
takes 20 and 3), in three rounds (the variants in order, in reverse, in
order). ``--parent FILE`` builds a ``probe.cu`` of another checkout beside
them and times all its probes (it may lack the empty kernel).

``FILE`` holds a Python literal ``{name: [(old, new), ...]}``; every ``old``
must occur in the source. Without it the default variants run: the choices
the source's header comment reports as measured.
"""

from __future__ import annotations

import argparse
import ast
import concurrent.futures
import contextlib
import ctypes
import functools
import os
import re
import statistics
import subprocess
import tempfile

import numpy as np
import torch

from . import kernels, toolchain_probe
from .ops import usfft

SOURCE = os.path.join(kernels.CSRC, "usfft.cu")
PROBE_SOURCE = os.path.join(kernels.CSRC, "probe.cu")

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


def _constant(source: str, name: str, value) -> tuple:
    """The (old, new) substitution that sets ``constexpr`` ``name`` of
    ``source`` to ``value``."""
    match = re.search(rf"constexpr (int|bool) {name} = [^;]+;", source)
    if match is None:
        raise ValueError(f"no constexpr {name} in the source")
    if isinstance(value, bool):
        value = str(value).lower()
    return match.group(0), f"constexpr {match.group(1)} {name} = {value};"


def parent_form(source: str) -> list:
    """The substitutions that give ``csrc/probe.cu``'s gridded and prefetch
    kernels the launch of their form before the bands: a block of 128
    threads per 128-float row, each moving one 4-byte value; and a block of
    256 threads per plane, 4-byte values, its index read into shared memory
    behind a barrier. The first three are gridded's, the rest prefetch's."""
    return [
        _constant(source, "kGriddedRows", 1),
        _constant(source, "kGriddedVectors", False),
        _constant(source, "kGriddedThreads", toolchain_probe.COLS),
        _constant(source, "kPrefetchRows", toolchain_probe.ROWS),
        _constant(source, "kPrefetchVectors", False),
        _constant(source, "kPrefetchThreads", 256),
        _constant(source, "kPrefetchSharedIndex", True),
    ]


def probe_variants(source: str) -> dict:
    """The default variants of ``csrc/probe.cu`` (``source``): see the
    module's docstring. A variant that equals the source as it stands
    repeats its time in the same call. The first word of a name is the
    family (``FAMILIES``) whose probes it changes."""
    dma_rows = int(re.search(r"constexpr int kDmaRows = (\d+);", source).group(1))
    variants = {"as it stands": []}
    for staged in (False, True):
        for vectors in (True, False):
            for rows in (4, 8, 16, 32):
                form = "(a) staged" if staged else "(b) direct"
                loads = "float4" if vectors else "4-byte"
                variants[f"element {form}, {loads}, {rows} rows"] = [
                    _constant(source, "kElementStaged", staged),
                    _constant(source, "kElementVectors", vectors),
                    _constant(source, "kElementRows", rows),
                    _constant(source, "kBandRows", max(rows, dma_rows)),
                ]
    for rows in (4, 8, 16, 32):
        for threads in (64, 128):
            variants[f"static_dma {rows} rows, {threads} threads"] = [
                _constant(source, "kStaticBandRows", rows),
                _constant(source, "kStaticThreads", threads),
            ]
    for name, prefix in (("gridded", "kGridded"), ("prefetch", "kPrefetch")):
        for rows in (1, 2, 4, 8, 16):
            for vectors in (True, False):
                for threads in (64, 128, 256):
                    loads = "float4" if vectors else "4-byte"
                    variants[f"{name} {rows} rows, {loads}, {threads} threads"] = [
                        _constant(source, f"{prefix}Rows", rows),
                        _constant(source, f"{prefix}Vectors", vectors),
                        _constant(source, f"{prefix}Threads", threads),
                    ]
    for rows in (1, 2, 4, 8, 16):
        variants[f"prefetch {rows} rows, index through shared memory"] = [
            _constant(source, "kPrefetchRows", rows),
            _constant(source, "kPrefetchSharedIndex", True),
        ]
    # gridded's parent form is "gridded 1 rows, 4-byte, 128 threads".
    variants["prefetch, the parent's form (a block per plane)"] = parent_form(source)[3:]
    return variants


def start_builds(name: str, sources: dict, directory) -> dict:
    """Compile each source (tag -> text) with its own ``nvcc`` in
    ``directory``, as many at once as the host has cores: tag -> a future
    of (library path, the end of nvcc's error output, or None)."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=os.cpu_count() or 8)
    builds = {}
    for i, (tag, text) in enumerate(sources.items()):
        path = os.path.join(directory, f"{name}_variant_{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        command = [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o", path[:-3] + ".so", path]

        def build(command=command):
            done = subprocess.run(command, capture_output=True, text=True)
            return command[-2], (done.stderr[-2000:] if done.returncode else None)

        builds[tag] = pool.submit(build)
    pool.shutdown(wait=False)
    return builds


def finish_builds(name: str, builds: dict) -> tuple:
    """Wait for :func:`start_builds`: (tag -> loaded library, tag -> error)."""
    libs, failed = {}, {}
    for tag, future in builds.items():
        library, error = future.result()
        if error is None:
            libs[tag] = _load(name, library)
        else:
            failed[tag] = error
    return libs, failed


def _load(name: str, library: str):
    """Load a built variant; entry points it lacks (an older source's) are
    left out."""
    lib = ctypes.CDLL(library)
    for fn_name, (argtypes, restype) in kernels.SIGNATURES[name].items():
        if hasattr(lib, fn_name):
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, restype
    return lib


@contextlib.contextmanager
def loaded(name: str, lib):
    """Inside the block ``kernels.load(name)`` returns ``lib``, so the
    package's own wrappers launch that variant's kernels."""
    built = kernels._LOADED.get(name)
    kernels._LOADED[name] = lib
    try:
        yield
    finally:
        if built is None:
            kernels._LOADED.pop(name, None)
        else:
            kernels._LOADED[name] = built


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


def _sweep_usfft(libs: dict, device) -> None:
    from tests import _torch_usfft_cases as cases

    generator = torch.Generator(device=device).manual_seed(0)
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


PROBES_SWEPT = ("element_static", "element_prefetch", "static_dma", "gridded", "prefetch")
# The probes that a family of variants (the first word of a variant's name)
# changes; the source as it stands and another checkout's run them all.
FAMILIES = {
    "element": ("element_static", "element_prefetch"),
    "static_dma": ("static_dma",),
    "gridded": ("gridded",),
    "prefetch": ("prefetch",),
}
# A probe launch is a microsecond or two: 100 launches a graph, the median of
# 5 replays, three rounds, to see 0.0001 ms through the noise.
PROBE_REPS, PROBE_REPLAYS = 100, 5


def swept(tag: str) -> tuple:
    """The probes variant ``tag`` is checked and timed on."""
    return FAMILIES.get(tag.split()[0].rstrip(","), PROBES_SWEPT)


def _sweep_probe(libs: dict, device) -> None:
    """Each variant's probes through ``toolchain_probe``'s own wrappers,
    with the variant's library in place of the built one."""
    from tests import _torch_probe_cases as cases

    inp = toolchain_probe.inputs(device)
    library = cases.library_calls(inp)
    rng = np.random.default_rng(0)
    bigs = [inp["big"], cases.random_big(rng, cases.BIG_SHAPES[1], device)]
    calls = {
        name: functools.partial(
            toolchain_probe.FUNCTIONS[name], *toolchain_probe._args(name, inp),
            **({"check_indices": False} if name in toolchain_probe.INDEXED else {}),
        )
        for name in PROBES_SWEPT
    }
    floors = {name: cases.floor_call(name, inp) for name in PROBES_SWEPT}
    wrong = set()
    for tag, lib in libs.items():
        names = swept(tag)
        try:
            with loaded("probe", lib):
                toolchain_probe.check({name: calls[name]() for name in names}, inp)
                if "element_prefetch" in names:
                    for big in bigs:
                        for lead in cases.LEADS:
                            cases.check_windows(big, cases.edge_corners(tuple(big.shape), lead))
                if "gridded" in names or "prefetch" in names:
                    cases.check_odd_shapes(device)
        except AssertionError as e:
            wrong.add(tag)
            print(f"{tag}: WRONG, {e}", flush=True)
    order = [tag for tag in libs if tag not in wrong]
    times = {tag: {name: [] for name in swept(tag)} for tag in order}
    floor_times = {tag: {name: [] for name in swept(tag)} for tag in order}
    library_times = {name: [] for name in PROBES_SWEPT}
    for turn in (order, order[::-1], order):
        for tag in turn:
            with loaded("probe", libs[tag]):
                for name in swept(tag):
                    times[tag][name].append(graph_ms(calls[name], PROBE_REPS, PROBE_REPLAYS))
                    if hasattr(libs[tag], "tike_probe_empty"):
                        floor_times[tag][name].append(
                            graph_ms(floors[name], PROBE_REPS, PROBE_REPLAYS)
                        )
        for name in PROBES_SWEPT:
            library_times[name].append(graph_ms(library[name], PROBE_REPS, PROBE_REPLAYS))
    for name in PROBES_SWEPT:
        lib_ms = ", ".join(f"{t:.5f}" for t in library_times[name])
        print(f"{name}: library call ({cases.LIBRARY_NAMES[name]}) {lib_ms} ms (median "
              f"{statistics.median(library_times[name]):.5f})", flush=True)
        for tag in order:
            if name not in times[tag]:
                continue
            ms = ", ".join(f"{t:.5f}" for t in times[tag][name])
            floor = floor_times[tag][name]
            floor = f"{statistics.median(floor):.5f}" if floor else "not measured"
            print(f"{name:16s} {tag:60s} {ms} ms (median {statistics.median(times[tag][name]):.5f}; "
                  f"launch floor at its grid {floor}; bitwise equal to plain)", flush=True)


SWEEPS = {"usfft": (SOURCE, _sweep_usfft), "probe": (PROBE_SOURCE, _sweep_probe)}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", default="usfft", choices=list(SWEEPS))
    parser.add_argument("--variants", default=None, help="a file holding {name: [(old, new), ...]}")
    parser.add_argument("--parent", default=None,
                        help="the source file of another checkout, built and timed beside the variants")
    args = parser.parse_args(argv)
    path, sweep = SWEEPS[args.source]
    with open(path) as f:
        source = f.read()
    variants = VARIANTS if args.source == "usfft" else probe_variants(source)
    if args.variants:
        with open(args.variants) as f:
            variants = {"as it stands": [], **ast.literal_eval(f.read())}
    sources = {tag: variant_source(source, subs) for tag, subs in variants.items()}
    if args.parent:
        with open(args.parent) as f:
            sources[f"parent ({args.parent})"] = f.read()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as directory:
        libs, failed = finish_builds(args.source, start_builds(args.source, sources, directory))
        for tag, error in failed.items():
            print(f"{tag}: build failed\n{error}")
        sweep(libs, device)


if __name__ == "__main__":
    main()
