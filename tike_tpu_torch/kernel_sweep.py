"""Build variants of a kernel source and time them beside the source as it
stands, on one CUDA card.

A development tool for the hand-written kernels: each variant is the source
with a few text substitutions (a tuning constant, a load instruction, a
loop), built by its own ``nvcc`` (as many at once as the host has cores, a
few seconds each) and held to the plain PyTorch versions. Run from the root of a checkout:

    python -m tike_tpu_torch.kernel_sweep [--source usfft|gaussian|gaussian_wide|probe|bucket|interp] [--variants FILE] [--parent FILE]

``--source usfft`` (the default), ``csrc/usfft.cu``: each variant launched
twice for a bitwise comparison and timed in a CUDA graph at laminography's
shapes (128^3 / 64 angles at upsample 1 and 2, 256^3 / 128 angles). Then
the gather of the source as it stands is timed on plans sorted by tiles of
several sizes. A variant that computes something else (``values_sorted``
reads the values as if a first pass had sorted them) shows its error and is
there for its time alone.

``--source gaussian``, ``csrc/usfft_gaussian.cu`` on the Gaussian window's
plans at 128^3 / 64 angles (eps 1e-3 at upsample 1 and 2, m = 2 and 4; eps
1e-5 at upsample 2, m = 6): first how many points a brick of 8^3 bins
holds; then the source as it stands beside its scatter with bands of 1, 2,
4 and 8 rows at every m (each with its own bands, busiest first) and 1, 2
and 8 warps a band, and its gather with groups of lanes in place of a
thread a point (m <= 2), 256 threads a block of threads a point and the
axis-0 loop unrolled 1 and 4 deep (``gaussian_variants``); each variant's pair held to the plain
Gaussian versions (and two scatters bitwise equal) and timed in a CUDA
graph in three rounds beside the first form (the KB kernels of
``csrc/usfft.cu`` on the same plan, the kernels' yardstick); then the
scatter of the source as it stands with its bands in the grid's order, not
the plan's. Then, at eps 1e-10 / upsample 3, 1e-8 / 4 and 1e-10 / 4 (m =
17, 18, 22: 2m above a warp's lanes), the source as it stands held to the
plain versions on 16,384 of the points; the wide gather's variants (groups
of 32 or 8 lanes a point in place of 16, a lane's slots of taps one after
another, the axis-1 loop unrolled 4 deep) and the scatter's (bands and
warps as above) held to it on all of them, and all timed in three rounds
beside the first form's (``_sweep_gaussian_wide``; ``--source
gaussian_wide`` runs it alone). Every sweep prints each
variant's nvcc time (the variants build at once, one nvcc each).

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

``--source bucket``, ``csrc/bucket.cu``: the adjoint with 2 and 8 window
stages in flight besides its own 4 and with two blocks an SM (64 registers
a thread) besides one, each kernel with the other's mapping
of a warp's lanes to voxels, the forward adding each point to its window
cell in place of counting a voxel's points per cell, and with 1 and 8
copies of its window besides its own 4, and with one block an SM; then, to
see where the time goes, three that leave a step out (the forward's adds
of window cells to the plane or of counts to the window, the adjoint's
gathers from the window), which compute something else and are timed all
the same (``bucket_variants``). Each variant's adjoint must equal the plain
version's bit for bit, its forward lie within 1e-4 (of the largest value)
of the plain version's, and no point fall outside its window; then both
kernels are timed in a CUDA graph of 3 launches in three rounds, at
bench_all.py's 128^3, 64 angles, precision 3 and at the golden 64^3, 58
angles, precision 1.

``--source interp``, ``csrc/interp.cu``: the weights from two accurate
``sinf`` each (the first form's) besides one sine pair an axis, and their
quotients by ``__fdividef`` besides the approximate reciprocal; the
adjoint's warp-aggregated windows with other buffers, and tap by tap (the
first form's atomics on the 4 x 4 window, and one counter atomic a warp);
and, to see where the time goes, a forward that reads one tap a row and an
adjoint that adds nothing to the grid, which compute something else and
are timed all the same (``interp_variants``). Each variant's kernels must
lie within the tolerances of ``tests/_torch_interp_cases.py`` of the plain
versions; then both are timed in CUDA graphs in three rounds beside the
first form (``csrc/interp_first_form.cu``), at ``chip_smoke.py`` phase
19a's shapes: 128 x 1024^2 with the flow's and the rotation's points, and
the golden 128^2, m = 2, and at a rotation by 0.5 rad, where every adjoint
warp falls back to adding tap by tap.

``FILE`` holds a Python literal ``{name: [(old, new), ...]}``; every ``old``
must occur in the source. Without it the default variants run: the choices
the source's header comment reports as measured.
"""

from __future__ import annotations

import argparse
import ast
import concurrent.futures
import dataclasses
import contextlib
import ctypes
import functools
import os
import re
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from . import kernels, toolchain_probe
from .ops import usfft

SOURCE = os.path.join(kernels.CSRC, "usfft.cu")
GAUSSIAN_SOURCE = os.path.join(kernels.CSRC, "usfft_gaussian.cu")
PROBE_SOURCE = os.path.join(kernels.CSRC, "probe.cu")
BUCKET_SOURCE = os.path.join(kernels.CSRC, "bucket.cu")
INTERP_SOURCE = os.path.join(kernels.CSRC, "interp.cu")

VARIANTS = {
    "as it stands": [],
    # An upper bound for a first pass that permutes the values into the
    # plan's order: the scatter reads them as if already sorted.
    "values_sorted": [("c.v = __ldg(values + __ldg(order + c.p));", "c.v = __ldg(values + c.p);")],
    "scatter_warps_2": [("constexpr int kScatterWarps = 4;", "constexpr int kScatterWarps = 2;")],
    "scatter_warps_3": [("constexpr int kScatterWarps = 4;", "constexpr int kScatterWarps = 3;")],
    # Eight copies of a row: above n = 768 the block asks for more than the
    # 48 KB.
    "scatter_warps_8": [("constexpr int kScatterWarps = 4;", "constexpr int kScatterWarps = 8;")],
    "gather_threads_128": [
        ("constexpr int kGatherThreads = 256;", "constexpr int kGatherThreads = 128;")
    ],
    # The gather's plan loads and output stores through the ordinary path.
    "gather_not_streaming": [
        ("const int cell_row = __ldcs(rows + p);", "const int cell_row = __ldg(rows + p);"),
        ("const int b2 = __ldcs(cols + p);", "const int b2 = __ldg(cols + p);"),
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
# (eps, upsample) of the Gaussian window's timed cases at 128^3 / 64 angles:
# m = 2, 4 and 6.
GAUSSIAN_CASES = {"eps 1e-3, upsample 1": (1e-3, 1), "eps 1e-3, upsample 2": (1e-3, 2),
                  "eps 1e-5, upsample 2": (1e-5, 2)}
# (eps, upsample) of the wide gather's cases (2m above a warp's lanes), at
# the same points: m = 17, 18 and 22, on 384^3, 512^3 and 512^3 grids.
WIDE_CASES = {"eps 1e-10, upsample 3": (1e-10, 3), "eps 1e-8, upsample 4": (1e-8, 4),
              "eps 1e-10, upsample 4": (1e-10, 4)}
# Points of a wide case held to the plain versions (every so many): the
# plain loop is (2m)^3 indexed passes, 85,184 at m = 22.
WIDE_SAMPLE = 16_384
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

        def build(command=command, tag=tag):
            start = time.perf_counter()
            done = subprocess.run(command, capture_output=True, text=True)
            print(f"[build] {name} {tag}: nvcc {time.perf_counter() - start:.1f} s", flush=True)
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
            grid.data_ptr(), plan.rows.data_ptr(), plan.cols.data_ptr(), plan.order.data_ptr(),
            plan.weights.data_ptr(), out.data_ptr(), npoints, n, m,
            torch.cuda.current_stream().cuda_stream,
        )
        if rc:
            raise RuntimeError(f"kb_gather: CUDA error {rc}")

    def scatter():
        rc = lib.tike_kb_scatter(
            f.data_ptr(), plan.cols.data_ptr(), plan.order.data_ptr(),
            plan.row_start.data_ptr(), plan.weights.data_ptr(), G.data_ptr(), npoints, n, m,
            torch.cuda.current_stream().cuda_stream,
        )
        if rc:
            raise RuntimeError(f"kb_scatter: CUDA error {rc}")

    return gather, scatter


def _time_variants(libs: dict, name: str, grid, f, plan, want_gather, want_scatter) -> None:
    """Each library's gather and scatter on ``plan`` in a CUDA graph, beside
    its errors against the plain versions and whether two scatters agree."""
    from tests import _torch_usfft_cases as cases

    out, G = torch.empty_like(f), torch.empty_like(grid)
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
        _time_variants(libs, name, grid, f, usfft.geometry_plan(x, n, m, beta), want_gather, want_scatter)
        out, G = torch.empty_like(f), torch.empty_like(grid)
        for tile in TILES:
            tiled = usfft.geometry_plan(x, n, m, beta, tile)
            gather, _ = _launchers(libs["as it stands"], grid, f, tiled, out, G)
            ms = graph_ms(gather)
            order = "bin order" if tile is None else f"tiles of {tile[0]} x {tile[1]}"
            print(f"{name:12s} gather as it stands, plan in {order}: {ms:.4f} ms (err "
                  f"{cases.max_rel(out, want_gather):.1e})", flush=True)


def gaussian_variants(source: str) -> dict:
    """The default variants of ``csrc/usfft_gaussian.cu`` (``source``): see
    the module's docstring."""
    variants = {"as it stands": []}
    for rows in (1, 2, 4, 8):
        variants[f"scatter, bands of {rows} rows"] = [
            _constant(source, name, rows) for name in ("kBandRowsSmallM", "kBandRowsLargeM")]
    for warps in (1, 2, 8):
        variants[f"scatter, {warps} warps a band"] = [_constant(source, "kScatterWarps", warps)]
    variants["gather, groups of lanes in place of a thread a point"] = [
        _constant(source, "kThreadGatherMaxM", 0)]
    variants["gather, 256 threads a block of threads a point"] = [
        _constant(source, "kThreadGatherThreads", 256)]
    for unroll in (1, 4):
        variants[f"gather axis-0 unroll {unroll}"] = [_constant(source, "kGatherUnroll0", unroll)]
    # The wide gather (2m > 32), timed at WIDE_CASES alone: groups of 32 or
    # 8 lanes (two, or five or six slots: one after another), a lane's three
    # slots one after another, the axis-1 loop unrolled 4 deep.
    for lanes in (32, 8):
        variants[f"wide gather, groups of {lanes} lanes"] = [_constant(source, "kWideLanes", lanes)]
    variants["wide gather, slots one after another"] = [_constant(source, "kWideInnerSlots", 0)]
    variants["wide gather, axis-1 loop unrolled 4 deep"] = [_constant(source, "kWideUnroll1", 4)]
    return variants


def _wide(tag: str) -> bool:
    """Whether variant ``tag`` changes the wide gather alone."""
    return tag.startswith("wide gather")


def _scatter_variant(tag: str) -> bool:
    """Whether variant ``tag`` changes the scatter alone."""
    return tag.startswith("scatter")


def _sweep_gaussian(libs: dict, device) -> None:
    """The Gaussian window at laminography's 128^3 / 64 angles, at each of
    ``GAUSSIAN_CASES``: every variant's gather and scatter and the first
    form's in three rounds, then the scatter with its bands in the grid's
    order."""
    from tests import _torch_usfft_cases as cases

    generator = torch.Generator(device=device).manual_seed(0)
    x = cases.lamino_rows(cases.LAMINO_N, cases.LAMINO_NTHETA, device).reshape(-1, 3)
    libs = {tag: lib for tag, lib in libs.items() if not _wide(tag)}
    for name, (eps, upsample) in GAUSSIAN_CASES.items():
        n, _, mu, m = usfft.usfft_parameters(cases.LAMINO_N, eps, upsample)
        grid = torch.randn((n, n, n), dtype=torch.complex64, device=device, generator=generator)
        f = torch.randn(x.shape[0], dtype=torch.complex64, device=device, generator=generator)
        want_gather = usfft.gather_gaussian_plain(grid, x, n, m, mu)
        want_scatter = usfft.scatter_gaussian_plain(f, x, n, m, mu)
        start = time.perf_counter()
        plan = usfft.geometry_plan(x, n, m, mu, window="gaussian")
        torch.cuda.synchronize()
        print(f"{name} m = {m}: plan {1e3 * (time.perf_counter() - start):.2f} ms "
              f"(first call), {plan.nbytes} bytes", flush=True)
        # How many points a brick of 8^3 bins holds: what a gather that
        # staged a brick and its halo in shared memory would serve a brick.
        bricks = torch.stack([plan.bins // (n * n), plan.bins // n % n, plan.bins % n]) // 8
        per_brick = torch.bincount(((bricks[0] * (n // 8)) + bricks[1]) * (n // 8) + bricks[2],
                                   minlength=(n // 8) ** 3).double()
        held = per_brick[per_brick > 0]
        print(f"{name} m = {m}: points a brick of 8^3 bins holds: {(per_brick == 0).sum()} of "
              f"{per_brick.numel()} bricks empty, the others {held.mean():.1f} on average, "
              f"median {held.median():.0f}, most {held.max():.0f}; a brick and its halo "
              f"{(8 + 2 * m - 1) ** 3} cells", flush=True)
        calls = {}
        # A variant with bands of another height takes its own bands,
        # busiest first.
        unordered = dataclasses.replace(
            plan, blocks=usfft._scatter_blocks(plan.row_start, n, m, busiest_first=False))
        plans = {}
        for tag in libs:
            rows = re.search(r"bands of (\d+) rows", tag)
            plans[tag] = plan if rows is None else dataclasses.replace(
                plan, blocks=usfft._scatter_blocks(plan.row_start, n, m, int(rows.group(1))))
        reference = None
        for tag, lib in libs.items():
            with loaded("usfft_gaussian", lib):
                got_gather = usfft.gather_gaussian_cuda(grid, x, n, m, mu, plan)
                got_scatter = usfft.scatter_gaussian_cuda(f, x, n, m, mu, plans[tag])
                same = torch.equal(torch.view_as_real(got_scatter), torch.view_as_real(
                    usfft.scatter_gaussian_cuda(f, x, n, m, mu, plans[tag])))
            reference = got_scatter if reference is None else reference
            print(f"{name} m = {m}: {tag:34s} gather err {cases.max_rel(got_gather, want_gather):.1e}, "
                  f"scatter err {cases.max_rel(got_scatter, want_scatter):.1e}, two scatters "
                  f"bitwise equal: {same}, to the source as it stands: "
                  f"{torch.equal(torch.view_as_real(got_scatter), torch.view_as_real(reference))}",
                  flush=True)
            calls[tag] = lib
        calls["first form"] = None
        times = {tag: {"gather": [], "scatter": []} for tag in calls}
        for turn in (list(calls), list(calls)[::-1], list(calls)):
            for tag in turn:
                if calls[tag] is None:
                    pair = {"gather": lambda: cases.first_form_gather(grid, plan),
                            "scatter": lambda: cases.first_form_scatter(f, plan)}
                    for kind, fn in pair.items():
                        times[tag][kind].append(graph_ms(fn))
                    continue
                with loaded("usfft_gaussian", calls[tag]):
                    times[tag]["gather"].append(
                        graph_ms(lambda: usfft.gather_gaussian_cuda(grid, x, n, m, mu, plan)))
                    times[tag]["scatter"].append(graph_ms(lambda: usfft.scatter_gaussian_cuda(
                        f, x, n, m, mu, plans[tag])))
        for tag in calls:
            line = "; ".join(
                f"{kind} " + ", ".join(f"{t:.4f}" for t in ts)
                + f" ms (median {statistics.median(ts):.4f})"
                for kind, ts in times[tag].items()
            )
            print(f"{name} m = {m}: {tag:34s} {line}", flush=True)
        with loaded("usfft_gaussian", libs["as it stands"]):
            got = usfft.scatter_gaussian_cuda(f, x, n, m, mu, unordered)
            ms = graph_ms(lambda: usfft.scatter_gaussian_cuda(f, x, n, m, mu, unordered))
            print(f"{name} m = {m}: scatter as it stands, bands in the grid's order: {ms:.4f} ms "
                  f"(err {cases.max_rel(got, want_scatter):.1e}, bitwise equal to the busiest "
                  f"first: {torch.equal(torch.view_as_real(got), torch.view_as_real(reference))})",
                  flush=True)
        del grid, f, plan, unordered, plans, want_gather, want_scatter


def _sweep_gaussian_wide(libs: dict, device) -> None:
    """The Gaussian gather above 32 taps at laminography's 128^3 / 64
    angles, at each of ``WIDE_CASES``: the source as it stands held to the
    plain versions on every WIDE_SAMPLE-th point (gather and scatter), each
    wide variant's gather to the source's on all points; then the gathers of
    the source, the wide variants and the first form (a thread a point) in
    three rounds, and the scatter beside the first form's."""
    from tests import _torch_usfft_cases as cases

    libs = {tag: lib for tag, lib in libs.items()
            if tag == "as it stands" or _wide(tag) or _scatter_variant(tag)}
    gathers = [tag for tag in libs if not _scatter_variant(tag)]
    scatters = [tag for tag in libs if not _wide(tag)]
    generator = torch.Generator(device=device).manual_seed(0)
    x = cases.lamino_rows(cases.LAMINO_N, cases.LAMINO_NTHETA, device).reshape(-1, 3)
    step = max(1, x.shape[0] // WIDE_SAMPLE)
    sample = x[::step].contiguous()
    for name, (eps, upsample) in WIDE_CASES.items():
        n, _, mu, m = usfft.usfft_parameters(cases.LAMINO_N, eps, upsample)
        grid = torch.randn((n, n, n), dtype=torch.complex64, device=device, generator=generator)
        f = torch.randn(x.shape[0], dtype=torch.complex64, device=device, generator=generator)
        plan = usfft.geometry_plan(x, n, m, mu, window="gaussian")
        fs = f[::step].contiguous()
        with loaded("usfft_gaussian", libs["as it stands"]):
            errs = (cases.max_rel(usfft.gather_gaussian_cuda(grid, sample, n, m, mu),
                                  usfft.gather_gaussian_plain(grid, sample, n, m, mu)),
                    cases.max_rel(usfft.scatter_gaussian_cuda(fs, sample, n, m, mu),
                                  usfft.scatter_gaussian_plain(fs, sample, n, m, mu)))
            reference = usfft.gather_gaussian_cuda(grid, x, n, m, mu, plan)
        print(f"{name} m = {m}: grid {n}^3, {x.shape[0]} points; as it stands on "
              f"{sample.shape[0]} of them against the plain versions: gather err {errs[0]:.1e}, "
              f"scatter err {errs[1]:.1e}", flush=True)
        spread = None
        plans = {}
        for tag in libs:
            rows = re.search(r"bands of (\d+) rows", tag)
            plans[tag] = plan if rows is None else dataclasses.replace(
                plan, blocks=usfft._scatter_blocks(plan.row_start, n, m, int(rows.group(1))))
        for tag, lib in libs.items():
            with loaded("usfft_gaussian", lib):
                if tag in gathers:
                    got = usfft.gather_gaussian_cuda(grid, x, n, m, mu, plan)
                    print(f"{name} m = {m}: {tag:60s} gather err to the source as it stands "
                          f"{cases.max_rel(got, reference):.1e}", flush=True)
                if tag in scatters:
                    got = usfft.scatter_gaussian_cuda(f, x, n, m, mu, plans[tag])
                    spread = got if spread is None else spread
                    print(f"{name} m = {m}: {tag:60s} scatter err to the source as it stands "
                          f"{cases.max_rel(got, spread):.1e}", flush=True)
        times = {tag: [] for tag in [*gathers, "first form"]}
        for turn in (list(times), list(times)[::-1], list(times)):
            for tag in turn:
                if tag == "first form":
                    times[tag].append(graph_ms(lambda: cases.first_form_gather(grid, plan), reps=2))
                    continue
                with loaded("usfft_gaussian", libs[tag]):
                    times[tag].append(graph_ms(
                        lambda: usfft.gather_gaussian_cuda(grid, x, n, m, mu, plan), reps=2))
        for tag, ts in times.items():
            print(f"{name} m = {m}: gather {tag:60s} " + ", ".join(f"{t:.4f}" for t in ts)
                  + f" ms (median {statistics.median(ts):.4f})", flush=True)
        times = {tag: [] for tag in [*scatters, "first form"]}
        for turn in (list(times), list(times)[::-1], list(times)):
            for tag in turn:
                if tag == "first form":
                    times[tag].append(graph_ms(lambda: cases.first_form_scatter(f, plan), reps=2))
                    continue
                with loaded("usfft_gaussian", libs[tag]):
                    times[tag].append(graph_ms(
                        lambda: usfft.scatter_gaussian_cuda(f, x, n, m, mu, plans[tag]), reps=2))
        for tag, ts in times.items():
            print(f"{name} m = {m}: scatter {tag:60s} " + ", ".join(f"{t:.4f}" for t in ts)
                  + f" ms (median {statistics.median(ts):.4f})", flush=True)
        del grid, f, plan, reference, plans, spread


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


def bucket_variants(source: str) -> dict:
    """The default variants of ``csrc/bucket.cu`` (``source``)."""
    variants = {"as it stands": []}
    for stages in (2, 8):
        variants[f"adjoint with {stages} window stages"] = [_constant(source, "kStages", stages)]
    variants["adjoint lanes spread"] = [_constant(source, "kAdjSpread", True)]
    variants["adjoint two blocks an SM"] = [_constant(source, "kAdjBlocks", 2)]
    variants["forward lanes in rows of 8"] = [_constant(source, "kFwdSpread", False)]
    variants["forward point by point"] = [_constant(source, "kCountCells", False)]
    for copies in (1, 8):
        variants[f"forward with {copies} window copies"] = [
            _constant(source, "kWindowCopies", copies)
        ]
    variants["forward one block an SM"] = [_constant(source, "kFwdBlocks", 1)]
    variants["forward one block an SM, 8 copies"] = [
        _constant(source, "kFwdBlocks", 1), _constant(source, "kWindowCopies", 8)
    ]
    # Where the time goes: each leaves one step out, so computes something
    # else, and is timed all the same.
    variants["forward, no window cell added to the plane (time only)"] = [(
        "if (v.x != 0.0f || v.y != 0.0f) atomicAdd(plane + plane_cell(w, row, col, n), v);",
        "if (v.x == 12345.0f) atomicAdd(plane + plane_cell(w, row, col, n), v);",
    )]
    variants["forward, no count added to the window (time only)"] = [(
        "shared_add(box + (f / 3) * pitch + f % 3,",
        "if (count == 12345u) shared_add(box + (f / 3) * pitch + f % 3,",
    )]
    variants["adjoint, no gather from the window (time only)"] = [(
        "const float2 v = buf[min(static_cast<unsigned>(row * pitch + col),",
        "const float2 v = make_float2(row, col); (void)buf[min(static_cast<unsigned>(row * pitch + col),",
    )]
    return variants


def _sweep_bucket(libs: dict, device) -> None:
    """Each variant through ``ops.bucket``'s own wrappers, with the
    variant's library in place of the built one."""
    from tests import _torch_bucket_cases as cases

    from .ops import bucket

    _, _, theta, tilt = cases.load_golden("lamino_setup.pickle.lzma")
    full = cases.FULL
    shapes = {
        "128^3 / 64 angles, precision 3": (
            bucket.BucketConfig.from_eps(full["n"], full["tilt"], full["eps"]),
            cases.theta(full["ntheta"], 0.0, device),
        ),
        "golden 64^3 / 58 angles, precision 1": (
            bucket.BucketConfig.from_eps(64, float(tilt), 1.0),
            torch.as_tensor(np.asarray(theta, np.float32), device=device),
        ),
    }
    for case, (cfg, th) in shapes.items():
        u = cases.volume(cfg.n, device=device)
        d = cases.planes(th.shape[0], cfg.n, device=device)
        trig = bucket.bucket_trig(cfg, th)
        want_fwd = bucket.bucket_fwd_plain(cfg, u, th, None, trig)
        want_adj = bucket.bucket_adj_plain(cfg, d, th, None, trig)
        calls = {
            "fwd": lambda: bucket.bucket_fwd_cuda(cfg, u, th, None, trig),
            "adj": lambda: bucket.bucket_adj_cuda(cfg, d, th, None, trig),
        }
        order = []
        for tag, lib in libs.items():
            with loaded("bucket", lib):
                bucket.reset_outside_windows(device)
                fwd_err = cases.max_rel(calls["fwd"](), want_fwd)
                same = torch.equal(calls["adj"](), want_adj)
                outside = bucket.outside_windows(device)
            right = fwd_err <= 1e-4 and same and not outside
            if right or "(time only)" in tag:
                order.append(tag)
            if not right:
                print(f"{case}: {tag}: WRONG (forward {fwd_err:.1e} of max|value|, adjoint "
                      f"bitwise equal {same}, {outside} points outside)", flush=True)
        times = {tag: {name: [] for name in calls} for tag in order}
        for turn in (order, order[::-1], order):
            for tag in turn:
                with loaded("bucket", libs[tag]):
                    for name, fn in calls.items():
                        times[tag][name].append(graph_ms(fn, reps=3))
        for tag in order:
            line = "; ".join(
                f"{name} " + ", ".join(f"{t:.4f}" for t in ts) + f" ms (median {statistics.median(ts):.4f})"
                for name, ts in times[tag].items()
            )
            print(f"{case}: {tag:36s} {line}", flush=True)


def interp_variants(source: str) -> dict:
    """The default variants of ``csrc/interp.cu`` (``source``)."""
    return {
        "as it stands": [],
        "weights from accurate sinf": [_constant(source, "kSinePair", False)],
        "weights' quotients by __fdividef": [(
            "const float w = num * reciprocal(d * d);", "const float w = __fdividef(num, d * d);",
        )],
        "adjoint tap by tap": [_constant(source, "kWarpAggregate", False)],
        "adjoint buffer 6 x 40": [_constant(source, "kBufRows", 6)],
        "adjoint buffer 8 x 64": [_constant(source, "kBufCols", 64)],
        # Where the time goes (time only).
        "forward, one tap read a row (time only)": [(
            "        v = __ldg(line + j);\n", "        v = __ldg(line);\n",
        )],
        "adjoint, nothing added to the grid (time only)": [(
            "if (col >= 0 && col < w && nonzero(sum)) atomic_add(line + col, sum);",
            "if (col == -12345 && nonzero(sum)) atomic_add(line + col, sum);",
        )],
    }


def _sweep_interp(libs: dict, device) -> None:
    """Each variant through ``ops.interp``'s own wrappers, with the
    variant's library in place of the built one."""
    from tests import _torch_interp_cases as cases

    from .ops import interp

    full = cases.full_width_inputs(device)
    golden = cases.full_width_inputs(device, images=1, n=cases.GOLDEN_N, seed=1)
    shapes = {
        "flow 128 x 1024^2": (full["images"], full["flow"]),
        "rotation 128 x 1024^2": (full["images"], full["rotate"]),
        "golden 1 x 128^2": (golden["images"], golden["flow"]),
        # Every warp's windows span more rows than the adjoint's buffer.
        "rotation by 0.5 rad, 128 x 1024^2": (
            full["images"], cases.rotate_points(cases.FULL_N, 0.5, device).contiguous()
        ),
    }
    for case, (images, points) in shapes.items():
        shape = tuple(images.shape[-2:])
        values = images.reshape(images.shape[0], -1)
        want_fwd = interp.remap_lanczos_fwd_plain(images, points, 2)
        want_adj = interp.remap_lanczos_adj_plain(values, points, 2, shape)
        calls = {
            "fwd": lambda: interp.remap_lanczos_fwd_cuda(images, points, 2),
            "adj": lambda: interp.remap_lanczos_adj_cuda(values, points, 2, shape),
        }
        first = {
            "fwd": lambda: cases.first_form_fwd(images, points, 2),
            "adj": lambda: cases.first_form_adj(values, points, 2, shape),
        }
        order = []
        for tag, lib in libs.items():
            with loaded("interp", lib):
                interp.reset_fallback_warps(device)
                errs = {
                    name: cases._max_rel(fn(), want_fwd if name == "fwd" else want_adj)[1]
                    for name, fn in calls.items()
                }
                fallback = interp.fallback_warps(device)
            right = errs["fwd"] <= cases.FWD_TOL and errs["adj"] <= cases.ADJ_TOL
            if right or "(time only)" in tag:
                order.append(tag)
            print(f"{case}: {tag}: {'right' if right else 'WRONG'} (max|err| / max|value|: "
                  + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
                  + f"; adjoint fallback warps {fallback})", flush=True)
        order.append("first form")
        times = {tag: {name: [] for name in calls} for tag in order}
        for turn in (order, order[::-1], order):
            for tag in turn:
                if tag == "first form":
                    for name, fn in first.items():
                        times[tag][name].append(graph_ms(fn, reps=5))
                    continue
                with loaded("interp", libs[tag]):
                    for name, fn in calls.items():
                        times[tag][name].append(graph_ms(fn, reps=5))
        for tag in order:
            line = "; ".join(
                f"{name} " + ", ".join(f"{t:.4f}" for t in ts) + f" ms (median {statistics.median(ts):.4f})"
                for name, ts in times[tag].items()
            )
            print(f"{case}: {tag:44s} {line}", flush=True)


SWEEPS = {
    "usfft": (SOURCE, _sweep_usfft),
    "gaussian": (GAUSSIAN_SOURCE, lambda libs, device: (_sweep_gaussian(libs, device),
                                                        _sweep_gaussian_wide(libs, device))),
    "gaussian_wide": (GAUSSIAN_SOURCE, _sweep_gaussian_wide),
    "probe": (PROBE_SOURCE, _sweep_probe),
    "bucket": (BUCKET_SOURCE, _sweep_bucket),
    "interp": (INTERP_SOURCE, _sweep_interp),
}


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
    variants = {"usfft": lambda s: VARIANTS, "gaussian": gaussian_variants,
                "gaussian_wide": gaussian_variants, "probe": probe_variants,
                "bucket": bucket_variants, "interp": interp_variants}[args.source](source)
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
        name = "usfft_gaussian" if args.source.startswith("gaussian") else args.source
        libs, failed = finish_builds(name, start_builds(name, sources, directory))
        for tag, error in failed.items():
            print(f"{tag}: build failed\n{error}")
        sweep(libs, device)


if __name__ == "__main__":
    main()
