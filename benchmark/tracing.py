"""The traced run: ``torch.profiler`` over a bounded run of calls after the
warm-up, read into a :class:`TraceView` that the per-layer metrics of
``metrics/`` read, and the ``breakdown`` of the result line.

The kernel classes are a frozen copy of the port's profiling classes
(``profile_epoch.CLASSES``): the yardstick changes only with the benchmark.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile
import typing

import torch

# (class, substrings of "<category> <kernel name>", lower case); first match.
CLASSES = (
    ("patch_fwd_kernel", ("patch_fwd_kernel",)),
    ("patch_adj_kernel", ("patch_adj_kernel",)),
    ("copies from the host", ("memcpy htod",)),
    ("cufft", ("fft",)),
    ("sort, index, cat, memset, memcpy", ("sort", "index", "cat", "memset", "memcpy")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("",)),
)

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
# Runtime calls that make the host wait for the device.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")

CALL_SPAN = "bench.call"
ITERATE_SPAN = "bench.iterate"


def kernel_class(category: str, name: str) -> str:
    key = f"{category} {name}".lower()
    return next(c for c, keys in CLASSES if any(k in key for k in keys))


Event = typing.Tuple[str, float, float]  # name, start us, duration us


@dataclasses.dataclass
class TraceView:
    """What the traced calls left, in microseconds of one clock.

    ``device``: (category, name, start, duration) of every kernel, copy and
    memset inside the window; ``runtime``: CUDA runtime calls; ``host``:
    the host's torch operations; ``iterate``: the spans of the program's
    calls; ``steps``: solver steps traced; ``bounds``: the least seconds a
    step's work needs, by kernel, from the benchmark's own counts.
    """

    window_us: float
    device: typing.List[typing.Tuple[str, str, float, float]]
    runtime: typing.List[Event]
    host: typing.List[Event]
    iterate: typing.List[typing.Tuple[float, float]]
    steps: int
    window_peak_bytes: int
    bounds: typing.Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def busy_us(self) -> float:
        return sum(hi - lo for lo, hi in self.busy_intervals())

    def busy_intervals(self) -> typing.List[typing.Tuple[float, float]]:
        merged = []
        for _, _, ts, dur in sorted(self.device, key=lambda e: e[2]):
            if merged and ts <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], ts + dur)
            else:
                merged.append([ts, ts + dur])
        return [tuple(m) for m in merged]

    def kernels(self, substring: str = "") -> typing.List[typing.Tuple[str, str, float, float]]:
        return [e for e in self.device if e[0] == "kernel" and substring in e[1]]

    def device_ms_by_class(self) -> typing.Dict[str, float]:
        out = collections.defaultdict(float)
        for cat, name, _, dur in self.device:
            out[kernel_class(cat, name)] += dur / 1e3
        return dict(out)


def capture(call: typing.Callable[[], None], sync: typing.Callable[[], None], calls: int) -> dict:
    """Run ``calls`` calls under the profiler, each in a ``bench.call`` span
    that holds the program's call (``bench.iterate``) and the wait for the
    device; return the chrome trace's events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            with record_function(CALL_SPAN):
                with record_function(ITERATE_SPAN):
                    call()
                sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def view(events: list, steps: int, window_peak_bytes: int, bounds: dict) -> TraceView:
    """The window (first call's start to last call's end) and what lies in it."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == CALL_SPAN]
    if not spans:
        raise RuntimeError("the trace holds no call span")
    lo = min(e["ts"] for e in spans)
    hi = max(e["ts"] + e["dur"] for e in spans)

    def inside(e):
        return e.get("ph") == "X" and lo <= e["ts"] and e["ts"] + e.get("dur", 0) <= hi

    device = [(e["cat"], e["name"], e["ts"], e["dur"]) for e in events if e.get("cat") in DEVICE and inside(e)]
    runtime = [(e["name"], e["ts"], e["dur"]) for e in events if e.get("cat") == "cuda_runtime" and inside(e)]
    host = [
        (e["name"], e["ts"], e["dur"])
        for e in events
        if e.get("cat") in ("cpu_op", "user_annotation") and inside(e) and e["name"] != CALL_SPAN
    ]
    iterate = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("ph") == "X" and e.get("name") == ITERATE_SPAN]
    return TraceView(hi - lo, device, runtime, host, iterate, steps, window_peak_bytes, bounds)


def breakdown(t: TraceView, top: int = 10, short_us: float = 20.0) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing, in seconds: gaps under ``short_us`` together
    (launch gaps); each longer one by the innermost host operation open at
    its middle, or, where none is, as host code after the last operation
    that ended before it."""
    ops = collections.defaultdict(float)
    for _, name, _, dur in t.device:
        ops[name] += dur / 1e6
    gaps = collections.defaultdict(float)
    busy = t.busy_intervals()
    lo = min(s for s, _ in t.iterate) if t.iterate else (busy[0][0] if busy else 0.0)
    edges = [(lo, lo)] + busy
    hosts = sorted(t.host, key=lambda e: e[1])
    starts = [h[1] for h in hosts]
    for (_, end), (start, _) in zip(edges, edges[1:]):
        if start <= end:
            continue
        if start - end < short_us:
            gaps[f"launch gaps under {short_us:g} us"] += (start - end) / 1e6
            continue
        mid = 0.5 * (start + end)
        i = bisect.bisect_right(starts, mid)
        label, last = None, None
        for h in reversed(hosts[max(0, i - 400) : i]):
            if h[1] + h[2] > mid and h[0] != ITERATE_SPAN:
                label = h[0]
                break
            if last is None and h[1] + h[2] <= mid:
                last = h[0]
        if label is None:
            label = f"host code after {last}" if last else "host code"
        gaps[label] += (start - end) / 1e6

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}
