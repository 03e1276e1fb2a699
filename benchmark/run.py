#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the CUDA card of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything about a cell is data, found by the names in ``BENCHMARK.json``:
its configuration (``configs/<config>.json``, whose ``family`` names the
input maker ``families/<family>.py``), its traffic mix
(``traffic/<traffic>.json``), the limits of its check
(``limits/<cell>.json``) and its per-layer metrics (``metrics/<name>.py``).

Set-up (timed from the process's start) builds the program's kernels, makes
every input on the card from the seed, enters the program and drives its
first calls. With ``--trace 0`` the window then issues the mix's call back
to back for ``--seconds`` seconds, one closed-loop client, and the result
carries the cell's end-to-end metrics; with ``--trace 1`` a bounded run of
calls is profiled instead, and the result carries the per-layer metrics.
Either way, once the window has closed and the program's state is freed,
the plain reference follows the set-up's calls and decides ``correct``.
The last line of standard output is the result, one JSON object.
"""

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (str(HERE), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0 if _p == str(HERE) else 1, _p)

import torch  # noqa: E402

import tracing  # noqa: E402

# Top-level module names that no run may load, compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "tike_tpu")
# The repository's scripts that measure the JAX package.
REPO_SCRIPTS = ("bench", "bench_all", "chip_smoke", "profile")


def forbidden_modules() -> list:
    """The forbidden modules in ``sys.modules``, by top-level name."""
    found = {name.split(".")[0] for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN}
    for name in REPO_SCRIPTS:
        module = sys.modules.get(name)
        where = [getattr(module, "__file__", None) or ""] + list(getattr(module, "__path__", []) or [])
        if module is not None and any(str(w).startswith(str(ROOT) + os.sep) for w in where):
            found.add(name)
    return sorted(found)


def load_spec(workload: str) -> dict:
    """Everything a cell names, found by name."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(cells)}")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    # An end-to-end metric holds in every cell unless it lists its cells;
    # a per-layer metric always lists them.
    end_to_end = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    per_layer = [m for m in bench["per_layer"] if workload in m["workloads"]]
    return dict(
        cell=cell,
        config=config,
        traffic=traffic,
        limits=limits,
        end_to_end=end_to_end,
        per_layer=per_layer,
        readers={m["name"]: importlib.import_module(f"metrics.{m['name']}") for m in per_layer},
        family=importlib.import_module(f"families.{config['family']}"),
    )


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20,
        )
        return out.stdout.strip() or out.stderr.strip()[:100]
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unread: {exc}"[:100]


def _p95(values):
    return statistics.quantiles(values, n=100, method="inclusive")[94] if len(values) > 1 else values[0]


def run(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda"):
    """One run of the cell; returns the result dict (``check`` last)."""
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    parts = {}
    if cuda:
        torch.cuda.init()
        sync()
        parts["process_and_cuda_s"] = time.time() - PROCESS_START
        from tike_tpu_torch import kernels

        start = time.perf_counter()
        for name in spec["config"].get("kernels", []):
            kernels.build_all([name])
            kernels.load(name)
        parts["build_s"] = time.perf_counter() - start
    seed = int(seed) % 2**63
    session = spec["family"].setup(spec["config"], spec["traffic"], seed, device, spec["limits"])
    parts.update(session.parts)
    parts.update({f"program_{k}": v for k, v in session.program_parts.items()})
    setup_s = time.time() - PROCESS_START
    print("setup parts (s): " + json.dumps(parts), flush=True)

    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    per_call = session.epochs_per_call
    metrics, extra, breakdown = {}, {}, None
    if not trace:
        times = []
        t0 = time.perf_counter()
        while True:
            c0 = time.perf_counter()
            session.call()
            sync()
            c1 = time.perf_counter()
            times.append(c1 - c0)
            if c1 - t0 >= seconds:
                break
        window_s = c1 - t0
        steps = len(times) * per_call
        if cuda:
            peak = max(peak, torch.cuda.max_memory_allocated())
        values = {
            "setup_s": setup_s,
            "step_s": window_s / steps,
            "call_p95_s": _p95(times),
            "peak_mem_gib": peak / 2**30,
        }
        attempted = len(times)
        print(
            f"window {window_s:.4f} s: {len(times)} calls of {per_call} step(s), {steps} steps; "
            f"{spec['config'].get('n_patterns', 0) * steps / window_s:.1f} patterns/s; "
            f"call median {statistics.median(times):.6f} s",
            flush=True,
        )
    else:
        calls = int(spec["traffic"]["trace_calls"])
        events = tracing.capture(session.call, sync, calls)
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        peak = max(peak, window_peak)
        t = tracing.view(events, calls * per_call, window_peak, session.patch_bounds())
        values = {}
        for name, reader in spec["readers"].items():
            value = reader.read(t)
            if value is not None:
                values[name] = value
        extra = {"busy_s": t.busy_us / 1e6, "window_s": t.window_us / 1e6}
        breakdown = tracing.breakdown(t)
        attempted = calls
        print(f"traced {calls} calls, {calls * per_call} steps, window {t.window_us / 1e6:.6f} s", flush=True)
    for m in spec["per_layer"] if trace else spec["end_to_end"]:
        if m["name"] in values:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    loaded = forbidden_modules()
    if loaded:
        raise ForbiddenModules(loaded)
    session.close()
    start = time.perf_counter()
    check = session.check()
    print(f"reference check {time.perf_counter() - start:.2f} s", flush=True)
    correct = bool(check.pop("correct"))
    print("check detail: " + json.dumps(check.pop("detail", {})), flush=True)
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": int(spec["cell"]["chips"]),
        "memory_peak_bytes": int(peak),
        "power_limit": power_limit() if cuda else "none",
    }
    device_info.update(extra)
    result = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = check
    return result


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    spec = load_spec(args.workload)
    loaded = forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 4
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {chips} CUDA card(s); found {count}", file=sys.stderr)
        return 3
    try:
        result = run(spec, args.seed, args.seconds, bool(args.trace))
    except ForbiddenModules as exc:
        print(f"forbidden modules loaded once the window closed: {exc.args[0]}", file=sys.stderr)
        return 4
    for name, c in result["check"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
