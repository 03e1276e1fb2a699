"""The port's spans (``tike_tpu_torch.trace``) on the CPU.

With no profiler recording, ``span`` never enters ``record_function``.
Under a CPU ``torch.profiler.profile``, a small ``Reconstruction`` leaves
the spans of its call in the chrome trace, as the benchmark reads them: one
``tike.iterate`` a call, a ``tike.epoch`` an epoch holding that epoch's
``tike.epoch.begin``, ``tike.batch`` spans and ``tike.epoch.end``, the
affine position fit, and as many ``tike.host_read`` spans as
``opt.HOST_READS`` counted, all properly nested, on one device, on a
two-shard mesh and on two stripes of the striped object.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tike_tpu_torch.parallel as tpar
import tike_tpu_torch.ptycho as tp
from tike_tpu_torch import opt, trace
from tike_tpu_torch.parallel import Sum, run_shards

from . import _torch_parity as H

DET = 16
NUM_BATCH = 2


def _inputs():
    scan, _, probe, psi0 = H.slice_inputs(seed=3, h=64, p=DET, npos=40)
    psi_true = H.slice_inputs(seed=3, h=64, p=DET, npos=40)[1]
    data = tp.simulate(DET, probe, scan, psi_true, device="cpu")
    return scan, probe, psi0, data


def _parameters(scan, probe, psi0, solver, positions, time_limit=np.inf):
    options = tp.LstsqOptions if solver == "lstsq" else tp.RpieOptions
    return tp.PtychoParameters(
        probe=probe,
        psi=psi0,
        scan=scan,
        algorithm_options=options(
            num_batch=NUM_BATCH, batch_method="compact", time_limit=time_limit
        ),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
        position_options=(
            tp.PositionOptions(initial_scan=scan, update_magnitude_limit=1.0)
            if positions
            else None
        ),
    )


def _reads() -> int:
    return sum(v for k, v in opt.HOST_READS.items() if k != "line_search")


def _spans(prof, path) -> list:
    """The ``tike.*`` spans of the profiler's chrome trace, as the
    benchmark reads them: (name, start, end), sorted by start, outer first."""
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [
        (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("tike.")
    ]
    return sorted(spans, key=lambda s: (s[1], -s[2]))


def _traced(tmp_path, run):
    """Run ``run()`` under a CPU profiler; return its spans and the host
    reads counted meanwhile."""
    before = _reads()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return _spans(prof, tmp_path / "trace.json"), _reads() - before


def _tree(spans) -> list:
    """Each span with the names of the spans that hold it, outermost first;
    fails where two spans overlap without one holding the other."""
    stack, out = [], []
    for name, lo, hi in spans:
        while stack and stack[-1][2] <= lo:
            stack.pop()
        if stack:
            assert hi <= stack[-1][2], f"{name} [{lo}, {hi}] crosses the end of {stack[-1]}"
        out.append((name, [s[0] for s in stack]))
        stack.append((name, lo, hi))
    return out


def _count(spans, name) -> int:
    return sum(1 for s in spans if s[0] == name)


def _check_call(spans, reads, epochs, fits):
    tree = _tree(spans)
    assert _count(spans, "tike.iterate") == 1
    assert _count(spans, "tike.epoch") == epochs
    assert _count(spans, "tike.epoch.begin") == epochs
    assert _count(spans, "tike.batch") == epochs * NUM_BATCH
    assert _count(spans, "tike.epoch.end") == epochs
    assert _count(spans, "tike.position.affine_fit") == fits
    assert _count(spans, trace.HOST_READ) == reads > 0
    for name, holders in tree:
        if name != "tike.iterate":
            assert holders[:1] == ["tike.iterate"], (name, holders)
        if name in ("tike.epoch.begin", "tike.batch", "tike.epoch.end"):
            assert holders[-1] == "tike.epoch", (name, holders)
        if name in ("tike.epoch", "tike.position.affine_fit"):
            assert holders == ["tike.iterate"], (name, holders)
    return tree


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def test_span_is_free_without_a_profiler(monkeypatch, inputs):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert trace.span("tike.iterate") is trace.span("tike.epoch")
    with trace.span("tike.x"):
        pass
    before = opt.HOST_READS["ptycho.costs"]
    with trace.host_read("ptycho.costs"):
        pass
    assert opt.HOST_READS["ptycho.costs"] == before + 1
    scan, probe, psi0, data = inputs
    params = _parameters(scan, probe, psi0, "lstsq", positions=True)
    with tp.Reconstruction(data, params, device="cpu", random_seed=0) as context:
        context.iterate(1)


@pytest.mark.parametrize(
    "solver, positions, time_limit, fits",
    [
        ("lstsq", True, np.inf, 1),  # fused: one fit after the call
        ("rpie", False, np.inf, 0),  # fused, no positions
        ("lstsq", True, 1e9, 2),  # per epoch: a fit after each epoch
        ("rpie", False, 1e9, 0),  # per epoch
    ],
    ids=["lstsq-fused", "rpie-fused", "lstsq-per-epoch", "rpie-per-epoch"],
)
def test_a_call_leaves_its_spans(tmp_path, inputs, solver, positions, time_limit, fits):
    scan, probe, psi0, data = inputs
    params = _parameters(scan, probe, psi0, solver, positions, time_limit)
    with tp.Reconstruction(data, params, device="cpu", random_seed=0) as context:
        assert context._fused_eligible() == (time_limit == np.inf)
        spans, reads = _traced(tmp_path, lambda: context.iterate(2))
    _check_call(spans, reads, epochs=2, fits=fits)


def test_spans_nest_on_a_two_shard_mesh(tmp_path, inputs):
    scan, probe, psi0, data = inputs
    params = _parameters(scan, probe, psi0, "lstsq", positions=True)
    mesh = tpar.make_mesh(devices=["cpu"] * 2)
    with tp.Reconstruction(data, params, device="cpu", random_seed=0, mesh=mesh) as context:
        spans, reads = _traced(tmp_path, lambda: context.iterate(2))
    _check_call(spans, reads, epochs=2, fits=1)


def test_spans_nest_on_two_stripes(tmp_path, inputs):
    """A striped epoch runs each stripe's epoch as a generator that yields
    at the stripes' reductions: each stripe's begin, batches and end lie in
    the epoch's span, the end in a span a stretch between two requests."""
    scan, probe, psi0, data = inputs
    params = _parameters(scan, probe, psi0, "rpie", positions=False)
    mesh = tpar.make_mesh(devices=["cpu"] * 2)
    with tp.Reconstruction(
        data, params, device="cpu", random_seed=0, mesh=mesh, object_sharding="striped"
    ) as context:
        spans, reads = _traced(tmp_path, lambda: context.iterate(2))
    tree = _tree(spans)
    assert _count(spans, "tike.iterate") == 1
    assert _count(spans, "tike.epoch") == 2
    assert _count(spans, "tike.epoch.begin") == 2 * 2
    assert _count(spans, "tike.batch") == 2 * 2 * NUM_BATCH
    assert _count(spans, "tike.epoch.end") >= 2 * 2
    assert _count(spans, trace.HOST_READ) == reads > 0
    for name, holders in tree:
        if name in ("tike.epoch.begin", "tike.batch", "tike.epoch.end"):
            assert holders[:2] == ["tike.iterate", "tike.epoch"] and len(holders) == 2, (name, holders)


def test_a_generator_span_closes_at_each_yield(tmp_path):
    """Two shards' generators driven in lockstep: each stretch between two
    requests is a span of its own, so the spans of the two shards never
    overlap, and what the generator returns comes back."""

    @trace.spanned("tike.test")
    def steps(x):
        total = yield Sum(torch.tensor(x))
        total = yield Sum(total * 2)
        return float(total)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = run_shards(["cpu", "cpu"], [steps(1.0), steps(2.0)])
    spans = _spans(prof, tmp_path / "trace.json")
    assert got == [12.0, 12.0]
    assert [s[0] for s in spans] == ["tike.test"] * 6
    assert all(not holders for _, holders in _tree(spans))

