"""The readers of the program's spans (``metrics/host_reads_per_step.py``,
``epoch_idle_ms_per_step.py``, ``affine_fit_ms_per_step.py``) on
hand-built traces: their arithmetic, and nothing read from a program
without spans."""

import pytest

import tiny  # noqa: F401  (the harness on the path)
import tracing
from metrics import affine_fit_ms_per_step, epoch_idle_ms_per_step, host_reads_per_step

READERS = (host_reads_per_step, epoch_idle_ms_per_step, affine_fit_ms_per_step)


def view(host, device=(), steps=2):
    """A trace of ``host`` events (name, start us, duration us) and device
    kernels (start us, duration us), ``steps`` solver steps."""
    return tracing.TraceView(
        window_us=1000.0,
        device=[("kernel", "k", ts, dur) for ts, dur in device],
        runtime=[],
        host=list(host),
        iterate=[(0.0, 1000.0)],
        steps=steps,
        window_peak_bytes=0,
    )


CALL = ("tike.iterate", 0.0, 1000.0)


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__.split(".")[-1])
def test_nothing_read_without_the_program_spans(reader):
    """The parent's trace: the benchmark's spans and torch operations, no
    ``tike.*``; and a trace with no steps."""
    plain = view([("bench.iterate", 0.0, 1000.0), ("aten::mul", 10.0, 5.0)], [(10.0, 100.0)])
    assert reader.read(plain) is None
    assert reader.read(view([CALL, ("tike.epoch", 0.0, 10.0)], steps=0)) is None


def test_host_reads_count_the_spans_a_step():
    t = view([CALL] + [("tike.host_read", 100.0 * k, 1.0) for k in range(3)] + [("aten::copy_", 5.0, 1.0)])
    assert host_reads_per_step.read(t) == 1.5
    assert host_reads_per_step.read(view([CALL])) == 0.0


def test_affine_fit_sums_its_host_time():
    t = view([CALL, ("tike.position.affine_fit", 100.0, 3000.0), ("tike.position.affine_fit", 5000.0, 1000.0)])
    assert affine_fit_ms_per_step.read(t) == pytest.approx(2.0)
    assert affine_fit_ms_per_step.read(view([CALL])) is None


@pytest.mark.parametrize(
    "epochs, device, idle_us",
    [
        # A busy interval straddling each edge of the span counts its inside.
        ([(100.0, 100.0)], [(50.0, 80.0), (180.0, 50.0)], 100.0 - 30.0 - 20.0),
        # Overlapping kernels are busy once.
        ([(100.0, 100.0)], [(120.0, 40.0), (130.0, 10.0), (150.0, 20.0)], 100.0 - 50.0),
        # A span with no kernel inside is idle throughout; kernels outside
        # every span, before and after, count nowhere.
        ([(100.0, 100.0), (400.0, 50.0)], [(0.0, 90.0), (300.0, 50.0), (900.0, 10.0)], 150.0),
        # A kernel covering the whole span: no idle.
        ([(100.0, 100.0)], [(0.0, 500.0)], 0.0),
    ],
    ids=["straddling", "overlapping", "empty-spans", "covered"],
)
def test_epoch_idle_is_span_less_busy(epochs, device, idle_us):
    t = view([CALL] + [("tike.epoch", ts, dur) for ts, dur in epochs], device, steps=2)
    assert epoch_idle_ms_per_step.read(t) == pytest.approx(idle_us / 1e3 / 2)
