"""The reader of the far-field kernel's time (``metrics/farplane_ms_per_step.py``)
on hand-built traces: nothing where the program has no such kernel, else its
device milliseconds over the steps."""

import pytest

import tiny  # noqa: F401  (the harness on the path)
import tracing
from metrics import farplane_ms_per_step

KERNEL = "void (anonymous namespace)::farplane_gaussian_kernel<2, 3>(float const*, float const*, unsigned char const*, float*, float*, int, int, float)"


def view(device, steps=2):
    """A trace of device events (category, name, start us, duration us)."""
    return tracing.TraceView(
        window_us=1000.0,
        device=list(device),
        runtime=[],
        host=[],
        iterate=[(0.0, 1000.0)],
        steps=steps,
        window_peak_bytes=0,
    )


def test_nothing_read_without_the_kernel():
    """The parent's trace: the ATen chain's kernels, no far-field kernel;
    and a trace with the kernel but no steps."""
    aten = [
        ("kernel", "void at::native::vectorized_elementwise_kernel<4, at::native::sqrt_kernel_cuda>", 0.0, 50.0),
        ("kernel", "void at::native::reduce_kernel<512, 1>", 60.0, 20.0),
        ("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 90.0, 5.0),
    ]
    assert farplane_ms_per_step.read(view(aten)) is None
    assert farplane_ms_per_step.read(view([("kernel", KERNEL, 0.0, 10.0)], steps=0)) is None


def test_kernel_ms_over_the_steps():
    device = [
        ("kernel", KERNEL, 0.0, 300.0),
        ("kernel", KERNEL.replace("<2, 3>", "<1, 0>"), 400.0, 500.0),
        ("kernel", "void at::native::reduce_kernel<512, 1>", 950.0, 40.0),
    ]
    assert farplane_ms_per_step.read(view(device, steps=4)) == pytest.approx(0.2)


def test_the_kernel_counts_as_elementwise():
    """``tracing.CLASSES`` files the kernel with the elementwise chain it
    replaces, so ``elementwise_ms_per_step`` keeps reading the same work."""
    assert tracing.kernel_class("kernel", KERNEL) == "elementwise"
