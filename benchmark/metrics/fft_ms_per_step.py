"""Device milliseconds a solver step in cuFFT's kernels (``tracing.CLASSES``)."""


def read(t):
    ms = t.device_ms_by_class().get("cufft", 0.0)
    if not t.steps or ms == 0:
        return None
    return ms / t.steps
