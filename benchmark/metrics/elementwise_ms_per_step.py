"""Device milliseconds a solver step in the elementwise and reduction
kernel classes (``tracing.CLASSES``)."""


def read(t):
    by_class = t.device_ms_by_class()
    ms = by_class.get("elementwise", 0.0) + by_class.get("reductions", 0.0)
    if not t.steps or ms == 0:
        return None
    return ms / t.steps
