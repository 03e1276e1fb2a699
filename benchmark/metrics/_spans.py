"""Shared by the metrics that read the program's own spans (``tike.*``, the
port's ``tike_tpu_torch.trace``), which the traced window's host events
hold as ``user_annotation``s. A program without them (a checkout before
the port had spans) has no ``tike.iterate`` span, and these metrics read
nothing there."""

ITERATE = "tike.iterate"


def spans(t, name):
    """(start, end) in microseconds of every ``name`` span in the window,
    or ``None`` where the program opened no span at all."""
    if not t.steps or not any(n == ITERATE for n, _, _ in t.host):
        return None
    return [(ts, ts + dur) for n, ts, dur in t.host if n == name]
