"""Times the host waited for the device inside the program's calls, a
solver step: CUDA runtime synchronisations and blocking copies that lie in
an ``iterate`` span (the benchmark's own wait after each call lies outside)."""

from tracing import SYNC_CALLS


def read(t):
    if not t.steps or not t.iterate:
        return None
    n = sum(
        1
        for name, ts, _ in t.runtime
        if name in SYNC_CALLS and any(lo <= ts < hi for lo, hi in t.iterate)
    )
    return n / t.steps
