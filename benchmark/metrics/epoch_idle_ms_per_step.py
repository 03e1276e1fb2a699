"""Milliseconds a solver step in which the device sat idle while the host
enqueued an epoch: over the program's ``tike.epoch`` spans, each span's
length less the device's busy time inside it."""

import bisect

from metrics._spans import spans


def read(t):
    epochs = spans(t, "tike.epoch")
    if not epochs:
        return None
    busy = t.busy_intervals()
    ends = [hi for _, hi in busy]
    idle = 0.0
    for lo, hi in epochs:
        covered = 0.0
        for b_lo, b_hi in busy[bisect.bisect_right(ends, lo) :]:
            if b_lo >= hi:
                break
            covered += min(hi, b_hi) - max(lo, b_lo)
        idle += hi - lo - covered
    return idle / 1e3 / t.steps
