"""Reads of device values by the host inside the program, a solver step:
its ``tike.host_read`` spans (each also counted in ``opt.HOST_READS``)."""

from metrics._spans import spans


def read(t):
    reads = spans(t, "tike.host_read")
    if reads is None:
        return None
    return len(reads) / t.steps
