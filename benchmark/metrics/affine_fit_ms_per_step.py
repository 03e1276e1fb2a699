"""Host milliseconds a solver step in the affine position fit, the
program's ``tike.position.affine_fit`` spans."""

from metrics._spans import spans


def read(t):
    fits = spans(t, "tike.position.affine_fit")
    if not fits:
        return None
    return sum(hi - lo for lo, hi in fits) / 1e3 / t.steps
