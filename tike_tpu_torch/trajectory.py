"""Discretized trajectories and coded-exposure intersection.

Counterpart of :mod:`tike_tpu.trajectory`, host numpy as there: adaptive
sampling of a continuous trajectory to satisfy spatial/temporal step
constraints, plus binning of measurements into coded-exposure windows.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)


def euclidian_dist(theta, v, h, r=0.5):
    """Euclidean distance between consecutive (theta, v, h) points."""
    dr = np.diff(theta) * r
    dv = np.diff(v)
    dh = np.abs(np.diff(h)) + np.abs(dr * np.cos(theta[:-1]))
    return np.sqrt(dv * dv + dh * dh)


def euclidian_dist_approx(theta, v, h, r=0.75):
    """Approximate distance: arclength plus in-plane displacement."""
    t1 = np.diff(theta)
    v1 = np.diff(v)
    h1 = np.diff(h)
    return np.abs(t1) * r + np.sqrt(v1**2 + h1**2)


def discrete_trajectory(trajectory, tmin, tmax, xstep, tstep, tkwargs=None):
    """Linear approximation of trajectory with bounded steps.

    Adaptively samples so consecutive positions differ by less than xstep and
    consecutive times by less than tstep. Returns (theta, v, h, dwell, time).
    """
    tkwargs = {} if tkwargs is None else tkwargs
    dist_func = euclidian_dist_approx
    parts = _discrete_helper(
        trajectory, tmin, tmax, xstep, tstep, dist_func, tkwargs
    )
    theta = np.concatenate([p[0] for p in parts])
    v = np.concatenate([p[1] for p in parts])
    h = np.concatenate([p[2] for p in parts])
    times = np.concatenate([p[3] for p in parts])
    dwell = np.empty(times.size)
    dwell[:-1] = np.diff(times)
    dwell[-1] = tmax - times[-1]
    return theta, v, h, dwell, times


def _discrete_helper(trajectory, tmin, tmax, xstep, tstep, dist_func, tkwargs):
    """Recursively sample: halve tstep where spatial steps are too large."""
    out = []
    times = np.arange(tmin, tmax + tstep, tstep)
    theta, v, h = trajectory(times, **tkwargs)
    distances = dist_func(theta, v, h)
    ok = xstep > distances
    i = 0
    n = ok.size
    while i < n:
        j = i
        if ok[i]:
            while j < n and ok[j]:
                j += 1
            out.append((theta[i:j], v[i:j], h[i:j], times[i:j]))
        else:
            while j < n and not ok[j]:
                j += 1
            out += _discrete_helper(
                trajectory,
                times[i],
                times[j],
                xstep,
                tstep / 2,
                dist_func,
                tkwargs,
            )
        i = j
    return out


def monotonic(x):
    """True if x is monotonically increasing."""
    return np.all(np.diff(x) >= 0)


def has_overlap(x0, xd, y0, yd):
    """True if the ranges [x0, x0+xd] and [y0, y0+yd] overlap."""
    return x0 + xd >= y0 and y0 + yd >= x0


def get_overlap(x0, xd, y0, yd):
    """Return (lo, width) of the overlap of two ranges."""
    lo = max(x0, y0)
    width = min(x0 + xd, y0 + yd) - lo
    assert width >= 0, "These two ranges don't actually overlap"
    return lo, width


def coded_exposure(theta, v, h, time, dwell, c_time, c_dwell):
    """Intersect a scanning procedure with a coded exposure.

    Bins measurements into exposure windows (a measurement spanning several
    windows lands in all of them), reordering so measurements in the same
    code are bundled. Returns (theta, v, h, time, dwell, bundles).
    """
    assert monotonic(time)
    assert monotonic(c_time)
    if not has_overlap(
        time[0],
        dwell[-1] + time[-1] - time[0],
        c_time[0],
        c_dwell[-1] + c_time[-1] - c_time[0],
    ):
        raise ValueError("Codes don't overlap measurements.")

    start = 0
    times, dwells, positions, codes = [], [], [], []
    for m in range(time.size):
        found = False
        for c in range(start, c_time.size):
            if has_overlap(time[m], dwell[m], c_time[c], c_dwell[c]):
                t1, d1 = get_overlap(time[m], dwell[m], c_time[c], c_dwell[c])
                if d1 > 0:
                    codes.append(c)
                    positions.append(m)
                    times.append(t1)
                    dwells.append(d1)
                    if not found:
                        found = True
                        start = c
            elif found:
                break
    order = np.argsort(codes)
    codes = np.array(codes)[order]
    positions = np.array(positions)[order]
    times1 = np.array(times)[order]
    dwells1 = np.array(dwells)[order]
    bundles = np.nonzero(np.diff(np.concatenate([[-1], codes])))[0]
    return (
        theta[positions],
        v[positions],
        h[positions],
        times1,
        dwells1,
        bundles,
    )
