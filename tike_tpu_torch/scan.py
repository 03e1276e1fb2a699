"""Scanning trajectory generators (positions as functions of time).

Counterpart of :mod:`tike_tpu.scan`, host numpy as there: periodic 1D basis
functions (sinusoid, triangle, sawtooth, square, staircase) composed into 2D
scan patterns (lissajous, raster, spiral, diagonal, billiard, hexagonal).
Trajectories are inputs to the solvers, not hot code.
"""

__all__ = [
    "scantimes",
    "sinusoid",
    "triangle",
    "triangle_fs",
    "sawtooth",
    "square",
    "staircase",
    "lissajous",
    "raster",
    "spiral",
    "diagonal",
    "scan3",
    "avgspeed",
    "lengths",
    "distance",
    "billiard",
    "hexagonal",
]

import numpy as np


def f2w(f):
    """Angular frequency [rad/s] from frequency [Hz]."""
    return 2 * np.pi * f


def period(f):
    """Period [s] from frequency [Hz]."""
    return 1 / f


def scantimes(t0, t1, f=60):
    """Times in [t0, t1) sampled at frequency f."""
    return np.linspace(t0, t1, int((t1 - t0) * f), endpoint=False)


def sinusoid(A, f, p, t):
    """Sine wave with amplitude A, frequency f, phase p. #continuous #1d"""
    return A * np.sin(f2w(f) * t - p)


def triangle(A, f, p, t):
    """Triangle wave via arcsin of sin. #continuous #1d"""
    return A * (2 / np.pi) * np.arcsin(np.sin(f2w(f) * t - p))


def triangle_fs(A, f, p, t, N=8):
    """Triangle wave approximated by an N-term Fourier series. #continuous"""
    w = f2w(f)
    x = np.sin(w * t - p)
    for n in range(3, 2 * N, 2):
        x = x + (-1) ** ((n - 1) / 2) / (n * n) * np.sin(n * (w * t - p))
    return A * (8 / np.pi**2) * x


def sawtooth(A, f, p, t):
    """Sawtooth wave in [-A, A). #discontinuous #1d"""
    ts = t * f - p / (2 * np.pi)
    return A * 2 * (ts - np.floor(ts + 0.5))


def square(A, f, p, t):
    """Square wave alternating +/- A. #discontinuous #1d"""
    ts = t - p / (2 * np.pi) / f
    return A * np.power(-1, np.floor(2 * f * ts))


def staircase(A, f, p, t):
    """Staircase: A * floor(f*t - p/2pi). #discontinuous #1d"""
    return A * np.floor(t * f - p / (2 * np.pi))


def lissajous(A, B, fx, fy, px, py, t):
    """Lissajous figure centered on the origin. #continuous #2d"""
    return sinusoid(A, fx, px, t), sinusoid(B, fy, py, t)


def billiard(Ax, Ay, fx, fy, px, py, t, N):
    """Frictionless-ball trajectory: a triangle-wave lissajous. #continuous"""
    return triangle_fs(Ax, fx, px, t, N), triangle_fs(Ay, fy, py, t, N)


def raster(A, B, f, x0, y0, t):
    """Serpentine raster starting at (x0, y0). #discontinuous #2d"""
    x = 0.5 * (triangle(A, 0.5 * f, 0.5 * np.pi, t) + A) + x0
    y = staircase(B, f, 0, t) + y0
    return x, y


def spiral(r1, t1, v, t):
    """Constant-linear-velocity spiral reaching radius r1 at time t1.

    #continuous #2d (Bazaei et al. 2017, doi:10.1109/CCTA.2017.8062452)
    """
    P = np.pi * r1 * r1 / t1 / v
    r = np.sqrt(P * v * t / np.pi)
    theta = 2 * np.sqrt(np.pi * v * t / P)
    return r * np.cos(theta), r * np.sin(theta)


def diagonal(A, B, fx, fy, px, py, t):
    """Diagonal triangle-wave scan centered on the origin. #discontinuous"""
    return (
        triangle(A, fx, px + np.pi / 2, t),
        triangle(B, fy, py + np.pi / 2, t),
    )


def scan3(A, B, fx, fy, fz, px, py, time, hz):
    """A 3D combination of lissajous and sawtooth trajectories."""
    x, y = lissajous(A, B, fx, fy, px, py, time)
    z = sawtooth(np.pi, 0.5 * fz, 0.5 * np.pi, time)
    return z, x, y


def hexagonal(t, D, f, row):
    """Hexagonal gridded step scan of circles of diameter D. #discontinuous"""
    h = 0.5 * np.sqrt(3) * D
    x1 = staircase(A=h, f=f / row, p=0, t=t)
    x2 = (
        np.mod(staircase(A=D, f=f, p=0, t=t), row * D)
        + square(A=D * 0.25, f=f / row * 0.5, p=np.pi, t=t)
        + D * 0.25
    )
    return x1, x2


def lengths(x, y=None, z=None):
    """Absolute displacements between consecutive trajectory points."""
    y = np.zeros_like(x) if y is None else y
    z = np.zeros_like(x) if z is None else z
    a, b, c = np.diff(x), np.diff(y), np.diff(z)
    return np.sqrt(a * a + b * b + c * c)


def distance(x, y=None, z=None):
    """Total distance travelled along the trajectory."""
    return np.sum(lengths(x, y, z))


def avgspeed(time, x, y=None, z=None):
    """Average speed along the trajectory covered in the given time."""
    return distance(x, y, z) / time
