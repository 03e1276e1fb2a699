"""Visualization helpers for solver outputs (matplotlib, host-side).

Counterpart of :mod:`tike_tpu.view`: complex-to-RGB rendering, probe power,
position error/convergence, cost convergence, eigen weights, scan
trajectory and coverage plots. Every function takes numpy arrays or
tensors (which it copies to the host) and imports ``matplotlib`` when
called, so this module imports without it.
"""

from __future__ import annotations

import numpy as np
import torch

from .precision import to_numpy

__all__ = [
    "complexHSV_to_RGB",
    "resize_complex_image",
    "plot_probe_power",
    "plot_probe_power_series",
    "plot_position_error",
    "plot_positions",
    "plot_positions_convergence",
    "plot_complex",
    "plot_phase",
    "trajectory",
    "plot_footprint",
    "plot_trajectories",
    "plot_cost_convergence",
    "plot_eigen_weights",
    "plot_affine_transform",
]


def _host(*xs):
    """The arguments with each tensor copied to the host as a numpy array;
    anything else passes through."""
    out = tuple(to_numpy(x) if isinstance(x, torch.Tensor) else x for x in xs)
    return out if len(out) > 1 else out[0]


def complexHSV_to_RGB(img0):
    """Render a complex array as RGB: phase -> hue, magnitude -> value."""
    img0 = _host(img0)
    import matplotlib.colors

    hsv = np.zeros((*img0.shape, 3), dtype=np.float32)
    hsv[..., 0] = (np.angle(img0) + np.pi) / (2 * np.pi)  # hue in [0, 1)
    hsv[..., 1] = 1.0
    mag = np.abs(img0)
    vmax = mag.max()
    hsv[..., 2] = mag / vmax if vmax > 0 else 0
    return matplotlib.colors.hsv_to_rgb(hsv)


def _lanczos_resample_matrix(n_in: int, n_out: int, a: int = 4):
    """Dense (n_out, n_in) Lanczos-a resampling matrix (rows normalized)."""
    scale = n_out / n_in
    center = (np.arange(n_out) + 0.5) / scale - 0.5
    t = center[:, None] - np.arange(n_in)[None, :]
    w = np.sinc(t) * np.sinc(t / a) * (np.abs(t) < a)
    return w / w.sum(axis=-1, keepdims=True)


def resize_complex_image(img0, scale_factor=(1, 1), interpolation=None):
    """Resize a complex image by (horizontal, vertical) scale factors.

    The (x, y) ordering is cv2.resize's:
    scale_factor[0] scales the last (width) axis, scale_factor[1] the
    second-to-last (height) axis.

    interpolation follows OpenCV's codes: None/0/1 =
    linear, 2 = cubic, 4 = Lanczos-4. Linear/cubic use scipy spline zoom on
    real and imaginary parts; Lanczos is a separable windowed-sinc resample
    (dense matrices, complex-safe) since scipy has no Lanczos kernel.
    """
    img0 = _host(img0)
    if interpolation == 4:
        h, w = img0.shape[-2:]
        hn = int(round(h * scale_factor[1]))
        wn = int(round(w * scale_factor[0]))
        ry = _lanczos_resample_matrix(h, hn)
        rx = _lanczos_resample_matrix(w, wn)
        return np.einsum("ay,...yx,bx->...ab", ry, img0, rx).astype(
            img0.dtype
        )

    import scipy.ndimage

    order = 1 if interpolation in (None, 0, 1) else 3
    zoom = (scale_factor[1], scale_factor[0])
    return (
        scipy.ndimage.zoom(img0.real, zoom, order=order, grid_mode=True,
                           mode="grid-constant")
        + 1j * scipy.ndimage.zoom(img0.imag, zoom, order=order,
                                  grid_mode=True, mode="grid-constant")
    ).astype(img0.dtype)


def plot_probe_power(probe):
    """Pie chart of the relative power of each probe mode."""
    probe = _host(probe)
    import matplotlib.pyplot as plt

    power = np.sum(np.square(np.abs(probe)), axis=(-2, -1)).flatten()
    plt.pie(power / power.sum(), labels=[f"{i}" for i in range(len(power))])
    plt.title("relative probe power")


def plot_probe_power_series(power):
    """Plot probe mode power across epochs. power: list of per-mode arrays."""
    import matplotlib.pyplot as plt

    series = np.stack([_host(p).flatten() for p in power])
    norm = series / series.sum(axis=-1, keepdims=True)
    for m in range(norm.shape[-1]):
        plt.plot(norm[:, m], label=f"mode {m}")
    plt.xlabel("epoch")
    plt.ylabel("relative power")
    plt.legend()


def plot_position_error(true, *args, indices=None):
    """Plot the error between true and estimated positions per position."""
    true, args = _host(true), [_host(a) for a in args]
    import matplotlib.pyplot as plt

    for k, estimate in enumerate(args):
        error = np.linalg.norm(np.asarray(estimate) - np.asarray(true),
                               axis=-1)
        if indices is not None:
            error = error[indices]
        plt.plot(error, label=f"estimate {k}")
    plt.xlabel("position index")
    plt.ylabel("|error| [px]")
    plt.legend()


def _confidence_ellipse(x, y, ax, n_std=3.0, **kwargs):
    """Draw the n-sigma covariance confidence ellipse of (x, y) onto ax.

    Derived from the eigendecomposition of the 2x2 covariance: the
    ellipse's semi-axes are n_std * sqrt(eigenvalue) along the
    eigenvectors. Returns the patch, or None for a degenerate cloud.
    """
    from matplotlib.patches import Ellipse

    x = np.asarray(x).ravel()
    y = np.asarray(y).ravel()
    if x.size != y.size:
        raise ValueError("x and y must be the same size")
    if x.size < 2:
        return None
    cov = np.cov(x, y)
    if np.all(np.abs(cov) < 1e-6):
        return None
    evals, evecs = np.linalg.eigh(cov)
    evals = np.maximum(evals, 0.0)
    # eigh returns ascending order; major axis last.
    angle = np.degrees(np.arctan2(evecs[1, 1], evecs[0, 1]))
    kwargs.setdefault("facecolor", "none")
    ellipse = Ellipse(
        (np.mean(x), np.mean(y)),
        width=2 * n_std * np.sqrt(evals[1]),
        height=2 * n_std * np.sqrt(evals[0]),
        angle=angle,
        **kwargs,
    )
    return ax.add_patch(ellipse)


def plot_positions(true, *args):
    """Scatter true vs estimated scan positions.

    Each estimate's cloud gets a 3-sigma covariance confidence ellipse
    overlay.
    """
    true, args = _host(true), [_host(a) for a in args]
    import matplotlib.pyplot as plt

    true = np.asarray(true)
    plt.scatter(true[:, 1], true[:, 0], s=4, label="true", marker="o")
    for k, estimate in enumerate(args):
        e = np.asarray(estimate)
        sc = plt.scatter(
            e[:, 1], e[:, 0], s=4, label=f"estimate {k}", marker="x"
        )
        _confidence_ellipse(
            e[:, 1], e[:, 0], plt.gca(),
            edgecolor=sc.get_facecolor()[0], linestyle="--",
        )
    plt.gca().invert_yaxis()
    plt.axis("equal")
    plt.legend()


def plot_positions_convergence(true, *args):
    """Histogram of position errors for a sequence of estimates."""
    true, args = _host(true), [_host(a) for a in args]
    import matplotlib.pyplot as plt

    for k, estimate in enumerate(args):
        error = np.linalg.norm(np.asarray(estimate) - np.asarray(true),
                               axis=-1)
        plt.hist(error, bins=32, alpha=0.5, label=f"estimate {k}")
    plt.xlabel("|error| [px]")
    plt.ylabel("count")
    plt.legend()


def plot_complex(Z, rmin=None, rmax=None, imin=None, imax=None):
    """Plot real and imaginary parts of a 2D complex array side by side."""
    Z = _host(Z)
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2)
    im0 = axes[0].imshow(Z.real, vmin=rmin, vmax=rmax)
    axes[0].set_title("real")
    plt.colorbar(im0, ax=axes[0])
    im1 = axes[1].imshow(Z.imag, vmin=imin, vmax=imax)
    axes[1].set_title("imag")
    plt.colorbar(im1, ax=axes[1])
    return fig


def plot_phase(Z, amin=None, amax=None):
    """Plot amplitude and phase of a 2D complex array side by side."""
    Z = _host(Z)
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2)
    im0 = axes[0].imshow(np.abs(Z), vmin=amin, vmax=amax)
    axes[0].set_title("amplitude")
    plt.colorbar(im0, ax=axes[0])
    im1 = axes[1].imshow(np.angle(Z), vmin=-np.pi, vmax=np.pi, cmap="twilight")
    axes[1].set_title("phase")
    plt.colorbar(im1, ax=axes[1])
    return fig


def trajectory(x, y, connect=True, frame=None, pause=True, dt=1e-12):
    """Plot a 2D trajectory, optionally connecting consecutive points."""
    x, y = _host(x, y)
    import matplotlib.pyplot as plt

    if connect:
        plt.plot(x, y, "-o", markersize=2)
    else:
        plt.scatter(x, y, s=4)
    if frame is not None:
        plt.xlim(frame[0]), plt.ylim(frame[1])
    plt.axis("equal")


def plot_footprint(theta, v, h):
    """Scatter the projected beam footprint over (v, h)."""
    theta, v, h = _host(theta, v, h)
    import matplotlib.pyplot as plt

    plt.scatter(h, v, s=2, c=theta, cmap="hsv")
    plt.colorbar(label="theta [rad]")
    plt.xlabel("h"), plt.ylabel("v")
    plt.axis("equal")


def plot_trajectories(theta, v, h, t):
    """Plot each trajectory coordinate against time."""
    theta, v, h, t = _host(theta, v, h, t)
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(3, 1, sharex=True)
    for ax, coord, name in zip(axes, (theta, v, h), ("theta", "v", "h")):
        ax.plot(t, coord)
        ax.set_ylabel(name)
    axes[-1].set_xlabel("time [s]")
    return fig


def plot_cost_convergence(costs, times=None):
    """Semilog plot of cost values per epoch (lists of per-batch costs)."""
    import matplotlib.pyplot as plt

    means = [np.mean(_host(c)) for c in costs]
    x = np.cumsum(times) if times is not None else np.arange(len(means))
    plt.semilogy(x, means, "-o", markersize=2)
    plt.xlabel("time [s]" if times is not None else "epoch")
    plt.ylabel("cost")


def plot_eigen_weights(weights):
    """Plot eigen-probe weights per position for each (eigen, mode) pair."""
    weights = _host(weights)
    import matplotlib.pyplot as plt

    weights = np.asarray(weights)
    n_eigen, n_modes = weights.shape[-2], weights.shape[-1]
    fig, axes = plt.subplots(n_eigen, n_modes, squeeze=False, sharex=True)
    for c in range(n_eigen):
        for m in range(n_modes):
            axes[c][m].plot(weights[:, c, m])
            axes[c][m].set_title(f"eigen {c} mode {m}", fontsize=7)
    return fig


def plot_affine_transform(transform, positions=None):
    """Visualize an AffineTransform by its action on a unit square."""
    positions = _host(positions)
    import matplotlib.pyplot as plt

    square = np.array(
        [[0, 0], [0, 1], [1, 1], [1, 0], [0, 0]], dtype=np.float32
    )
    moved = transform(square)
    plt.plot(square[:, 1], square[:, 0], "-k", label="original")
    plt.plot(moved[:, 1], moved[:, 0], "-r", label="transformed")
    if positions is not None:
        plt.scatter(positions[:, 1], positions[:, 0], s=2)
    plt.axis("equal")
    plt.legend()


def coverage_histogram(
    theta, v, h, dwell=None, bins=(16, 8, 4), probe_grid=None,
    probe_shape=(0, 0),
):
    """Sinogram-space coverage histogram for a (theta, v, h) trajectory.

    Counts (dwell-weighted) samples per (theta, v, h) bin, one ray per
    active cell of ``probe_grid`` offset within ``probe_shape``, normalized
    by the ideal uniform bin count (coverage 1.0 = uniform sampling): the
    histogram half of :func:`plot_sino_coverage`.
    """
    theta, v, h, dwell = _host(theta, v, h, dwell)
    theta = np.asarray(theta) % np.pi
    v = np.asarray(v)
    h = np.asarray(h)
    dwell = np.ones(theta.shape) if dwell is None else np.asarray(dwell)
    probe_grid = np.asarray([[1]] if probe_grid is None else probe_grid)
    gy, gx = probe_grid.shape
    dv, dh = np.meshgrid(
        np.linspace(0, probe_shape[0], gy, endpoint=False)
        + probe_shape[0] / gy / 2,
        np.linspace(0, probe_shape[1], gx, endpoint=False)
        + probe_shape[1] / gx / 2,
        indexing="ij",
    )
    dv, dh, weights = dv.ravel(), dh.ravel(), probe_grid.ravel()
    H = np.zeros(bins)
    for i in range(weights.size):
        if weights[i] > 0:
            sample = np.stack([theta, v + dv[i], h + dh[i]], axis=1)
            dH, _ = np.histogramdd(
                sample,
                bins=bins,
                range=[[0, np.pi], [-0.5, 0.5], [-0.5, 0.5]],
                weights=dwell * weights[i],
            )
            H += dH
    ideal = np.sum(dwell) * np.sum(weights) / np.prod(bins)
    return H / ideal


def plot_sino_coverage(
    theta, v, h, dwell=None, bins=(16, 8, 4), probe_grid=None,
    probe_shape=(0, 0),
):
    """Plot minimum sinogram-space coverage along each axis pair.

    Three panels showing the minimum of the coverage histogram projected
    along theta, v, and h. Returns the histogram.
    """
    import matplotlib.pyplot as plt

    H = coverage_histogram(
        theta, v, h, dwell=dwell, bins=bins, probe_grid=probe_grid,
        probe_shape=probe_shape,
    )
    for panel, (axis, xl, yl) in enumerate(
        [(2, "h", "theta"), (0, "h", "v"), (1, "theta", "v")]
    ):
        ax = plt.subplot(1, 3, panel + 1)
        img = np.min(H, axis=axis)
        plt.imshow(
            img if axis == 2 else img.T,
            vmin=0,
            vmax=2,
            origin="lower",
            cmap=plt.cm.RdBu,
        )
        ax.axis("equal")
        plt.xlabel(xl)
        plt.ylabel(yl)
    return H
