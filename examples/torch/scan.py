"""Scanning-trajectory gallery: every generator in tike_tpu_torch.scan.

The port's counterpart of ``examples/scan.py``: build the 1D waveforms
(sinusoid/triangle/sawtooth/square/staircase), the 2D trajectories
(lissajous/raster/spiral/diagonal/hexagonal/billiard), and report path
lengths and average speeds. The generators are host numpy, as in
``tike_tpu.scan``; ``device`` is still checked, so that the example fails
without a card as the others do. Saves a figure to ``--figure`` when
matplotlib is available; otherwise prints summary statistics only.

Run: python examples/torch/scan.py [--device cpu] [--figure PATH]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import tike_tpu_torch.scan as scan  # noqa: E402
from tike_tpu_torch.precision import checked_device  # noqa: E402

FIGURE = "scan_trajectories_torch.png"


def main(figure=FIGURE, *, device="cuda"):
    """Print the gallery, save the figure to ``figure`` (None: no figure)
    and return ``{"times", "waves", "t2", "trajectories"}``."""
    checked_device(device)
    times = scan.scantimes(t0=0, t1=10, f=24)
    freq, phase = 1 / 2, 2 * np.pi
    waves = {
        "sinusoid": scan.sinusoid(A=1, f=freq, p=phase, t=times),
        "triangle": scan.triangle(A=0.8, f=freq, p=phase, t=times),
        "sawtooth": scan.sawtooth(A=0.6, f=freq, p=phase, t=times),
        "square": scan.square(A=0.4, f=freq, p=phase, t=times),
        "staircase": scan.staircase(A=0.2, f=freq, p=phase, t=times),
        "triangle_fs": scan.triangle_fs(A=0.8, f=freq, p=phase, t=times),
    }

    t2 = scan.scantimes(t0=0, t1=1, f=120)
    trajectories = {
        "lissajous": scan.lissajous(A=1, B=1, fx=1, fy=2, px=0, py=0, t=t2),
        "raster": scan.raster(A=2, B=1 / 2, f=5, x0=-1, y0=-1, t=t2),
        "spiral": scan.spiral(r1=1 / 2, t1=1, v=10, t=t2),
        "diagonal": scan.diagonal(A=1, B=1, fx=1, fy=2, px=0, py=np.pi / 2, t=t2),
        "billiard": scan.billiard(Ax=1, Ay=1, fx=1, fy=2, px=0, py=0, t=t2, N=4),
        "hexagonal": scan.hexagonal(t=t2, D=0.1, f=10, row=8),
    }

    print(f"{len(times)} 1D samples, {len(t2)} 2D samples")
    for name, w in waves.items():
        print(f"  {name:12s} range [{w.min():+.2f}, {w.max():+.2f}]")
    for name, (x, y) in trajectories.items():
        speed = scan.avgspeed(t2[-1] - t2[0], x, y)
        print(f"  {name:12s} path length {scan.distance(x, y):7.2f}  avg speed {speed:6.2f}")
    result = dict(times=times, waves=waves, t2=t2, trajectories=trajectories)
    if figure is None:
        return result
    try:
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt
    except Exception:
        print("matplotlib unavailable; skipping the figure")
        return result
    fig, axes = plt.subplots(2, 1, figsize=(8, 8), dpi=120)
    for name, w in waves.items():
        axes[0].plot(times, w, label=name, lw=0.8)
    axes[0].set_title("1D waveforms")
    axes[0].legend(fontsize=7)
    for name, (x, y) in trajectories.items():
        axes[1].plot(x, y, label=name, lw=0.8)
    axes[1].set_title("2D trajectories")
    axes[1].set_aspect("equal")
    axes[1].legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(figure)
    plt.close(fig)
    print(f"saved {figure}")
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    parser.add_argument("--figure", default=FIGURE, help=f"figure path (default: {FIGURE})")
    args = parser.parse_args()
    main(args.figure, device=args.device)
