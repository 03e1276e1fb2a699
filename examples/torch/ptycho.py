"""Ptychography quickstart: reconstruct the measured siemens-star scan.

The port's counterpart of ``examples/ptycho.py``: load the bundled measured
dataset (516 patterns of 128^2), add Hermite probe modes, reconstruct with
rPIE, then refine with LSQML (eigen probes and position correction), all
on the card (the patch kernels of ``csrc/patch.cu``), and plot through
``tike_tpu_torch.view`` when matplotlib is available.

Run: python examples/torch/ptycho.py [--device cpu] [--figure PATH]
"""

import argparse
import bz2
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import tike_tpu_torch.ptycho as tp  # noqa: E402

DATA = os.path.join(ROOT, "tests", "data", "siemens-star-small.npz.bz2")
FIGURE = "ptycho_example_torch.png"
NMODES, NUM_BATCH = 5, 5
# The seed of the batch clustering, the batch orders, the eigen probes'
# random start and the affine position fit (tike_tpu leaves the last two
# unseeded), so that two runs, on the card and on the CPU, compare.
SEED = 0


def load_dataset(*, device="cuda"):
    """``(data, scan, probe, psi)`` as numpy: the measured patterns, the
    positions moved 20 px in from the origin, NMODES Cartesian-Hermite
    probe modes (power-balanced and orthogonalized on ``device``) and a
    0.5 object covering the scan with a 20 px margin."""
    with bz2.open(DATA, "rb") as f:
        archive = np.load(f)
        scan = archive["scan"][0].astype(np.float32)
        data = archive["data"][0].astype(np.float32)
        probe = archive["probe"][0].astype(np.complex64)
    scan -= np.amin(scan, axis=-2) - 20
    probe = tp.add_modes_cartesian_hermite(probe, NMODES)
    probe = tp.adjust_probe_power(probe, device=device)
    probe, _ = tp.orthogonalize_eig(torch.as_tensor(probe, device=device))
    probe = probe.cpu().numpy()
    w = probe.shape[-1]
    h = int(np.ceil(scan[:, 0].max())) + w + 20
    ww = int(np.ceil(scan[:, 1].max())) + w + 20
    psi = np.full((1, h, ww), 0.5 + 0j, dtype=np.complex64)
    return data, scan, probe, psi


def rpie_stage(data, scan, probe, psi, num_iter=16, *, device="cuda"):
    """Stage 1: rPIE from the given start; returns the result."""
    parameters = tp.PtychoParameters(
        probe=probe,
        psi=psi,
        scan=scan,
        algorithm_options=tp.RpieOptions(num_batch=NUM_BATCH, num_iter=num_iter),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
    )
    return tp.reconstruct(data, parameters, device=device, random_seed=SEED)


def lsqml_stage(data, parameters, num_iter=16, *, device="cuda"):
    """Stage 2: LSQML with two eigen probes (OPR; their random start drawn
    from SEED) and position correction (at most 2 px an epoch),
    stopping early when the cost stalls over 8 epochs; returns the result."""
    eigen_probe, eigen_weights = tp.init_varying_probe(
        parameters.scan, parameters.probe, num_eigen_probes=2,
        probes_with_modes=parameters.probe.shape[-3], rng=np.random.default_rng(SEED),
    )
    parameters.eigen_probe = eigen_probe
    parameters.eigen_weights = eigen_weights
    parameters.position_options = tp.PositionOptions(
        initial_scan=parameters.scan.copy(), update_magnitude_limit=2.0
    )
    parameters.algorithm_options = tp.LstsqOptions(
        num_batch=NUM_BATCH, num_iter=num_iter, convergence_window=8
    )
    return tp.reconstruct(data, parameters, device=device, random_seed=SEED)


def save_figure(parameters, path):
    """The object's phase and the first probe mode, to ``path``; False
    without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    import tike_tpu_torch.view

    fig, ax = plt.subplots(1, 2, figsize=(10, 5))
    ax[0].imshow(np.angle(parameters.psi[0]), cmap="twilight")
    ax[0].set_title("object phase")
    ax[1].imshow(tike_tpu_torch.view.complexHSV_to_RGB(parameters.probe[0, 0, 0]))
    ax[1].set_title("probe mode 0")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def main(rpie_iter=16, lsqml_iter=16, figure=FIGURE, *, device="cuda"):
    """Run both stages; returns ``{"rpie_costs", "lsqml_costs",
    "parameters"}`` (the mean cost of each epoch)."""
    data, scan, probe, psi = load_dataset(device=device)
    parameters = rpie_stage(data, scan, probe, psi, rpie_iter, device=device)
    rpie_costs = [float(np.mean(c)) for c in parameters.algorithm_options.costs]
    parameters = lsqml_stage(data, parameters, lsqml_iter, device=device)
    lsqml_costs = [float(np.mean(c)) for c in parameters.algorithm_options.costs]
    print("rPIE cost series:", " ".join(f"{c:1.3e}" for c in rpie_costs))
    print("LSQML cost series:", " ".join(f"{c:1.3e}" for c in lsqml_costs))
    if figure is not None and save_figure(parameters, figure):
        print(f"wrote {figure}")
    return dict(rpie_costs=rpie_costs, lsqml_costs=lsqml_costs, parameters=parameters)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    parser.add_argument("--figure", default=FIGURE, help=f"figure path (default: {FIGURE})")
    args = parser.parse_args()
    main(figure=args.figure, device=args.device)
