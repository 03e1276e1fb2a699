"""Joint ptycho-tomography by ADMM: a 3D object from multi-angle scans.

The port's counterpart of ``examples/admm.py``: simulate ptychographic
scans of a synthetic 3D object at several rotation angles, then alternate
per-angle ptychography (the patch kernels of ``csrc/patch.cu``), a
laminography solve that ties the projections to one volume (the KB kernels
of ``csrc/usfft.cu``), and the dual update, all on the card. Prints the
per-iteration ptycho cost and the volume's correlation with the truth.

Run: python examples/torch/admm.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import tike_tpu_torch.lamino  # noqa: E402
import tike_tpu_torch.ptycho as tp  # noqa: E402
from tike_tpu_torch.admm import reconstruct_joint_admm  # noqa: E402
from tike_tpu_torch.constants import wavelength  # noqa: E402

VOXELSIZE, ENERGY = 1e-6, 10.0


def problem(n=48, P=12, T=16, NPOS=160, *, device="cuda"):
    """``(obj_true, theta, data, parameters)``: a smooth complex n^3 volume,
    T angles over [0, pi), each angle's (NPOS, P, P) intensities simulated
    on ``device`` from its projection's transmission, and each angle's
    rPIE parameters (two compact batches, two epochs, a flat start)."""
    rng = np.random.default_rng(0)
    # A smooth complex 3D object (delta + i*beta refractive contrast).
    g = np.exp(-((np.mgrid[0:n, 0:n, 0:n] - n / 2) ** 2).sum(0) / (n / 4) ** 2)
    obj_true = (1e-4 * g + 1e-5j * g).astype(np.complex64)

    # Its transmission projections at T rotation angles become the psi
    # "measurements" the per-angle ptychography solves for.
    theta = np.linspace(0, np.pi, T, endpoint=False).astype(np.float32)
    proj = tike_tpu_torch.lamino.simulate(obj_true, theta, tilt=np.pi / 2, device=device)
    wav = wavelength(ENERGY)
    psis = np.exp(1j * 2 * np.pi / wav * proj * VOXELSIZE).astype(np.complex64)[:, None]

    probe = (tp.gaussian(P) * np.exp(1j * 0.1 * tp.gaussian(P)))[None, None, None].astype(
        np.complex64
    )
    scan = np.stack(
        [rng.uniform(2, n - P - 3, NPOS), rng.uniform(2, n - P - 3, NPOS)], -1
    ).astype(np.float32)

    data, parameters = [], []
    for t in range(T):
        data.append(tp.simulate(P, probe, scan, psis[t], device=device).astype(np.float32))
        parameters.append(
            tp.PtychoParameters(
                probe=probe.copy(),
                psi=np.ones_like(psis[t]),
                scan=scan.copy(),
                algorithm_options=tp.RpieOptions(num_batch=2, num_iter=2, batch_method="compact"),
                object_options=tp.ObjectOptions(),
                probe_options=tp.ProbeOptions(init_rescale_from_measurements=False),
            )
        )
    return obj_true, theta, data, parameters


def correlation(obj, obj_true) -> float:
    """The volume's correlation with the truth, each less its mean: the DC
    (mean) component of each projection is unobservable from diffraction
    intensities (global-phase gauge)."""
    a, b = obj - obj.mean(), obj_true - obj_true.mean()
    return float(abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def run(n=48, P=12, T=16, NPOS=160, num_iter=10, *, device="cuda"):
    """Simulate and reconstruct; returns ``{"costs", "corr", "obj",
    "result"}``, ``result`` being what ``reconstruct_joint_admm`` gave."""
    obj_true, theta, data, parameters = problem(n, P, T, NPOS, device=device)
    out = reconstruct_joint_admm(
        data,
        parameters,
        theta,
        tilt=np.pi / 2,
        voxelsize=VOXELSIZE,
        energy=ENERGY,
        num_iter=num_iter,
        ptycho_iter=3,
        lamino_iter=4,
        device=device,
    )
    obj = np.asarray(out["obj"])
    return dict(costs=np.asarray(out["costs"], np.float64), corr=correlation(obj, obj_true),
                obj=obj, result=out)


def main(n=48, P=12, T=16, NPOS=160, num_iter=10, *, device="cuda"):
    """Run the example and print its costs and correlation; fails unless
    the costs are finite and fall and the correlation exceeds 0.5."""
    out = run(n, P, T, NPOS, num_iter, device=device)
    costs, corr = out["costs"], out["corr"]
    print("per-iteration mean ptycho cost:", [f"{c:.3e}" for c in costs])
    print(f"volume correlation with truth (DC removed): {corr:.3f}")
    assert np.all(np.isfinite(costs))
    assert costs[-1] < costs[0]
    assert corr > 0.5
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    main(device=parser.parse_args().device)
