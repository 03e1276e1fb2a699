#!/usr/bin/env python
"""Joint ADMM ptycho-tomography quality: the port's counterpart of
``scripts/admm_quality.py``.

Measures the volume correlation with the ground truth of the joint ADMM
pipeline (``tike_tpu_torch.admm``) in the weak-phase, few-angle regime, the
pure-laminography ceiling (cgrad from the TRUE projections, which bounds
what the joint pipeline can reach) for the same geometry, and the naive
two-step pipeline (per-angle rPIE, then laminography) the ADMM must beat.
Everything runs on ``--device`` (the card by default).

Run:

    python scripts/torch/admm_quality.py [n] [T] [iters] [rho] [phantom] [gauge] [--device cpu]

Defaults: n=48, T=16 angles, 12 ADMM iterations, rho=0.5, phantom=blobs,
gauge=target. phantom=cube is the sharp-edged weak-phase cube. Prints one
JSON line with {admm_corr, twostep_corr, ceiling_corr, costs} so runs are
comparable.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import tike_tpu_torch.admm  # noqa: E402
import tike_tpu_torch.lamino  # noqa: E402
import tike_tpu_torch.ptycho as tp  # noqa: E402
from tike_tpu_torch.constants import wavenumber  # noqa: E402
from tike_tpu_torch.ops.lamino import LaminoConfig, lamino_fwd  # noqa: E402
from tike_tpu_torch.precision import as_tensor, to_numpy  # noqa: E402

ENERGY, VOXELSIZE = 10.0, 1e-7


def corr(a, b):
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    na = np.linalg.norm(a)
    nb = np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    return float(np.abs(np.vdot(a, b)) / (na * nb))


def setup_problem(phantom, n=48, T=16, P=16, NPOS=150, *, device="cuda"):
    """The quality problem, the same as ``scripts/admm_quality.py``'s.

    Returns (obj_true, theta, psi_true, data, params, voxelsize, energy).
    Weak-phase 3D phantom: a blobby object (band-limited; corr is a
    meaningful structure metric) or a sharp-edged cube. Max line integral
    ~ n/2 voxels. The projections are ``ops.lamino.lamino_fwd`` on
    ``device`` and the intensities ``ptycho.simulate`` there.
    """
    k = wavenumber(ENERGY)
    rng = np.random.default_rng(0)
    delta = 0.5 / (k * VOXELSIZE * n / 2)
    obj_true = np.zeros((n, n, n), dtype=np.complex64)
    if phantom == "cube":
        s = slice(n // 4, 3 * n // 4)
        obj_true[s, s, s] = delta * (1 + 0.1j)
    else:
        yy, xx, zz = np.mgrid[0:n, 0:n, 0:n] / n - 0.5
        for cy, cx, cz, r, w in [
            (-0.15, 0.1, 0.0, 0.22, 1.0),
            (0.18, -0.12, 0.08, 0.15, 0.7),
            (0.0, 0.15, -0.18, 0.10, 1.3),
        ]:
            blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2 + (zz - cz) ** 2) / r**2) * 4)
            obj_true += (w * delta * (1 + 0.1j) * blob).astype(np.complex64)

    theta = np.linspace(0, np.pi, T, endpoint=False).astype(np.float32)
    cfg = LaminoConfig(n=n, tilt=np.pi / 2, eps=1e-3, upsample=2)
    lines = to_numpy(
        lamino_fwd(cfg, as_tensor(obj_true, torch.complex64, device),
                   as_tensor(theta, torch.float32, device))
    ) * VOXELSIZE
    psi_true = np.exp(1j * k * lines).astype(np.complex64)
    probe = (tp.gaussian(P) * (1 + 0j))[None, None, None].astype(np.complex64)
    scan = np.stack(
        [rng.uniform(2, n - P - 3, NPOS), rng.uniform(2, n - P - 3, NPOS)], -1
    ).astype(np.float32)
    data = [
        tp.simulate(P, probe, scan, psi_true[t][None], device=device).astype(np.float32)
        for t in range(T)
    ]
    params = [
        tp.PtychoParameters(
            probe=probe.copy(),
            psi=np.ones((1, n, n), np.complex64),
            scan=scan.copy(),
            algorithm_options=tp.RpieOptions(num_batch=2, num_iter=2),
            object_options=tp.ObjectOptions(),
            probe_options=None,
        )
        for _ in range(T)
    ]
    return obj_true, theta, psi_true, data, params, VOXELSIZE, ENERGY


def run(n=48, T=16, iters=12, rho=0.5, phantom="blobs", gauge="target", *, device="cuda"):
    """The ceiling, the joint ADMM and the two-step pipeline on one
    problem; returns the JSON record."""
    P = 16
    k = wavenumber(ENERGY)
    (obj_true, theta, psi_true, data, params,
     voxelsize, energy) = setup_problem(phantom, n=n, T=T, P=P, device=device)

    # Ceiling: pure lamino CG from the TRUE phase projections
    # (psi_true = exp(i k voxelsize phi_true), |phase| < pi so exact).
    phi_true = (np.angle(psi_true) / (k * voxelsize)).astype(np.complex64)
    ceil = tike_tpu_torch.lamino.reconstruct(
        data=phi_true, theta=theta, tilt=np.pi / 2,
        algorithm="cgrad", num_iter=32, eps=1e-3, upsample=2, device=device,
    )
    ceiling_corr = corr(ceil["obj"], obj_true)
    scan = params[0].scan
    probe = params[0].probe

    t0 = time.perf_counter()
    result = tike_tpu_torch.admm.reconstruct_joint_admm(
        data, params, theta,
        tilt=np.pi / 2, voxelsize=voxelsize, energy=energy,
        num_iter=iters, rho=rho, ptycho_iter=2, lamino_iter=2,
        gauge=gauge, device=device,
    )
    elapsed = time.perf_counter() - t0
    admm_corr = corr(to_numpy(result["obj"]), obj_true)

    record = {
        "n": n, "T": T, "iters": iters, "rho": rho, "phantom": phantom, "gauge": gauge,
        "admm_corr": round(admm_corr, 4),
        "ceiling_corr": round(ceiling_corr, 4),
        "admm_sec": round(elapsed, 1),
        "costs": [round(float(c), 6) for c in result["costs"]],
    }
    # A standalone-ptycho + lamino two-step (no ADMM coupling): the naive
    # pipeline baseline the ADMM must beat.
    phi_est = []
    for t in range(T):
        p = tp.PtychoParameters(
            probe=np.array(probe, copy=True),
            psi=np.ones((1, n, n), np.complex64),
            scan=np.array(scan, copy=True),
            algorithm_options=tp.RpieOptions(num_batch=2, num_iter=2 * iters),
            object_options=tp.ObjectOptions(),
            probe_options=None,
        )
        p = tp.reconstruct(data[t], p, device=device)
        phi_est.append(np.angle(np.asarray(p.psi)[0]) / (k * voxelsize))
    phi_est = np.asarray(phi_est, dtype=np.complex64)
    two = tike_tpu_torch.lamino.reconstruct(
        data=phi_est, theta=theta, tilt=np.pi / 2,
        algorithm="cgrad", num_iter=32, eps=1e-3, upsample=2, device=device,
    )
    record["twostep_corr"] = round(corr(np.asarray(two["obj"]).real, obj_true.real), 4)
    return record


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n", nargs="?", type=int, default=48)
    parser.add_argument("T", nargs="?", type=int, default=16)
    parser.add_argument("iters", nargs="?", type=int, default=12)
    parser.add_argument("rho", nargs="?", type=float, default=0.5)
    parser.add_argument("phantom", nargs="?", default="blobs", choices=("blobs", "cube"))
    parser.add_argument("gauge", nargs="?", default="target", choices=("target", "median", "none"))
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    record = run(args.n, args.T, args.iters, args.rho, args.phantom, args.gauge,
                 device=args.device)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
