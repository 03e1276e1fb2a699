#!/usr/bin/env python
"""The object axis beyond one card: striped reconstruction of a large psi.

The port's counterpart of ``scripts/striped_demo.py``. The object never
materializes whole on one shard: each shard of the mesh holds only its
row-stripe window (Hs + 2 halo rows), the stripes meet once an epoch (the
probe's weighted mean, the halo cross-fade, the rescale), and the full psi
exists only when ``get_result`` stitches it on the host (the original
tike's multi-GPU psi decomposition).

Run (defaults: a 4096^2 object, 4096 patterns of 32^2, rPIE for 5 epochs,
on ``make_mesh()``: every visible card, one stripe each; with ``--device
cpu``, 8 CPU shards):

    python scripts/torch/striped_demo.py [H] [n_positions] [--device cpu]

``run(mesh=...)`` takes any mesh, such as two stripes on one card
(``make_mesh(devices=["cuda:0"] * 2)``).
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import tike_tpu_torch.ptycho as tp  # noqa: E402
from tike_tpu_torch.parallel import make_mesh  # noqa: E402
from tike_tpu_torch.parallel.striped import plan_stripes  # noqa: E402

P, EPOCHS, NUM_BATCH = 32, 5, 4


def problem(H=4096, NPOS=4096, *, device="cuda"):
    """``(psi_true, probe, scan, data)``: an H x H object tiled from a
    smooth 512^2 phase-and-amplitude pattern, a 32^2 Gaussian probe with a
    0.2 rad phase, NPOS seeded uniform positions and their intensities,
    simulated on ``device`` and returned as numpy."""
    W = H
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:512, 0:512] / 512
    tile = (
        np.exp(1j * 0.5 * np.sin(5 * yy) * np.cos(3 * xx)) * (0.9 + 0.1 * np.cos(7 * xx))
    ).astype(np.complex64)
    reps = -(-H // 512)
    psi_true = np.ascontiguousarray(np.tile(tile, (reps, reps))[:H, :W][None])
    probe = (tp.gaussian(P) * np.exp(1j * 0.2 * tp.gaussian(P)))[None, None, None].astype(
        np.complex64
    )
    scan = np.stack(
        [rng.uniform(2, H - P - 3, NPOS), rng.uniform(2, W - P - 3, NPOS)], -1
    ).astype(np.float32)
    data = tp.simulate(P, probe, scan, psi_true, device=device).astype(np.float32)
    return psi_true, probe, scan, data


def parameters(probe, psi_true, scan, epochs=EPOCHS):
    """rPIE from a 0.5 object: 4 compact batches, probe recovery."""
    return tp.PtychoParameters(
        probe=probe,
        psi=np.full_like(psi_true, 0.5),
        scan=scan,
        algorithm_options=tp.RpieOptions(num_batch=NUM_BATCH, num_iter=epochs,
                                         batch_method="compact"),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
    )


def default_mesh(device):
    """``make_mesh()`` (every visible card) on the card, 8 CPU shards on
    the CPU."""
    return make_mesh() if torch.device(device).type == "cuda" else make_mesh(devices=["cpu"] * 8)


def run(H=4096, NPOS=4096, epochs=EPOCHS, mesh=None, *, device="cuda"):
    """Simulate and reconstruct on ``mesh``'s stripes (seed 0); returns
    ``(record, result)``: the JSON record and the reconstructed parameters.
    ``s_per_epoch`` times the epochs alone, to the cards' last kernel;
    ``setup_s`` is the set-up before them (clustering, the upload, the
    stripe plan, the probe rescale)."""
    mesh = default_mesh(device) if mesh is None else mesh
    W = H
    psi_true, probe, scan, data = problem(H, NPOS, device=device)
    psi_mb = psi_true.nbytes / 2**20
    print(f"simulated {NPOS} patterns over a {H}x{W} object ({psi_mb:.0f} MB psi)", flush=True)
    plan = plan_stripes(scan, (H, W), P, mesh.size)
    window_mb = plan.local_height * W * 8 / 2**20
    print(
        f"mesh={mesh.size} shards; per-shard window {plan.local_height}x{W} = "
        f"{window_mb:.0f} MB (vs {psi_mb:.0f} MB full psi; {psi_mb / window_mb:.1f}x reduction)",
        flush=True,
    )
    cards = {d for d in mesh.flat if d.type == "cuda"}

    def now():
        for card in cards:
            torch.cuda.synchronize(card)
        return time.perf_counter()

    t0 = now()
    with tp.Reconstruction(data, parameters(probe, psi_true, scan, epochs), mesh=mesh,
                           object_sharding="striped", device=device,
                           random_seed=0) as context:
        t1 = now()
        context.iterate(epochs)
        t2 = now()
        result = context.get_result()
    costs = [float(np.mean(c)) for c in result.algorithm_options.costs]
    assert np.all(np.isfinite(costs)) and costs[-1] < costs[0], costs

    # Quality over the well-illuminated interior.
    interior = (slice(None), slice(64, -64), slice(64, -64))
    a = np.asarray(result.psi)[interior]
    b = psi_true[interior]
    corr = np.abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
    record = {
        "config": "striped_object",
        "object": f"{H}x{W}",
        "patterns": NPOS,
        "devices": mesh.size,
        "window_rows": plan.local_height,
        "psi_mb": round(psi_mb, 1),
        "window_mb": round(window_mb, 1),
        "epochs": len(costs),
        "setup_s": round(t1 - t0, 3),
        "s_per_epoch": round((t2 - t1) / len(costs), 4),
        "cost_first_last": [round(costs[0], 5), round(costs[-1], 5)],
        "interior_corr_vs_truth": round(float(corr), 4),
    }
    return record, result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("H", nargs="?", type=int, default=4096)
    parser.add_argument("n_positions", nargs="?", type=int, default=4096)
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    record, _ = run(args.H, args.n_positions, device=args.device)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
