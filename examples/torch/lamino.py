"""Laminography quickstart: simulate and reconstruct a tilted 3D volume.

The port's counterpart of ``examples/lamino.py``: the USFFT forward model
(the Kaiser-Bessel gather and scatter of ``csrc/usfft.cu``), a
conjugate-gradient reconstruction, then the voxel-projection Bucket solver
(``csrc/bucket.cu``), all on the card.

Run: python examples/torch/lamino.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import tike_tpu_torch.lamino  # noqa: E402
import tike_tpu_torch.lamino.bucket as bucket  # noqa: E402

TILT = np.pi / 3


def problem(n=32, ntheta=32, theta_shift=0.0):
    """``(obj, theta)``: a complex64 cube within a cube filling the middle
    half of an ``n``^3 volume, and ``ntheta`` angles over [0, 2 pi) moved
    by ``theta_shift`` rad."""
    a, b = n // 4, 3 * n // 4
    c, d = 3 * n // 8, 5 * n // 8
    obj = np.zeros((n, n, n), dtype=np.complex64)
    obj[a:b, a:b, a:b] = 1.0 + 0.5j
    obj[c:d, c:d, c:d] = 0.2 - 0.1j
    theta = (np.linspace(0, 2 * np.pi, ntheta, endpoint=False) + theta_shift).astype(np.float32)
    return obj, theta


def main(n=32, ntheta=32, num_iter=8, cg_iter=4, bucket_iter=4, *, theta_shift=0.0,
         device="cuda"):
    """Run the example; returns ``{"data", "obj", "cost", "error",
    "bucket_data", "bucket_obj", "bucket_cost"}`` (numpy)."""
    obj, theta = problem(n, ntheta, theta_shift)

    data = tike_tpu_torch.lamino.simulate(obj, theta, TILT, eps=1e-6, upsample=2, device=device)
    print("projections:", data.shape, data.dtype)

    result = tike_tpu_torch.lamino.reconstruct(
        data,
        theta,
        TILT,
        algorithm="cgrad",
        num_iter=num_iter,
        rtol=1e-3,
        eps=1e-6,
        upsample=2,
        cg_iter=cg_iter,
        device=device,
    )
    costs = np.asarray(result["cost"], np.float64)
    err = float(np.linalg.norm(result["obj"] - obj) / np.linalg.norm(obj))
    print("cost series:", " ".join(f"{c:1.3e}" for c in costs))
    print(f"relative reconstruction error: {err:.3f}")

    # The Bucket (voxel-projection) solver trades accuracy for memory; it is
    # the model-parallel path for volumes larger than one card (obj_split
    # gives each shard of a mesh an x-slab of the voxels).
    bdata = bucket.simulate(obj, theta, TILT, eps=0.2, device=device)
    bresult = bucket.reconstruct(
        bdata, theta, TILT, algorithm="bucket", num_iter=bucket_iter, eps=0.2, cg_iter=cg_iter,
        device=device,
    )
    bcosts = np.asarray(bresult["cost"], np.float64)
    print("bucket cost series:", " ".join(f"{c:1.3e}" for c in bcosts))
    return dict(data=data, obj=result["obj"], cost=costs, error=err, bucket_data=bdata,
                bucket_obj=bresult["obj"], bucket_cost=bcosts)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    main(device=parser.parse_args().device)
