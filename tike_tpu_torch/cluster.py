"""Host-side scan-position partitioning into mini-batches (numpy).

A verbatim copy of :mod:`tike_tpu.cluster`: the batch methods
``compact``, ``wobbly_center``, ``wobbly_center_random_bootstrap`` and
``random_batches``, the stripe clusterings ``stripes_equal_count``,
``by_scan_stripes`` and ``by_scan_grid``, and ``by_scan_stripes_contiguous``
and ``batches_padded``. It is copied rather
than imported because importing ``tike_tpu`` imports jax. The same
``numpy.random.Generator`` state gives the same batches in both packages.
"""

from __future__ import annotations

import inspect
import logging
import typing

import numpy as np
import numpy.typing as npt

logger = logging.getLogger(__name__)


def stripes_equal_count(
    population: npt.ArrayLike,
    num_cluster: int,
    dim: int = 0,
) -> typing.List[np.ndarray]:
    """Divide the population into stripes of equal count along ``dim``."""
    population = np.asarray(population)
    if num_cluster == 1 or num_cluster >= len(population):
        return np.array_split(np.arange(population.shape[0]), num_cluster)
    return np.array_split(np.argsort(population[:, dim]), num_cluster)


def by_scan_stripes(
    scan,
    n: int,
    fly: int = 1,
    axis: int = 0,
) -> typing.List[np.ndarray]:
    """Return n boolean masks splitting the field of view into stripes.

    The original tike's stripe clustering, as :func:`tike_tpu.cluster.by_scan_stripes`:
    ``n`` equal-width stripes of the positions' range along ``axis``, the
    positions of one fly group kept together (the group's first position
    decides its stripe).
    """
    scan = np.asarray(scan)
    if scan.ndim != 2:
        raise ValueError("scan must have two dimensions.")
    if n < 1:
        raise ValueError("The number of stripes must be > 0.")
    nscan = scan.shape[0]
    if (nscan // fly) * fly != nscan:
        raise ValueError(
            "The number of scan positions must be an integer multiple of "
            "the number of fly positions."
        )
    grouped = scan.reshape(nscan // fly, fly, 2)
    edges = np.linspace(
        grouped[..., axis].min(), grouped[..., axis].max(), n + 1, endpoint=True
    )
    edges[0] -= 1
    edges[-1] += 1
    return [
        np.logical_and(
            edges[i] < grouped[:, 0, axis], grouped[:, 0, axis] <= edges[i + 1]
        ).repeat(fly)
        for i in range(n)
    ]


def by_scan_grid(
    scan,
    shape: typing.Tuple[int, int],
    fly: int = 1,
) -> typing.List[np.ndarray]:
    """Split the field of view into a 2-D grid of contiguous regions.

    As :func:`tike_tpu.cluster.by_scan_grid`: the pairwise intersections of
    :func:`by_scan_stripes` along rows (``shape[0]`` stripes) and columns
    (``shape[1]``), in row-major order, as index arrays into ``scan``.
    """
    if len(shape) != 2:
        raise ValueError("The grid shape must have two dimensions.")
    scan = np.asarray(scan)
    vstripes = by_scan_stripes(scan, shape[0], axis=0, fly=fly)
    hstripes = by_scan_stripes(scan, shape[1], axis=1, fly=fly)
    order = np.arange(scan.shape[-2])
    return [order[np.logical_and(v, h)] for v in vstripes for h in hstripes]


def wobbly_center(
    population: npt.ArrayLike,
    num_cluster: int,
) -> typing.List[np.ndarray]:
    """Divide the population into heterogeneous clusters.

    Contrarian clustering (Mishra et al. 2017, arXiv:1709.01423): each cluster
    greedily takes the unassigned point farthest from its centroid so every
    cluster spans the whole field of view. Mirrors `cluster.py:302-...` but
    vectorized with an incremental centroid update instead of recomputing
    means per step.
    """
    population = np.asarray(population, dtype=np.float64)
    if not 0 < num_cluster < 0xFFFF:
        raise ValueError(
            f"The number of clusters must be 0 < {num_cluster} < 65536."
        )
    m = len(population)
    if num_cluster == 1 or num_cluster >= m:
        return np.array_split(np.arange(m), num_cluster)

    # Start with the num_cluster observations closest to the global centroid.
    center_dist = np.linalg.norm(
        population - population.mean(axis=0, keepdims=True), axis=1
    )
    seeds = np.argpartition(center_dist, num_cluster)[:num_cluster]

    unassigned = np.ones(m, dtype=bool)
    unassigned[seeds] = False
    members: typing.List[typing.List[int]] = [[s] for s in seeds]
    sums = population[seeds].copy()  # running per-cluster coordinate sums
    counts = np.ones(num_cluster)

    remaining_idx = np.flatnonzero(unassigned)
    # Round-robin: cluster c takes the remaining point farthest from its mean.
    for step in range(len(remaining_idx)):
        c = step % num_cluster
        rem = np.flatnonzero(unassigned)
        centroid = sums[c] / counts[c]
        far = rem[
            np.argmax(np.linalg.norm(population[rem] - centroid, axis=1))
        ]
        members[c].append(far)
        unassigned[far] = False
        sums[c] += population[far]
        counts[c] += 1
    return [np.sort(np.asarray(c)) for c in members]


def wobbly_center_random_bootstrap(
    population: npt.ArrayLike,
    num_cluster: int,
    boot_fraction: float = 0.95,
    rng: np.random.Generator | None = None,
) -> typing.List[np.ndarray]:
    """Heterogeneous clusters with random bootstrap initialization.

    A fraction of the population is assigned randomly (round-robin over a
    shuffled subset), then the wobbly-center rule distributes the remainder.
    Mirrors the reference variant with the same name.
    """
    population = np.asarray(population, dtype=np.float64)
    if not 0 < num_cluster < 0xFFFF:
        raise ValueError(
            f"The number of clusters must be 0 < {num_cluster} < 65536."
        )
    m = len(population)
    if num_cluster == 1 or num_cluster >= m:
        return np.array_split(np.arange(m), num_cluster)
    rng = np.random.default_rng() if rng is None else rng

    num_bootstrap = int(m * boot_fraction)
    num_bootstrap -= num_bootstrap % num_cluster
    seed = rng.choice(m, size=num_bootstrap, replace=False)

    unassigned = np.ones(m, dtype=bool)
    members: typing.List[typing.List[int]] = [[] for _ in range(num_cluster)]
    for c in range(num_cluster):
        sel = seed[c::num_cluster]
        members[c] = list(sel)
        unassigned[sel] = False
    sums = np.stack([population[mem].sum(axis=0) for mem in members])
    counts = np.asarray([len(mem) for mem in members], dtype=np.float64)

    for step in range(m - num_bootstrap):
        c = step % num_cluster
        rem = np.flatnonzero(unassigned)
        centroid = sums[c] / counts[c]
        far = rem[
            np.argmax(np.linalg.norm(population[rem] - centroid, axis=1))
        ]
        members[c].append(far)
        unassigned[far] = False
        sums[c] += population[far]
        counts[c] += 1
    return [np.sort(np.asarray(c)) for c in members]


def compact(
    population: npt.ArrayLike,
    num_cluster: int,
    max_iter: int = 500,
    rng: np.random.Generator | None = None,
) -> typing.List[np.ndarray]:
    """Divide the population into equally-sized spatially-compact clusters.

    Equal-size k-means: kmeans++ seeding, capacity-constrained greedy
    assignment by distance, then Lloyd iterations with capacity limits.
    """
    population = np.asarray(population, dtype=np.float64)
    if not 0 < num_cluster < 0xFFFF:
        raise ValueError(
            f"The number of clusters must be 0 < {num_cluster} < 65536."
        )
    m = len(population)
    if num_cluster == 1 or num_cluster >= m:
        return np.array_split(np.arange(m), num_cluster)
    rng = np.random.default_rng() if rng is None else rng

    max_size = np.full(num_cluster, m // num_cluster)
    max_size[: m % num_cluster] += 1

    # kmeans++ seeding.
    centers = np.zeros(num_cluster, dtype=int)
    centers[0] = rng.integers(m)
    d2 = np.full(m, np.inf)
    for c in range(1, num_cluster):
        d2 = np.minimum(
            d2, np.linalg.norm(population - population[centers[c - 1]], axis=1) ** 2
        )
        centers[c] = rng.choice(m, p=d2 / d2.sum())
    centroids = population[centers]

    labels = np.full(m, -1, dtype=int)
    for _ in range(max_iter):
        # Capacity-constrained assignment: order all (point, cluster) pairs
        # by distance and greedily fill.
        dist = np.linalg.norm(
            population[:, None, :] - centroids[None, :, :], axis=-1
        )
        new_labels = np.full(m, -1, dtype=int)
        size = np.zeros(num_cluster, dtype=int)
        order = np.argsort(dist, axis=None)
        assigned = 0
        for flat in order:
            i, c = divmod(flat, num_cluster)
            if new_labels[i] == -1 and size[c] < max_size[c]:
                new_labels[i] = c
                size[c] += 1
                assigned += 1
                if assigned == m:
                    break
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
        centroids = np.stack(
            [population[labels == c].mean(axis=0) for c in range(num_cluster)]
        )

    clusters = [np.flatnonzero(labels == c) for c in range(num_cluster)]
    # Sort largest-first like the reference.
    clusters.sort(key=len, reverse=True)
    return clusters


def random_batches(
    population, num_cluster: int, rng: np.random.Generator | None = None
) -> typing.List[np.ndarray]:
    """Split indices into num_cluster equal random batches (O(N)).

    The clustering methods are O(N * num_cluster) or worse per epoch setup;
    at production scale (millions of scan positions, the reference's MPI/
    streaming regime) a plain random partition is the only affordable
    layout, matching the reference's `opt.batch_indicies(use_random=True)`
    (`opt.py:46-54`).
    """
    n = len(population)
    rng = np.random.default_rng() if rng is None else rng
    perm = rng.permutation(n)
    return np.array_split(perm, num_cluster)


BATCH_METHODS = {
    "compact": compact,
    "wobbly_center": wobbly_center,
    "wobbly_center_random_bootstrap": wobbly_center_random_bootstrap,
    "random": random_batches,
}


def by_scan_stripes_contiguous(
    scan: npt.NDArray,
    num_stripes: int,
    batch_method: str,
    num_batch: int,
    rng: np.random.Generator | None = None,
) -> typing.Tuple[
    typing.List[np.ndarray],
    typing.List[typing.List[np.ndarray]],
    typing.List[int],
]:
    """Stripe the scan and batch within stripes.

    Returns ``(order, batches, stripe_start)``: per-stripe index arrays into
    the original scan, per-stripe per-batch indices into the *reordered
    local* arrays, and the minimum row coordinate of each stripe.
    """
    if batch_method not in BATCH_METHODS:
        raise NotImplementedError(
            f"batch_method={batch_method!r} is not a batch method; "
            f"available: {sorted(BATCH_METHODS)}"
        )
    scan = np.asarray(scan)
    stripe_map = stripes_equal_count(scan, num_stripes, dim=0)
    order: typing.List[np.ndarray] = []
    batches: typing.List[typing.List[np.ndarray]] = []
    stripe_start: typing.List[int] = []

    method = BATCH_METHODS[batch_method]
    takes_rng = "rng" in inspect.signature(method).parameters
    for stripe in stripe_map:
        local_scan = scan[stripe]
        stripe_start.append(int(np.floor(local_scan[:, 0].min())))
        if takes_rng and rng is not None:
            local_batches = method(local_scan, num_batch, rng=rng)
        else:
            local_batches = method(local_scan, num_batch)
        contiguous = stripe[np.concatenate(local_batches)]
        order.append(contiguous)
        sizes = [len(b) for b in local_batches]
        breaks = np.cumsum(sizes)[:-1]
        batches.append(np.array_split(np.arange(len(contiguous)), breaks))
    return order, batches, stripe_start


def batches_padded(
    batches: typing.Sequence[np.ndarray],
    multiple_of: int = 1,
) -> typing.Tuple[np.ndarray, np.ndarray]:
    """Pad a list of index batches to one fixed-size index matrix + mask.

    Returns ``(indices (num_batch, L), mask (num_batch, L) float32)`` where L
    is the max batch length rounded up to ``multiple_of``. Padded slots
    repeat the batch's first index and carry mask 0, so they contribute
    nothing.
    """
    L = max(len(b) for b in batches)
    L = -(-L // multiple_of) * multiple_of
    idx = np.zeros((len(batches), L), dtype=np.int32)
    mask = np.zeros((len(batches), L), dtype=np.float32)
    for i, b in enumerate(batches):
        idx[i, : len(b)] = b
        idx[i, len(b):] = b[0] if len(b) else 0
        mask[i, : len(b)] = 1.0
    return idx, mask
