"""Host-side scan-position partitioning into mini-batches (numpy).

A verbatim copy of the parts of :mod:`tike_tpu.cluster` that the LSQML
compact path runs: ``compact``, ``stripes_equal_count``,
``by_scan_stripes_contiguous`` and ``batches_padded``. It is copied rather
than imported because importing ``tike_tpu`` imports jax. The same
``numpy.random.Generator`` state gives the same batches in both packages.

Only the ``"compact"`` batch method is ported; the others (wobbly center,
random) wait for the ports that run them.
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


BATCH_METHODS = {
    "compact": compact,
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
            f"batch_method={batch_method!r} is not ported yet; "
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
