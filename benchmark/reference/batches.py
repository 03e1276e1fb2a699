"""The compact mini-batches of a scan, worked out by the benchmark itself.

tike's ``compact`` batching (Odstrcil et al. 2018, section 2.4): an
equal-size k-means of the positions, seeded by k-means++, each Lloyd step
filling the clusters greedily, nearest pair (position, centre) first, up to
each cluster's share. Written here from that method so that the reference
and the roofline count take no schedule from the program; the check holds
the program's batches to these. The draws are numpy's
``default_rng(seed)``, in the method's order, so a program that batches by
the same method from the same seed gets the same batches.
"""

from __future__ import annotations

import typing

import numpy as np


def _fill(order: np.ndarray, m: int, k: int, capacity: np.ndarray) -> np.ndarray:
    """Greedy capacity-limited assignment: walk the pairs ``order`` (flat
    indices point * k + cluster, nearest first) and give each point the
    first cluster that still has room. Done a stretch at a time: up to the
    pair that fills a cluster, every pair is taken or not by the point's
    state alone."""
    point, cluster = np.divmod(order, k)
    labels = np.full(m, -1, dtype=int)
    size = np.zeros(k, dtype=int)
    start = 0
    while start < len(order) and size.sum() < m:
        p, c = point[start:], cluster[start:]
        open_ = np.flatnonzero((labels[p] < 0) & (size[c] < capacity[c]))
        # Each point's first open pair.
        first = np.full(m, len(p))
        first[p[open_[::-1]]] = open_[::-1]
        taken = np.sort(first[first < len(p)])
        tc = c[taken]
        # How full each taken pair leaves its cluster.
        by = np.argsort(tc, kind="stable")
        rank = np.empty(len(taken), dtype=int)
        counts = np.bincount(tc, minlength=k)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank[by] = np.arange(len(taken)) - np.repeat(starts, counts)
        full = np.flatnonzero(size[tc] + rank + 1 == capacity[tc])
        stop = taken[full[0]] if len(full) else len(p)
        keep = taken[taken <= stop]
        labels[p[keep]] = c[keep]
        size += np.bincount(c[keep], minlength=k)
        start += stop + 1
    return labels


def compact(scan: np.ndarray, num_batch: int, seed: int, max_iter: int = 500) -> typing.List[np.ndarray]:
    """``num_batch`` spatially compact batches of equal size (the first
    ``N % num_batch`` one larger), each the sorted indices of its
    positions into ``scan`` (N, 2)."""
    population = np.asarray(scan, dtype=np.float64)
    m, k = len(population), int(num_batch)
    if k == 1 or k >= m:
        return np.array_split(np.arange(m), k)
    rng = np.random.default_rng(seed)
    capacity = np.full(k, m // k)
    capacity[: m % k] += 1

    centers = np.zeros(k, dtype=int)
    centers[0] = rng.integers(m)
    d2 = np.full(m, np.inf)
    for c in range(1, k):
        d2 = np.minimum(d2, np.linalg.norm(population - population[centers[c - 1]], axis=1) ** 2)
        centers[c] = rng.choice(m, p=d2 / d2.sum())
    centroids = population[centers]

    labels = np.full(m, -1, dtype=int)
    for _ in range(max_iter):
        dist = np.linalg.norm(population[:, None, :] - centroids[None, :, :], axis=-1)
        new = _fill(np.argsort(dist, axis=None), m, k, capacity)
        if np.array_equal(new, labels):
            break
        labels = new
        centroids = np.stack([population[labels == c].mean(axis=0) for c in range(k)])
    clusters = [np.flatnonzero(labels == c) for c in range(k)]
    clusters.sort(key=len, reverse=True)
    return clusters
